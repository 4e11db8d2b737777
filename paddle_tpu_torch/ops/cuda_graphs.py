"""CUDA graphs of fixed-shape device steps: the serving engine's ticks
and ``generate()``'s paged decode and verify steps.

A step's body runs once eagerly on a capture stream (the warm-up: the
kernels set their attributes and grow their per-stream scratch), then
is captured there with :func:`capture` and replayed on the caller's
stream. A capture records launches without running them, so the host
counters the capture bumped (each kernel's launches, the MoE grouped
matmul calls) are taken back, and each replay adds them again
(:meth:`StepGraph.replay`). The per-stream scratch the captured kernels
write is held by the graph (:func:`~paddle_tpu_torch.ops.kernels.
hold_scratch`). A sampling step registers its generator, so a replay
draws what the eager step draws. A capture that fails raises.

Each capture also takes the census of the graph it recorded
(:func:`graph_census`: its nodes by type, its kernel nodes, the kernels'
names), read through libcuda between the end of the capture and the
graph's instantiation, while PyTorch still holds the ``cudaGraph_t``
(``CUDAGraph(keep_graph=True)``). A PyTorch without that leaves the
census out (``StepGraph.census`` None).

:class:`Upload` is a device tensor that keeps its address (a graph's
operand), written from the host through pinned staging.
"""
from __future__ import annotations

import ctypes
import gc

import numpy as np
import torch

from ..distributed import moe as _moe
from .kernels import hold_scratch, launch_counts

__all__ = ["Upload", "StepGraph", "GraphedStep", "capture",
           "capture_stream", "graphs_usable", "graph_census"]

_STREAMS = {}       # device -> the stream warm-ups and captures run on
_LIBCUDA = None
# CUgraphNodeType, in libcuda's order
_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
               "wait_event", "event_record", "ext_semas_signal",
               "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
               "conditional")


def _host_counts():
    """The host counters a step's launches bump: each kernel's launches
    and the MoE grouped-matmul calls."""
    return dict(launch_counts, moe_calls=_moe.MOE_STATS["grouped_mm_calls"])


def _add_counts(delta):
    for k, v in delta.items():
        if k == "moe_calls":
            _moe.MOE_STATS["grouped_mm_calls"] += v
        else:
            launch_counts[k] += v


def graphs_usable(device, sampling) -> bool:
    """Whether steps on ``device`` can replay graphs: CUDA, and for a
    sampling step a PyTorch whose graphs register a generator (without
    it a replay would draw what the capture drew)."""
    return torch.device(device).type == "cuda" and (
        not sampling
        or hasattr(torch.cuda.CUDAGraph, "register_generator_state"))


def capture_stream(device):
    """The one side stream of ``device`` that warm-ups and captures run
    on (a capture cannot run on the default stream), so the kernels'
    per-stream scratch of every capture lives under one key."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


class Upload:
    """A device tensor that keeps its address (a graph's operand),
    written from the host. On CUDA each write goes through a pinned
    staging copy on the current stream, and the staging is not rewritten
    before that copy has run."""

    def __init__(self, shape, dtype, device):
        self.dev = torch.zeros(shape, dtype=dtype, device=device)
        self.cuda = self.dev.is_cuda
        if self.cuda:
            self.stage = torch.empty(shape, dtype=dtype, pin_memory=True)
            self.event = torch.cuda.Event()

    def write(self, host: np.ndarray):
        if not self.cuda:
            self.dev.copy_(torch.from_numpy(host))
            return
        self.event.synchronize()
        self.stage.numpy()[...] = host
        self.dev.copy_(self.stage, non_blocking=True)
        self.event.record()


def _libcuda():
    global _LIBCUDA
    if _LIBCUDA is None:
        lib = ctypes.CDLL("libcuda.so.1")
        for name in ("cuGraphGetNodes", "cuGraphNodeGetType",
                     "cuGraphKernelNodeGetParams", "cuFuncGetName"):
            if hasattr(lib, name):
                getattr(lib, name).restype = ctypes.c_int
        _LIBCUDA = lib
    return _LIBCUDA


def _ok(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} failed (CUresult {rc})")


def graph_census(graph) -> dict:
    """The nodes of a captured, not yet instantiated ``graph``
    (``CUDAGraph(keep_graph=True)``), read through libcuda:
    ``{"graph_nodes": {type: n}, "kernel_nodes": n, "kernel_names":
    {symbol: n}}``; ``kernel_names`` is left out where libcuda does
    not name functions (``cuFuncGetName``, CUDA 12.3)."""
    lib = _libcuda()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _ok(lib.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _ok(lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    named = hasattr(lib, "cuFuncGetName")
    by_type, names = {}, {}
    params = (ctypes.c_byte * 256)()     # CUDA_KERNEL_NODE_PARAMS: func first
    for node in nodes[:n.value]:
        t = ctypes.c_int()
        _ok(lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)),
            "cuGraphNodeGetType")
        kind = _NODE_TYPES[t.value] if t.value < len(_NODE_TYPES) \
            else f"type{t.value}"
        by_type[kind] = by_type.get(kind, 0) + 1
        if kind != "kernel" or not named:
            continue
        _ok(lib.cuGraphKernelNodeGetParams(ctypes.c_void_p(node), params),
            "cuGraphKernelNodeGetParams")
        func = ctypes.c_void_p.from_buffer(params).value
        sym = ctypes.c_char_p()
        _ok(lib.cuFuncGetName(ctypes.byref(sym), ctypes.c_void_p(func)),
            "cuFuncGetName")
        key = sym.value.decode(errors="replace")
        names[key] = names.get(key, 0) + 1
    out = {"graph_nodes": dict(sorted(by_type.items())),
           "kernel_nodes": by_type.get("kernel", 0)}
    if named:
        out["kernel_names"] = dict(sorted(names.items()))
    return out


class StepGraph:
    """One captured step: the graph, the host counts one replay adds,
    the MoE matmul path the capture took, the per-stream scratch its
    kernels write (kept alive with it) and its node census (None where
    PyTorch cannot keep the graph to read it)."""
    __slots__ = ("graph", "counts", "moe_kernel", "scratch", "census")

    def __init__(self, graph, counts, moe_kernel, scratch, census=None):
        self.graph, self.counts = graph, counts
        self.moe_kernel, self.scratch = moe_kernel, scratch
        self.census = census

    def replay(self):
        self.graph.replay()
        _add_counts(self.counts)
        _moe.MOE_STATS["grouped_mm_kernel"] = self.moe_kernel


def capture(body, stream, pool=None, generator=None):
    """Capture ``body()`` on ``stream``, where its warm-up ran, into
    ``pool`` (None: a pool of the graph's own), registering
    ``generator`` when given. Returns ``(StepGraph, body's outputs)``:
    the outputs are the graph's, rewritten by every replay."""
    before = _host_counts()
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        kept = True
    except TypeError:               # a PyTorch without keep_graph
        graph = torch.cuda.CUDAGraph()
        kept = False
    if generator is not None:
        graph.register_generator_state(generator)
    scratch = []
    # capture_begin / capture_end, not torch.cuda.graph: its entry
    # synchronizes the card and runs the collector, ~0.1 s a capture.
    # The collector stays off while capturing instead: a cycle it frees
    # then (an engine and its graphs) would destroy a graph mid-capture,
    # which invalidates the capture
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        with hold_scratch(scratch), torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            out = body()
            graph.capture_end()
    finally:
        if gc_was_on:
            gc.enable()
    census = None
    if kept:
        census = graph_census(graph)
        graph.instantiate()
    after = _host_counts()
    delta = {k: after[k] - before[k] for k in after
             if after[k] != before[k]}
    _add_counts({k: -v for k, v in delta.items()})
    return StepGraph(graph, delta, _moe.MOE_STATS["grouped_mm_kernel"],
                     scratch, census), out


class GraphedStep:
    """A step of fixed shapes that runs ``body()`` (which reads its
    inputs from tensors that keep their address and returns device
    outputs) once a call. ``graphed`` False: eagerly each call. True:
    the first call eagerly on the capture stream (the warm-up), the
    second captures the body and replays it, every later call replays;
    ``generator`` is registered with the graph. Returns the call's
    outputs (a replay's are the graph's)."""

    def __init__(self, body, device, graphed, generator=None):
        self.body, self.device = body, torch.device(device)
        self.graphed, self.generator = bool(graphed), generator
        self.calls = 0
        self.step = self.out = None

    def __call__(self):
        self.calls += 1
        if not self.graphed:
            return self.body()
        cur = torch.cuda.current_stream(self.device)
        if self.step is None:
            cs = capture_stream(self.device)
            cs.wait_stream(cur)
            if self.calls == 1:
                with torch.cuda.stream(cs):
                    out = self.body()
                cur.wait_stream(cs)
                return out
            self.step, self.out = capture(self.body, cs,
                                          generator=self.generator)
            cur.wait_stream(cs)
        self.step.replay()
        return self.out
