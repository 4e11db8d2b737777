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

:class:`Upload` is a device tensor that keeps its address (a graph's
operand), written from the host through pinned staging.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from ..distributed import moe as _moe
from .kernels import hold_scratch, launch_counts

__all__ = ["Upload", "StepGraph", "GraphedStep", "capture",
           "capture_stream", "graphs_usable"]

_STREAMS = {}       # device -> the stream warm-ups and captures run on


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


class StepGraph:
    """One captured step: the graph, the host counts one replay adds,
    the MoE matmul path the capture took and the per-stream scratch its
    kernels write (kept alive with it)."""
    __slots__ = ("graph", "counts", "moe_kernel", "scratch")

    def __init__(self, graph, counts, moe_kernel, scratch):
        self.graph, self.counts = graph, counts
        self.moe_kernel, self.scratch = moe_kernel, scratch

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
    graph = torch.cuda.CUDAGraph()
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
    after = _host_counts()
    delta = {k: after[k] - before[k] for k in after
             if after[k] != before[k]}
    _add_counts({k: -v for k, v in delta.items()})
    return StepGraph(graph, delta, _moe.MOE_STATS["grouped_mm_kernel"],
                     scratch), out


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
