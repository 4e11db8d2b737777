"""Per-step cost accounting of the port: the counterpart of the parts of
``paddle_tpu/monitor/accounting.py`` the serving engine uses.

The reference reads XLA's cost model and its optimized HLO off each
compiled executable. The port's executables are captured CUDA graphs
(one a tick layout), so the same two halves are counted here from the
step itself:

- :class:`CostRecorder` watches one eager run of a step (the warm-up a
  layout runs before its capture, or an eager CPU tick): every aten op
  through a ``TorchDispatchMode`` — FLOPs by ``torch.utils.flop_counter``'s
  formulas, bytes as the sizes of the op's operands and results (a
  gather reads what it gathers, a scatter writes what it scatters; views
  and allocations move nothing) — and every hand-written kernel through
  the work its wrapper declares (:func:`declares`: the figures of the
  bound column in ``PERF.md``), with the aten ops inside the wrapper left
  out. Data-dependent work (attended positions, expert groups touched)
  is summed on the device and read once, by :meth:`CostRecorder.result`,
  after the step.
- :func:`kernel_census` joins that record with the node census of the
  step's captured graph (``ops/cuda_graphs.graph_census``).
- :func:`executable_cost` is the record's FLOPs and bytes: the static
  half of the engine's per-tick roofline.

:func:`device_peak_flops` / :func:`device_peak_hbm_bw` give the card's
peaks from a table of spec sheets (a CUDA card missing from it raises,
naming the card), and nominal 1 TFLOP/s and 100 GB/s on the CPU, which
the engine flags ``cpu_proxy``. :func:`sample_device_memory` reads the
caching allocator's watermarks into gauges.

Still to come with later slices: ``collective_census`` (tensor-parallel
serving) and ``record_compiled_step`` / ``step_report(s)`` /
``analytic_mfu`` (the training step's telemetry).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from .registry import get_registry

__all__ = ["CostRecorder", "declares", "kernel_census", "executable_cost",
           "device_peak_flops", "device_peak_hbm_bw",
           "sample_device_memory", "PEAKS"]

# spec-sheet peaks (dense bf16 FLOP/s, HBM bytes/s) by device name: the
# roofline's ceilings. NVIDIA H100 80GB HBM3 is the SXM5 board at 700 W
# (989.4 TFLOP/s dense bf16, 3.35 TB/s HBM3); a card running under a
# lower power limit reaches less than its row.
PEAKS: Dict[str, tuple] = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12),
}
_CPU_PEAKS = (1e12, 1e11)       # nominal: keeps the ratios defined

_ACTIVE = []                    # the recorders watching a step


def _peaks(device=None):
    dev = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type != "cuda":
        return _CPU_PEAKS
    name = torch.cuda.get_device_name(dev)
    if name not in PEAKS:
        raise ValueError(
            f"no spec-sheet peaks for {name!r}: add its row to "
            "paddle_tpu_torch.monitor.accounting.PEAKS")
    return PEAKS[name]


def device_peak_flops(device=None) -> float:
    """Peak dense bf16 FLOP/s of ``device`` (default: the current CUDA
    card, else the CPU): its spec sheet's (:data:`PEAKS`); the CPU's is a
    nominal 1 TFLOP/s, so an MFU stays defined (flagged ``cpu_proxy``).
    Raises for a CUDA card missing from the table."""
    return _peaks(device)[0]


def device_peak_hbm_bw(device=None) -> float:
    """Peak device-memory bytes/s of ``device``, paired with
    :func:`device_peak_flops` (their ratio is the ridge point in
    FLOPs/byte); nominal 100 GB/s on the CPU."""
    return _peaks(device)[1]


# -- the step recorder ---------------------------------------------------

# ops that launch nothing: allocations and metadata
_NO_KERNEL = {"empty", "empty_strided", "empty_like", "new_empty",
              "new_empty_strided", "lift_fresh", "detach", "set_",
              "resize_", "sym_size", "sym_numel", "sym_stride",
              "sym_storage_offset", "is_same_size"}
# ops that write their first operand without reading it
_WRITES = {"copy_", "fill_", "zero_"}
# a gather reads only what it gathers
_GATHERS = {"embedding", "index_select", "gather", "index", "take",
            "take_along_dim"}
# an in-place scatter writes only what it scatters
_SCATTERS = {"index_put_", "_index_put_impl_", "index_copy_", "scatter_",
             "scatter_add_", "index_add_", "scatter_reduce_"}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _aten_bytes(func, args, kwargs, out) -> int:
    name = func._overloadpacket.__name__
    if name in _GATHERS:
        idx = sum(_nbytes(t) for t in _tensors(args[1:])
                  if not t.is_floating_point())
        return 2 * _nbytes(out) + idx
    if name in _SCATTERS:
        rest = list(args[1:]) + list(kwargs.values())
        src = sum(_nbytes(t) for t in _tensors(rest)
                  if t.is_floating_point())
        idx = sum(_nbytes(t) for t in _tensors(rest)
                  if not t.is_floating_point())
        return 2 * src + idx
    if name in _WRITES:
        return _nbytes(list(args[1:]) + list(kwargs.values())) \
            + _nbytes(out)
    return _nbytes(list(args) + list(kwargs.values())) + _nbytes(out)


class CostRecorder:
    """Counts the work of one eager run of a step (module docstring).
    Use as a context manager around the run, then read :meth:`result`
    (which may read back data-dependent terms once)."""

    def __init__(self):
        self.flops = 0.0
        self.nbytes = 0.0
        self.lazy = []              # device scalars: (flops, bytes) terms
        self.aten_ops: Dict[str, int] = {}
        self.kernels: Dict[str, int] = {}
        self._paused = 0
        self._mode = None

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        rec = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                name = str(func._overloadpacket.__name__)
                if rec._paused or name in _NO_KERNEL \
                        or getattr(func, "is_view", False):
                    return out
                rec.aten_ops[name] = rec.aten_ops.get(name, 0) + 1
                f = flop_registry.get(func._overloadpacket)
                if f is not None:
                    rec.flops += float(f(*args, **kwargs, out_val=out))
                rec.nbytes += float(_aten_bytes(func, args, kwargs, out))
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        self._mode.__exit__(*exc)
        return False

    def kernel(self, work, fn, args, kwargs):
        """One call of a hand-written kernel's wrapper: add the work
        ``work(*args, **kwargs)`` declares (``(name, flops, bytes)``,
        either figure a number or a device scalar), then run the wrapper
        with the aten counting paused (its plain version on the CPU, its
        output allocation and launch on CUDA)."""
        self._paused += 1
        try:
            name, flops, nbytes = work(*args, **kwargs)
            for v, attr in ((flops, "flops"), (nbytes, "nbytes")):
                if isinstance(v, torch.Tensor):
                    self.lazy.append((attr, v.detach().double()))
                else:
                    setattr(self, attr, getattr(self, attr) + float(v))
            self.kernels[name] = self.kernels.get(name, 0) + 1
            return fn(*args, **kwargs)
        finally:
            self._paused -= 1

    def result(self) -> dict:
        """``{flops, bytes_accessed, launch_proxy, launch_by_op,
        kernels}``: the step's work, its launches (hand-written kernels
        and aten ops that launch one), by name. Reads the data-dependent
        terms back once."""
        flops, nbytes = self.flops, self.nbytes
        if self.lazy:
            vals = torch.stack([v.reshape(()) for _, v in self.lazy]).cpu()
            for (attr, _), v in zip(self.lazy, vals.tolist()):
                if attr == "flops":
                    flops += v
                else:
                    nbytes += v
            self.lazy = []
        by = dict(self.kernels)
        for k, n in self.aten_ops.items():
            by["aten." + k] = n
        return {"flops": flops, "bytes_accessed": nbytes,
                "launch_proxy": sum(by.values()),
                "launch_by_op": dict(sorted(by.items())),
                "kernels": dict(sorted(self.kernels.items()))}


def declares(work):
    """Decorate a hand-written kernel's wrapper with the work one call
    does: ``work(*args, **kwargs) -> (counter name, flops, bytes)``, the
    figures of its bound (bytes its launch must move, operations it must
    do). Counted only while a :class:`CostRecorder` watches; otherwise
    the wrapper runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            return _ACTIVE[-1].kernel(work, fn, args, kwargs)
        return call
    return wrap


# -- what the engine reports ----------------------------------------------

def kernel_census(record: Optional[dict] = None,
                  graph: Optional[dict] = None) -> dict:
    """Kernel census of one step (the engine's ``kernel_census()`` rows,
    ``stats()['kernels_per_tick']``). Two views, either may be absent:

    - ``graph`` (the step's captured CUDA graph, read by
      ``ops/cuda_graphs.graph_census`` before instantiation):
      ``graph_nodes`` (every node by type), ``kernel_nodes`` (the
      kernels one replay launches: the reference's ``hlo_kernels``) and,
      where libcuda names functions, ``kernel_names``;
    - ``record`` (a :class:`CostRecorder` result of the step's eager
      run): ``launch_proxy`` and ``launch_by_op``, the hand-written
      kernels' calls by counter name plus the aten ops that launch a
      kernel, and ``kernels`` (the hand-written ones alone).
    """
    out = {}
    if graph is not None:
        out.update(graph)
    if record is not None:
        for k in ("launch_proxy", "launch_by_op", "kernels"):
            out[k] = record[k]
    return out


def executable_cost(record: Optional[dict]) -> dict:
    """FLOPs and bytes of one run of a step, from its
    :class:`CostRecorder` result: ``{"flops", "bytes_accessed"}`` (the
    reference's keys), {} without a record."""
    if not record:
        return {}
    return {"flops": float(record["flops"]),
            "bytes_accessed": float(record["bytes_accessed"])}


def sample_device_memory(step: Optional[int] = None, device=None) -> dict:
    """Device-memory watermark gauges from the CUDA caching allocator
    (``device_bytes_in_use``, ``device_peak_bytes_in_use``,
    ``device_bytes_limit``), sampled at step boundaries. Returns the raw
    ``torch.cuda.memory_stats`` dict ({} on the CPU)."""
    dev = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type != "cuda":
        return {}
    stats = dict(torch.cuda.memory_stats(dev))
    reg = get_registry()
    idx = str(dev.index if dev.index is not None
              else torch.cuda.current_device())
    vals = {"device_bytes_in_use": stats.get("allocated_bytes.all.current"),
            "device_peak_bytes_in_use":
                stats.get("allocated_bytes.all.peak"),
            "device_bytes_limit":
                torch.cuda.get_device_properties(dev).total_memory}
    for gname, v in vals.items():
        if v is not None:
            reg.gauge(gname, "device allocator watermark",
                      labels=("device",)).labels(device=idx).set(int(v))
    return stats
