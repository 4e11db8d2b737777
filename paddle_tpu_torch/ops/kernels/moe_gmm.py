"""K4 — the fused-dispatch grouped matmul of MoE (forward modes) and K5's
forward ``gmm``: the CUDA kernel (``csrc/moe_gmm.cu``) and its plain
PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/moe_gmm.py`` (``gather_gmm``,
``gather_gmm_swiglu``, ``scatter_gmm``) and of the megablox ``gmm`` that
``paddle_tpu/distributed/moe.py`` calls on sorted rows (``gather_gmm``
with ``src_rows=None``). ``out[r] = lhs[r] @ rhs[g]`` for the rows ``r``
of group ``g`` in the partition ``group_sizes [e]`` (int32, summing to
the row count ``m``; rows past the sum come out as zeros):

- :func:`gather_gmm` — ``lhs[r] = x[src_rows[r]]`` (or ``x[r]`` when
  ``src_rows`` is None: K5's gmm);
- :func:`gather_gmm_swiglu` — the same gather, and ``rhs = gate_up [e,
  d, 2f]`` with the epilogue ``silu(acc[:, :f]) * acc[:, f:]``;
- :func:`scatter_gmm` — ``out[dst_rows[r]] = x[r] @ rhs[g]``
  (``dst_rows`` a permutation of ``[0, m)``).

The plain versions follow the Pallas body: rows in ``x.dtype``, float32
accumulation, swiglu in float32 and one cast to ``out_dtype`` at the
store. ``tiling`` is accepted and ignored (the kernel picks its own
tiles); ``transpose_rhs=True`` is a backward mode and raises. CPU
tensors take the plain versions; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, launch_counts

__all__ = ["gather_gmm", "gather_gmm_swiglu", "scatter_gmm",
           "plain_gather_gmm", "plain_gather_gmm_swiglu",
           "plain_scatter_gmm", "MAX_EXPERTS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_EXPERTS = 1024        # the kernel's MAX_EXPERTS
_LIB = None


def _no_transpose(transpose_rhs):
    if transpose_rhs:
        raise NotImplementedError(
            "transpose_rhs=True is the backward's d(lhs) mode of the grouped "
            "matmul; it comes with the MoE training slice of the PyTorch "
            "port")


def _plain(x, src_rows, rhs, group_sizes, dst_rows, swiglu, out_dtype):
    m = x.shape[0] if src_rows is None else src_rows.shape[0]
    lhs = x if src_rows is None else x[src_rows.long()]
    acc = torch.zeros(m, rhs.shape[2], dtype=torch.float32, device=x.device)
    ends = torch.cumsum(group_sizes.detach().long().clamp(min=0), 0) \
        .clamp(max=m).tolist()
    start = 0
    for g, end in enumerate(ends):
        if end > start:
            acc[start:end] = lhs[start:end].float() @ rhs[g].float()
        start = end
    if swiglu:
        f = rhs.shape[2] // 2
        acc = torch.nn.functional.silu(acc[:, :f]) * acc[:, f:]
    val = acc.to(out_dtype or x.dtype)
    if dst_rows is None:
        return val
    out = torch.empty_like(val)
    out[dst_rows.long()] = val
    return out


def plain_gather_gmm(x, src_rows, rhs, group_sizes, out_dtype=None):
    """``[m, n]``: row ``r`` is ``x[src_rows[r]] @ rhs[group(r)]``."""
    return _plain(x, src_rows, rhs, group_sizes, None, False, out_dtype)


def plain_gather_gmm_swiglu(x, src_rows, gate_up, group_sizes,
                            out_dtype=None):
    """``[m, f]``: ``silu(xs @ W_gate) * (xs @ W_up)`` per group."""
    return _plain(x, src_rows, gate_up, group_sizes, None, True, out_dtype)


def plain_scatter_gmm(x, rhs, group_sizes, dst_rows, out_dtype=None):
    """``[m, n]``: ``out[dst_rows[r]] = x[r] @ rhs[group(r)]``."""
    return _plain(x, None, rhs, group_sizes, dst_rows, False, out_dtype)


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("moe_gmm")
        for fn in (lib.ptt_moe_gmm, lib.ptt_moe_gather_gmm_swiglu,
                   lib.ptt_moe_scatter_gmm):
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _launch(mode, x, src_rows, rhs, group_sizes, dst_rows, out_dtype):
    """Check what the kernel takes, launch ``mode`` ("gmm", "swiglu" or
    "scatter") and bump its launch count."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    named = [("x", x), ("rhs", rhs), ("group_sizes", group_sizes),
             ("src_rows", src_rows), ("dst_rows", dst_rows)]
    for name, t in named:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if rhs.dtype != x.dtype:
        raise TypeError(f"rhs dtype {rhs.dtype} differs from x's {x.dtype}")
    if out_dtype not in (None, x.dtype):
        raise TypeError(f"out_dtype {out_dtype}: the kernel stores in x's "
                        f"dtype {x.dtype}")
    for name, t in named[2:]:
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if x.dim() != 2 or rhs.dim() != 3 or rhs.shape[1] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)}, rhs {tuple(rhs.shape)}: want "
                         "[rows, K] and [e, K, N]")
    e, k, n = rhs.shape
    m = x.shape[0] if src_rows is None else src_rows.shape[0]
    if tuple(group_sizes.shape) != (e,):
        raise ValueError(f"group_sizes {tuple(group_sizes.shape)}, want "
                         f"({e},)")
    for name, t in (("src_rows", src_rows), ("dst_rows", dst_rows)):
        if t is not None and tuple(t.shape) != (m,):
            raise ValueError(f"{name} {tuple(t.shape)}, want ({m},)")
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"{e} experts: the kernel takes 1..{MAX_EXPERTS}")
    nout = n // 2 if mode == "swiglu" else n
    if k % 8 or nout % 8 or (mode == "swiglu" and n % 2):
        raise ValueError(f"K {k}, N {n}: the kernel reads 16-byte rows, so "
                         "K and the output width must be multiples of 8")
    if any(t is not None and t.data_ptr() % 16 for t in (x, rhs)):
        raise ValueError("x and rhs must be 16-byte aligned")
    out = torch.empty(m, nout, device=x.device, dtype=x.dtype)
    if m == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _lib()
    if mode == "scatter":
        rc = lib.ptt_moe_scatter_gmm(x.data_ptr(), rhs.data_ptr(),
                                     group_sizes.data_ptr(),
                                     dst_rows.data_ptr(), out.data_ptr(), m,
                                     k, n, e, _DTYPES[x.dtype], stream)
    else:
        fn = lib.ptt_moe_gather_gmm_swiglu if mode == "swiglu" \
            else lib.ptt_moe_gmm
        rc = fn(x.data_ptr(), ptr(src_rows), rhs.data_ptr(),
                group_sizes.data_ptr(), out.data_ptr(), m, k, nout, e,
                _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm kernel ({mode}) launch failed "
                           f"(cudaError {rc})")
    launch_counts[{"gmm": "moe_gmm", "swiglu": "moe_gather_gmm_swiglu",
                   "scatter": "moe_scatter_gmm"}[mode]] += 1
    return out


def gather_gmm(x, src_rows, rhs, group_sizes, *, tiling=None,
               transpose_rhs=False, out_dtype=None):
    """Grouped matmul with the gather on read: ``out[r] = x[src_rows[r]]
    @ rhs[group(r)]``; ``src_rows=None`` takes ``x`` as the sorted rows
    (K5's gmm). ``x [s, K]``, ``src_rows [m]`` int32, ``rhs [e, K, N]``,
    ``group_sizes [e]`` int32 -> ``[m, N]``. Counted as ``moe_gmm``."""
    _no_transpose(transpose_rhs)
    if x.device.type == "cpu":
        return plain_gather_gmm(x, src_rows, rhs, group_sizes,
                                out_dtype=out_dtype)
    return _launch("gmm", x, src_rows, rhs, group_sizes, None, out_dtype)


def gather_gmm_swiglu(x, src_rows, gate_up, group_sizes, *, tiling=None,
                      out_dtype=None):
    """First expert matmul with the gather on read and swiglu in the
    epilogue: ``gate_up [e, K, 2f]`` -> ``[m, f]``; the sorted rows and
    the ``[m, 2f]`` projection never reach device memory."""
    if x.device.type == "cpu":
        return plain_gather_gmm_swiglu(x, src_rows, gate_up, group_sizes,
                                       out_dtype=out_dtype)
    return _launch("swiglu", x, src_rows, gate_up, group_sizes, None,
                   out_dtype)


def scatter_gmm(x, rhs, group_sizes, dst_rows, *, tiling=None,
                transpose_rhs=False, out_dtype=None):
    """Second expert matmul with the combine's unsort as its store:
    ``out[dst_rows[r]] = x[r] @ rhs[group(r)]``, ``x [m, K]`` -> ``[m,
    N]``."""
    _no_transpose(transpose_rhs)
    if x.device.type == "cpu":
        return plain_scatter_gmm(x, rhs, group_sizes, dst_rows,
                                 out_dtype=out_dtype)
    return _launch("scatter", x, None, rhs, group_sizes, dst_rows,
                   out_dtype)
