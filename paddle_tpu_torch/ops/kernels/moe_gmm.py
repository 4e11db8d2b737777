"""K4 — the fused-dispatch grouped matmul of MoE — and K5's megablox
``gmm`` / ``tgmm``: the CUDA kernels (``csrc/moe_gmm.cu``) and their plain
PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/moe_gmm.py`` (``gather_gmm``,
``gather_gmm_swiglu``, ``scatter_gmm``, with ``transpose_rhs``) and of
the megablox ``gmm`` / ``tgmm`` that ``paddle_tpu/distributed/moe.py``
calls on sorted rows (``gather_gmm`` with ``src_rows=None``, and
:func:`tgmm`). ``out[r] = lhs[r] @ rhs[g]`` for the rows ``r`` of group
``g`` in the partition ``group_sizes [e]`` (int32, summing to the row
count ``m``; rows past the sum come out as zeros):

- :func:`gather_gmm` — ``lhs[r] = x[src_rows[r]]`` (or ``x[r]`` when
  ``src_rows`` is None: K5's gmm);
- :func:`gather_gmm_swiglu` — the same gather, and ``rhs = gate_up [e,
  d, 2f]`` with the epilogue ``silu(acc[:, :f]) * acc[:, f:]``;
- :func:`scatter_gmm` — ``out[dst_rows[r]] = x[r] @ rhs[g]``
  (``dst_rows`` a permutation of ``[0, m)``);
- ``transpose_rhs=True`` on :func:`gather_gmm` and :func:`scatter_gmm`:
  ``rhs [e, N, K]`` contracted over its last dim, ``lhs[r] @ rhs[g].T``
  (the backward's d(lhs); without ``src_rows``, K5's d(lhs));
- :func:`tgmm` — ``out[g] = lhs[rows of g].T @ dy[rows of g]``, ``[e,
  K, N]`` with zeros for an empty group (the weight gradient).

The plain versions follow the Pallas body: rows in ``x.dtype``, float32
accumulation, swiglu in float32 and one cast to ``out_dtype`` at the
store. ``tiling`` is accepted and ignored (the kernel picks its own
tiles). In bfloat16 the forward modes run one of two CUDA bodies by the
mean rows a group, ``ceil(m / e)``: the ``mma.sync`` body below
:data:`SM90_MIN_ROWS` (serving widths, bytes-bound) and the persistent
wgmma + TMA body of ``csrc/moe_gmm_sm90.cuh`` from it on (training
widths, operations-bound), where the backward's modes always run. In
float32 a shape rule on the mode, K and N picks one of three CUDA-core
bodies (:func:`f32_body`): the gather or plain gmm at ``N <=``
:data:`F32_SPLIT_K_MAX_N` runs ``moe_gmm_split_k`` (K in 8 slices over a
thread-block cluster: the LoRA delta's A side), the scatter at ``K <=``
:data:`F32_WIDE_MAX_K` runs ``moe_gmm_wide_scatter`` (a 16-row tile by
512 columns a block: its B side), everything else the FMA tile body
``moe_gmm_fma``; each sums a row's products in an order that K and N
fix, so a row's output does not depend on the rows launched with it
(``csrc/moe_gmm_lora.cuh``). CPU tensors take the plain versions; CUDA
tensors launch the kernel or raise. None of these has a backward of its
own: called with gradients enabled on an input that requires them, the
output carries a node whose backward raises (the MoE dispatch
differentiates them through its own autograd Functions).
"""
from __future__ import annotations

import ctypes

import torch

from ...monitor.accounting import declares
from . import _build, launch_counts, no_backward

__all__ = ["gather_gmm", "gather_gmm_swiglu", "scatter_gmm", "tgmm",
           "plain_gather_gmm", "plain_gather_gmm_swiglu",
           "plain_scatter_gmm", "plain_tgmm", "MAX_EXPERTS",
           "SM90_MIN_ROWS", "F32_SPLIT_K_MAX_N", "F32_WIDE_MAX_K",
           "f32_body"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_EXPERTS = 1024        # the kernel's MAX_EXPERTS
# the kernel's SM90_MIN_ROWS: mean rows a group from which the bf16
# forward modes run the Hopper body (ptt_moe_gmm_sm90_min_rows)
SM90_MIN_ROWS = 24
# the float32 bodies' bounds (moe_gmm_lora.cuh's SPLIT_K_MAX_N, WIDE_MAX_K)
F32_SPLIT_K_MAX_N = 64
F32_WIDE_MAX_K = 64
# ptt_moe_gmm_f32_body's codes and modes
F32_BODIES = ("fma", "split_k", "wide_scatter")
F32_MODES = ("gmm", "swiglu", "scatter", "transposed")
_LIB = None


def _group_ends(group_sizes, m):
    """The end row of each group, clamped to ``m`` (a host list: the
    plain versions loop over the groups)."""
    return torch.cumsum(group_sizes.detach().long().clamp(min=0), 0) \
        .clamp(max=m).tolist()


def _plain(x, src_rows, rhs, group_sizes, dst_rows, swiglu, out_dtype,
           transpose_rhs=False):
    m = x.shape[0] if src_rows is None else src_rows.shape[0]
    lhs = x if src_rows is None else x[src_rows.long()]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    acc = torch.zeros(m, n, dtype=torch.float32, device=x.device)
    start = 0
    for g, end in enumerate(_group_ends(group_sizes, m)):
        if end > start:
            w = rhs[g].float()
            acc[start:end] = lhs[start:end].float() @ (
                w.t() if transpose_rhs else w)
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


def plain_gather_gmm(x, src_rows, rhs, group_sizes, out_dtype=None,
                     transpose_rhs=False):
    """``[m, n]``: row ``r`` is ``x[src_rows[r]] @ rhs[group(r)]`` (``@
    rhs[group(r)].T`` with ``transpose_rhs``)."""
    return _plain(x, src_rows, rhs, group_sizes, None, False, out_dtype,
                  transpose_rhs)


def plain_gather_gmm_swiglu(x, src_rows, gate_up, group_sizes,
                            out_dtype=None):
    """``[m, f]``: ``silu(xs @ W_gate) * (xs @ W_up)`` per group."""
    return _plain(x, src_rows, gate_up, group_sizes, None, True, out_dtype)


def plain_scatter_gmm(x, rhs, group_sizes, dst_rows, out_dtype=None,
                      transpose_rhs=False):
    """``[m, n]``: ``out[dst_rows[r]] = x[r] @ rhs[group(r)]`` (``@
    rhs[group(r)].T`` with ``transpose_rhs``)."""
    return _plain(x, None, rhs, group_sizes, dst_rows, False, out_dtype,
                  transpose_rhs)


def plain_tgmm(lhs, dy, group_sizes, num_groups):
    """``[e, K, N]``: ``out[g] = lhs[rows of g].T @ dy[rows of g]`` in
    float32, cast once to ``dy``'s dtype; zeros for an empty group."""
    m, e = lhs.shape[0], int(num_groups)
    acc = torch.zeros(e, lhs.shape[1], dy.shape[1], dtype=torch.float32,
                      device=lhs.device)
    start = 0
    for g, end in enumerate(_group_ends(group_sizes, m)):
        if end > start:
            acc[g] = lhs[start:end].float().t() @ dy[start:end].float()
        start = end
    return acc.to(dy.dtype)


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("moe_gmm")
        for fn in (lib.ptt_moe_gmm, lib.ptt_moe_gather_gmm_swiglu,
                   lib.ptt_moe_scatter_gmm):
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
        lib.ptt_moe_gmm_t.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ptt_moe_tgmm.argtypes = [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ptt_moe_gmm_sm90_min_rows.argtypes = []
        lib.ptt_moe_gmm_f32_body.argtypes = [ctypes.c_int] * 5
        for fn in (lib.ptt_moe_gmm, lib.ptt_moe_gather_gmm_swiglu,
                   lib.ptt_moe_scatter_gmm, lib.ptt_moe_gmm_t,
                   lib.ptt_moe_tgmm, lib.ptt_moe_gmm_sm90_min_rows,
                   lib.ptt_moe_gmm_f32_body):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def f32_body(mode, m, k, n, e):
    """The CUDA body a float32 call of ``mode`` (one of :data:`F32_MODES`)
    at ``m`` rows, reduction ``k``, output width ``n`` (swiglu: ``2f``)
    and ``e`` groups takes, as the library reports it: one of
    :data:`F32_BODIES`. Builds the library; needs no device."""
    code = _lib().ptt_moe_gmm_f32_body(m, k, n, e, F32_MODES.index(mode))
    return F32_BODIES[code]


_COUNTER = {("gmm", False): "moe_gmm", ("swiglu", False):
            "moe_gather_gmm_swiglu", ("scatter", False): "moe_scatter_gmm",
            ("gmm", True): "moe_gmm_t", ("scatter", True):
            "moe_scatter_gmm_t"}


def _check_args(named, x):
    """Device, contiguity and dtypes every entry point shares: float32 or
    bfloat16 operands of one dtype on ``x``'s CUDA device, int32
    indices."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
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
    for name, t in named:
        if t is None:
            continue
        if name in ("group_sizes", "src_rows", "dst_rows"):
            if t.dtype != torch.int32:
                raise TypeError(f"{name} must be int32, got {t.dtype}")
        elif t.dtype != x.dtype:
            raise TypeError(f"{name} dtype {t.dtype} differs from x's "
                            f"{x.dtype}")


def _check_sizes(k, n, e, tensors):
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"{e} experts: the kernel takes 1..{MAX_EXPERTS}")
    if k % 8 or n % 8:
        raise ValueError(f"K {k}, N {n}: the kernel reads 16-byte rows, so "
                         "K and the output width must be multiples of 8")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the operands must be 16-byte aligned")


def _launch(mode, x, src_rows, rhs, group_sizes, dst_rows, out_dtype,
            transpose_rhs=False, count=None):
    """Check what the kernel takes, launch ``mode`` ("gmm", "swiglu" or
    "scatter", plain or with ``rhs [e, N, K]`` transposed) and bump its
    launch count (``count``, or the mode's own)."""
    _check_args([("x", x), ("rhs", rhs), ("group_sizes", group_sizes),
                 ("src_rows", src_rows), ("dst_rows", dst_rows)], x)
    if out_dtype not in (None, x.dtype):
        raise TypeError(f"out_dtype {out_dtype}: the kernel stores in x's "
                        f"dtype {x.dtype}")
    k_axis = 2 if transpose_rhs else 1
    if x.dim() != 2 or rhs.dim() != 3 or rhs.shape[k_axis] != x.shape[1]:
        want = "[e, N, K]" if transpose_rhs else "[e, K, N]"
        raise ValueError(f"x {tuple(x.shape)}, rhs {tuple(rhs.shape)}: want "
                         f"[rows, K] and {want}")
    e = rhs.shape[0]
    k, n = x.shape[1], rhs.shape[3 - k_axis]
    m = x.shape[0] if src_rows is None else src_rows.shape[0]
    if tuple(group_sizes.shape) != (e,):
        raise ValueError(f"group_sizes {tuple(group_sizes.shape)}, want "
                         f"({e},)")
    for name, t in (("src_rows", src_rows), ("dst_rows", dst_rows)):
        if t is not None and tuple(t.shape) != (m,):
            raise ValueError(f"{name} {tuple(t.shape)}, want ({m},)")
    nout = n // 2 if mode == "swiglu" else n
    if mode == "swiglu" and n % 2:
        raise ValueError(f"swiglu: gate_up width {n} is not even")
    _check_sizes(k, nout, e, (x, rhs))
    out = torch.empty(m, nout, device=x.device, dtype=x.dtype)
    if m == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _lib()
    dt = _DTYPES[x.dtype]
    if transpose_rhs:
        rc = lib.ptt_moe_gmm_t(x.data_ptr(), ptr(src_rows), rhs.data_ptr(),
                               group_sizes.data_ptr(), ptr(dst_rows),
                               out.data_ptr(), m, k, n, e, dt, stream)
    elif mode == "scatter":
        rc = lib.ptt_moe_scatter_gmm(x.data_ptr(), rhs.data_ptr(),
                                     group_sizes.data_ptr(),
                                     dst_rows.data_ptr(), out.data_ptr(), m,
                                     k, n, e, dt, stream)
    else:
        fn = lib.ptt_moe_gather_gmm_swiglu if mode == "swiglu" \
            else lib.ptt_moe_gmm
        rc = fn(x.data_ptr(), ptr(src_rows), rhs.data_ptr(),
                group_sizes.data_ptr(), out.data_ptr(), m, k, nout, e, dt,
                stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm kernel ({mode}, transpose_rhs="
                           f"{transpose_rhs}) launch failed (cudaError {rc})")
    launch_counts[count or _COUNTER[mode, bool(transpose_rhs)]] += 1
    return out


def _gmm_bytes(x, m, k, n, group_sizes, rows):
    """A grouped matmul's bytes: the weights of each group with rows
    (counted on the device), the m rows in and out, the row indices and
    group sizes."""
    touched = (group_sizes > 0).sum()
    return x.element_size() * (touched * k * n + m * k + m * n) \
        + 4 * ((m if rows else 0) + group_sizes.shape[0])


def _gather_work(x, src_rows, rhs, group_sizes, *, tiling=None,
                 transpose_rhs=False, out_dtype=None, count=None):
    m = x.shape[0] if src_rows is None else src_rows.shape[0]
    k = x.shape[1]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    name = count or _COUNTER["gmm", bool(transpose_rhs)]
    return name, 2 * m * k * n, _gmm_bytes(x, m, k, n, group_sizes,
                                           src_rows is not None)


def _swiglu_work(x, src_rows, gate_up, group_sizes, *, tiling=None,
                 out_dtype=None):
    m = x.shape[0] if src_rows is None else src_rows.shape[0]
    k, n2 = x.shape[1], gate_up.shape[2]
    nbytes = x.element_size() * (
        (group_sizes > 0).sum() * k * n2 + m * k + m * n2 // 2) \
        + 4 * ((0 if src_rows is None else m) + group_sizes.shape[0])
    return "moe_gather_gmm_swiglu", 2 * m * k * n2, nbytes


def _scatter_work(x, rhs, group_sizes, dst_rows, *, tiling=None,
                  transpose_rhs=False, out_dtype=None, count=None):
    m, k = x.shape
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    name = count or _COUNTER["scatter", bool(transpose_rhs)]
    return name, 2 * m * k * n, _gmm_bytes(x, m, k, n, group_sizes, True)


def _tgmm_work(lhs, dy, group_sizes, num_groups):
    (m, k), n = lhs.shape, dy.shape[1]
    nbytes = lhs.element_size() * (m * k + m * n + int(num_groups) * k * n) \
        + 4 * int(num_groups)
    return "moe_tgmm", 2 * m * k * n, nbytes


@no_backward("moe_gmm (K4 gather / K5 gmm)")
@declares(_gather_work)
def gather_gmm(x, src_rows, rhs, group_sizes, *, tiling=None,
               transpose_rhs=False, out_dtype=None, count=None):
    """Grouped matmul with the gather on read: ``out[r] = x[src_rows[r]]
    @ rhs[group(r)]``; ``src_rows=None`` takes ``x`` as the sorted rows
    (K5's gmm). ``x [s, K]``, ``src_rows [m]`` int32, ``rhs [e, K, N]``
    (``[e, N, K]`` with ``transpose_rhs``), ``group_sizes [e]`` int32 ->
    ``[m, N]``. Counted as ``moe_gmm`` (``moe_gmm_t`` transposed), or as
    ``count`` (the LoRA delta's ``lora_gmm``)."""
    if x.device.type == "cpu":
        return plain_gather_gmm(x, src_rows, rhs, group_sizes,
                                out_dtype=out_dtype,
                                transpose_rhs=transpose_rhs)
    return _launch("gmm", x, src_rows, rhs, group_sizes, None, out_dtype,
                   transpose_rhs, count)


@no_backward("moe_gather_gmm_swiglu (K4)")
@declares(_swiglu_work)
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


@no_backward("moe_scatter_gmm (K4)")
@declares(_scatter_work)
def scatter_gmm(x, rhs, group_sizes, dst_rows, *, tiling=None,
                transpose_rhs=False, out_dtype=None, count=None):
    """Second expert matmul with the combine's unsort as its store:
    ``out[dst_rows[r]] = x[r] @ rhs[group(r)]``, ``x [m, K]`` -> ``[m,
    N]``; ``transpose_rhs`` takes ``rhs [e, N, K]`` (the backward's
    d(x) of the first matmul). Counted as ``moe_scatter_gmm``
    (``moe_scatter_gmm_t`` transposed), or as ``count`` (the LoRA
    delta's ``lora_scatter_gmm``)."""
    if x.device.type == "cpu":
        return plain_scatter_gmm(x, rhs, group_sizes, dst_rows,
                                 out_dtype=out_dtype,
                                 transpose_rhs=transpose_rhs)
    return _launch("scatter", x, None, rhs, group_sizes, dst_rows,
                   out_dtype, transpose_rhs, count)


@no_backward("moe_tgmm (K5 tgmm)")
@declares(_tgmm_work)
def tgmm(lhs, dy, group_sizes, num_groups):
    """The weight gradient of the grouped matmul: ``out[g] = lhs[rows of
    g].T @ dy[rows of g]`` over sorted rows, ``lhs [m, K]``, ``dy [m,
    N]``, ``group_sizes [e]`` int32 -> ``[e, K, N]`` in ``dy``'s dtype
    (float32 accumulation), zeros for an empty group; rows past the
    groups are not read. Counted as ``moe_tgmm``."""
    if int(num_groups) != group_sizes.shape[0]:
        raise ValueError(f"num_groups {num_groups}, group_sizes "
                         f"{tuple(group_sizes.shape)}")
    if lhs.device.type == "cpu":
        return plain_tgmm(lhs, dy, group_sizes, num_groups)
    _check_args([("lhs", lhs), ("dy", dy), ("group_sizes", group_sizes)],
                lhs)
    if lhs.dim() != 2 or dy.dim() != 2 or dy.shape[0] != lhs.shape[0]:
        raise ValueError(f"lhs {tuple(lhs.shape)}, dy {tuple(dy.shape)}: "
                         "want [m, K] and [m, N]")
    (m, k), n, e = lhs.shape, dy.shape[1], int(num_groups)
    _check_sizes(k, n, e, (lhs, dy))
    out = torch.empty(e, k, n, device=lhs.device, dtype=lhs.dtype)
    if m == 0:
        return out.zero_()
    rc = _lib().ptt_moe_tgmm(
        lhs.data_ptr(), dy.data_ptr(), group_sizes.data_ptr(),
        out.data_ptr(), m, k, n, e, _DTYPES[lhs.dtype],
        torch.cuda.current_stream(lhs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_tgmm kernel launch failed (cudaError {rc})")
    launch_counts["moe_tgmm"] += 1
    return out
