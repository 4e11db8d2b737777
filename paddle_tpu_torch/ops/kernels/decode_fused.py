"""K3a / K3b — the fused decode-tick kernels (``csrc/norm_matmul.cu``,
``csrc/matmul_residual.cu``) and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/decode_fused.py``:

- :func:`norm_matmul` — RMSNorm over ``[..., d]`` rows fused into 1..3
  projections ``[d, n_i]`` that share the normalised rows (q/k/v, or the
  MLP's gate/up). The normalised activation never reaches device memory.
- :func:`matmul_residual` — ``residual + act(xs) @ w (+ b)`` with act
  ``None`` (the O-projection) or ``"swiglu"`` (``silu(g) * u`` into the
  down-projection).

The plain versions are op for op the unfused decoder layer (the
reference's ``_xla_*`` recipes), so a CPU model with fusion on is
bitwise the same model with fusion off. CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from ...incubate.nn.functional import swiglu
from ...nn.functional import rms_norm
from . import _build, launch_counts, no_backward

__all__ = ["norm_matmul", "matmul_residual", "plain_norm_matmul",
           "plain_matmul_residual"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {None: 0, "swiglu": 1}
_LIBS = {}
_SMS = {}


def plain_norm_matmul(x, gamma, ws, eps):
    """The unfused recipe: ``rms_norm`` (float32 statistic, cast to the
    activation dtype, then times gamma) followed by each ``y @ w``."""
    y = rms_norm(x, gamma, eps)
    return tuple(y @ w for w in ws)


def plain_matmul_residual(xs, w, b, residual, act=None):
    """The unfused recipe: the activation, the projection, the bias, then
    ``residual + y`` in the decoder layer's order."""
    if act == "swiglu":
        xin = swiglu(xs[0], xs[1])
    elif act is None:
        xin = xs[0]
    else:
        raise NotImplementedError(
            f"act {act!r}: the port takes None or 'swiglu' (gelu_tanh "
            "comes with the GPT slice)")
    y = xin @ w
    if b is not None:
        y = y + b
    return residual + y


def _lib(name):
    lib = _LIBS.get(name)
    if lib is None:
        lib = _build.load(name)
        if name == "norm_matmul":
            fn = lib.ptt_norm_matmul
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        else:
            fn = lib.ptt_matmul_residual
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
                + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _check_same(ref, named):
    for name, t in named:
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, input on "
                             f"{ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name} dtype {t.dtype} differs from the "
                            f"input's {ref.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ref.dtype not in _DTYPES:
        raise TypeError(f"dtype {ref.dtype}: the kernels take float32 or "
                        "bfloat16")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _k_splits(device, dtype, rows, k, widths):
    """K splits of the bfloat16 kernels: enough to give every SM two
    blocks when the (row tiles x 128-column tiles) grid alone would not,
    at most 8 and at least 512 of K per split; float32 never splits."""
    if dtype != torch.bfloat16:
        return 1
    col_tiles = sum(-(-int(n) // 128) for n in widths)
    blocks = -(-rows // _row_tile(rows)) * col_tiles
    want = 2 * _sm_count(device)
    if blocks >= want:
        return 1
    return max(1, min(-(-want // blocks), k // 512, 8))


def _row_tile(rows):
    """Rows of the bfloat16 kernels' block tile (``mma_row_tile`` in
    ``csrc/mma_gemm.cuh``): 16, or 48 / 64, whichever pads less."""
    if rows <= 16:
        return 16
    return 48 if -(-rows // 48) * 48 < -(-rows // 64) * 64 else 64


def _sm_count(device):
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _check_bf16_vectors(dims, tensors):
    """The bfloat16 tensor-core path reads 8 elements (16 bytes) at a
    time: every inner dimension a multiple of 8, every base pointer
    16-byte aligned."""
    if any(int(n) % 8 for n in dims):
        raise ValueError(f"bfloat16 kernels need dims that are multiples "
                         f"of 8, got {tuple(int(n) for n in dims)}")
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError("bfloat16 kernels need 16-byte aligned tensors")


@no_backward("norm_matmul (K3a)")
def norm_matmul(x, gamma, ws, eps):
    """Fused RMSNorm -> 1..3 projections. ``x`` ``[..., d]``, ``gamma``
    ``[d]``, ``ws`` a list of ``[d, n_i]`` weights. Returns a tuple of
    ``[..., n_i]``."""
    if x.device.type == "cpu":
        return plain_norm_matmul(x, gamma, ws, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    ws = list(ws)
    if not 1 <= len(ws) <= 3:
        raise ValueError(f"norm_matmul takes 1..3 weights, got {len(ws)}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    _check_same(x2, [("x", x2), ("gamma", gamma)]
                + [(f"w{i}", w) for i, w in enumerate(ws)])
    if gamma.shape != (d,):
        raise ValueError(f"gamma {tuple(gamma.shape)}, want ({d},)")
    for i, w in enumerate(ws):
        if w.dim() != 2 or w.shape[0] != d:
            raise ValueError(f"w{i} {tuple(w.shape)}, want [{d}, n]")
    r = x2.shape[0]
    outs = [torch.empty(r, w.shape[1], device=x.device, dtype=x.dtype)
            for w in ws]
    if x.dtype == torch.bfloat16:
        _check_bf16_vectors([d] + [w.shape[1] for w in ws],
                            [x2, gamma, *ws])
    if r == 0:
        return tuple(o.reshape(*x.shape[:-1], o.shape[1]) for o in outs)
    ptr = [w.data_ptr() for w in ws] + [None] * (3 - len(ws))
    optr = [o.data_ptr() for o in outs] + [None] * (3 - len(ws))
    ns = [w.shape[1] for w in ws] + [0] * (3 - len(ws))
    splits = _k_splits(x.device, x.dtype, r, d, ns)
    f32 = dict(device=x.device, dtype=torch.float32)
    rstd = torch.empty(r, **f32) if x.dtype == torch.bfloat16 else None
    part = torch.empty(splits * r * sum(ns), **f32) if splits > 1 else None
    rc = _lib("norm_matmul").ptt_norm_matmul(
        x2.data_ptr(), gamma.data_ptr(), *ptr, *optr,
        rstd.data_ptr() if rstd is not None else None,
        part.data_ptr() if part is not None else None, r, d, *ns, len(ws),
        splits, float(eps), _DTYPES[x.dtype], _stream(x))
    if rc != 0:
        raise RuntimeError(f"norm_matmul kernel launch failed "
                           f"(cudaError {rc})")
    launch_counts["norm_matmul"] += 1
    return tuple(o.reshape(*x.shape[:-1], o.shape[1]) for o in outs)


@no_backward("matmul_residual (K3b)")
def matmul_residual(xs, w, b, residual, act=None):
    """Fused ``residual + act(xs) @ w (+ b)``; ``xs`` holds one input
    ``[..., K]`` (act None) or two (act ``"swiglu"``: gate, up)."""
    if act not in _ACTS:
        raise NotImplementedError(
            f"act {act!r}: the port takes None or 'swiglu'")
    xs = list(xs)
    if len(xs) != (2 if act == "swiglu" else 1):
        raise ValueError(f"act {act!r} takes {2 if act else 1} inputs, "
                         f"got {len(xs)}")
    if residual.device.type == "cpu":
        return plain_matmul_residual(xs, w, b, residual, act=act)
    if residual.device.type != "cuda":
        raise ValueError(f"unsupported device {residual.device}")
    k = xs[0].shape[-1]
    n = w.shape[-1]
    x2 = [x.reshape(-1, k) for x in xs]
    res2 = residual.reshape(-1, n)
    _check_same(res2, [(f"x{i}", x) for i, x in enumerate(x2)]
                + [("w", w), ("bias", b), ("residual", res2)])
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"w {tuple(w.shape)}, want [{k}, n]")
    if b is not None and b.shape != (n,):
        raise ValueError(f"bias {tuple(b.shape)}, want ({n},)")
    r = res2.shape[0]
    if any(x.shape[0] != r for x in x2):
        raise ValueError("inputs and residual must have the same rows")
    out = torch.empty_like(res2)
    if res2.dtype == torch.bfloat16:
        _check_bf16_vectors([k, n], [*x2, w, res2])
    if r == 0:
        return out.reshape(residual.shape)
    splits = _k_splits(res2.device, res2.dtype, r, k, [n])
    part = torch.empty(splits * r * n, device=res2.device,
                       dtype=torch.float32) if splits > 1 else None
    rc = _lib("matmul_residual").ptt_matmul_residual(
        x2[0].data_ptr(), x2[1].data_ptr() if act else None, w.data_ptr(),
        b.data_ptr() if b is not None else None, res2.data_ptr(),
        out.data_ptr(), part.data_ptr() if part is not None else None, r, k,
        n, _ACTS[act], splits, _DTYPES[res2.dtype], _stream(res2))
    if rc != 0:
        raise RuntimeError(f"matmul_residual kernel launch failed "
                           f"(cudaError {rc})")
    launch_counts["matmul_residual"] += 1
    return out.reshape(residual.shape)
