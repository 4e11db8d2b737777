"""K2d and K2v — paged decode and speculative-verify attention: the CUDA
kernels (``csrc/paged_decode_attention.cu``; bfloat16 runs K2r's Hopper
body of ``csrc/paged_attention_sm90.cuh`` with a window of T rows a
slot, its scratch kept as K2r's) and their plain PyTorch versions.

Counterparts of ``pallas_paged_attention`` (K2d: one query token per
slot, ``q [S, H, D]``) and ``pallas_paged_verify_attention`` (K2v: a
window of T query tokens per slot, ``q [S, T, H, D]``, linear chain) in
``paddle_tpu/ops/pallas/paged_attention.py``. Both attend each slot's
blocks of the pool ``[NB, BS, H_kv, D]`` through ``block_tables [S, MB]``;
window token ``t`` of slot ``s`` sees the first ``context_lens[s] + t``
positions. A row that sees no position is 0.

The plain versions are the reference's gather fallbacks
(``_xla_paged_attention`` / ``_xla_paged_verify``) op for op: the dense
gather of every slot's blocks, float32 scores times the scale, an
additive ``-1e9`` bias past the bound, softmax, the weights cast to
``q``'s dtype before the P @ V product in that dtype. That recipe is
what makes paged greedy decoding give the dense path's tokens. With
int8 pools (two :class:`~paddle_tpu_torch.ops.paged_cache.QuantKV`) the
recipe is the reference's quantized one: the gather dequantizes to
float32 and everything stays float32 through both products (P is not
rounded); the kernels' launches are then counted as
``paged_decode_attention_int8`` / ``paged_verify_attention_int8``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, launch_counts, no_backward
from ..paged_cache import QuantKV, gather_dense
from .ragged_paged_attention import (SM90_MAX_SLOTS, pool_operands,
                                     sm_count, sm90_scratch,
                                     sm90_scratch_sizes)

__all__ = ["paged_decode_attention", "paged_verify_attention",
           "plain_paged_decode_attention", "plain_paged_verify_attention"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None
MAX_Q = 64                # query vectors (T * rep) one block holds
MAX_T = 16
# float32: the context's split over SMs
SPLIT_POSITIONS = 64      # fewest context positions worth a split
MAX_SPLITS = 16           # the kernel's MAX_SPLITS; it refuses more
BLOCKS_PER_SM = 8


def plain_paged_verify_attention(q, k_pool, v_pool, block_tables,
                                 context_lens, sm_scale=None):
    """``q [S, T, H, D]`` -> ``[S, T, H, D]``; token ``t`` sees
    ``context_lens + t`` positions."""
    s, t, h, d = q.shape
    hkv = k_pool.shape[2]
    rep = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    # int8 pools: float32 through both products (the reference's recipe)
    ad = torch.float32 if isinstance(k_pool, QuantKV) else q.dtype
    k = gather_dense(k_pool, block_tables)          # [S, L, Hkv, D]
    v = gather_dense(v_pool, block_tables)
    q6 = q.reshape(s, t, hkv, rep, d)
    scores = torch.einsum("stgrd,slgd->sgtrl", q6.float(),
                          k.to(ad).float()) * scale
    pos = torch.arange(k.shape[1], device=q.device)
    bound = context_lens.long()[:, None] + torch.arange(t, device=q.device)
    allow = pos[None, None, :] < bound[:, :, None]            # [S, T, L]
    bias = torch.where(allow, 0.0, -1e9)
    w = torch.softmax(scores + bias[:, None, :, None, :], dim=-1).to(ad)
    out = torch.einsum("sgtrl,slgd->stgrd", w, v.to(ad))
    return out.to(q.dtype).reshape(s, t, h, d)


def plain_paged_decode_attention(q, k_pool, v_pool, block_tables,
                                 context_lens, sm_scale=None):
    """``q [S, H, D]`` -> ``[S, H, D]``: the verify recipe at T = 1."""
    return plain_paged_verify_attention(q[:, None], k_pool, v_pool,
                                        block_tables, context_lens,
                                        sm_scale=sm_scale)[:, 0]


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("paged_decode_attention")
        for fn in (lib.ptt_paged_decode_attention,
                   lib.ptt_paged_verify_attention):
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 \
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(q4, k_pool, v_pool, block_tables, context_lens):
    """Raise on what the kernels do not take; ``q4`` is ``[S, T, H, D]``.
    Returns the pool operands (:func:`pool_operands`)."""
    dev = q4.device
    for name, t in (("q", q4), ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q4.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q4.dtype}: the kernel takes float32 or "
                        "bfloat16")
    kd, vd, ks, vs = pool_operands(q4, k_pool, v_pool)
    for name, t in (("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if kd.dim() != 4 or kd.shape != vd.shape:
        raise ValueError(f"pools {tuple(kd.shape)} / "
                         f"{tuple(vd.shape)}: want [NB, BS, Hkv, D]")
    s, t, h, d = q4.shape
    _, bs, hkv, d2 = kd.shape
    if d2 != d or d not in (64, 128):
        raise ValueError(f"head_dim {d} (pool {d2}): the kernel takes 64 "
                         "or 128")
    if bs not in (8, 16, 32):
        raise ValueError(f"block_size {bs}: the kernel takes 8, 16 or 32")
    if not 1 <= t <= MAX_T:
        raise ValueError(f"window of {t} tokens: the kernel takes 1.."
                         f"{MAX_T}")
    if h % hkv or t * (h // hkv) > MAX_Q:
        raise ValueError(f"{h} query heads over {hkv} kv heads at T {t}: "
                         f"need a whole group with T * group <= {MAX_Q}")
    if block_tables.dim() != 2 or block_tables.shape[0] != s \
            or tuple(context_lens.shape) != (s,):
        raise ValueError("block_tables must be [S, MB] and context_lens [S]")
    if q4.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    if q4.dtype == torch.bfloat16 and s > SM90_MAX_SLOTS:
        raise ValueError(f"{s} slots: the bfloat16 kernel takes at most "
                         f"{SM90_MAX_SLOTS}")
    return kd, vd, ks, vs


def _n_split(q4, block_tables, block_size):
    """float32: context splits per (slot, kv head): about BLOCKS_PER_SM
    blocks on each of the card's SMs (a block waits on its loads most of
    the time, so many in flight hide that), each split at least
    SPLIT_POSITIONS of the table's reach, at most MAX_SPLITS."""
    s, hkv = q4.shape[0], q4.shape[2]
    reach = block_tables.shape[1] * block_size
    want = -(-BLOCKS_PER_SM * sm_count(q4.device) // max(1, s * hkv))
    return max(1, min(MAX_SPLITS, reach // SPLIT_POSITIONS, want))


def _launch(entry, counter, q4, k_pool, v_pool, block_tables,
            context_lens, sm_scale):
    """Check and launch; a launch adds one to ``launch_counts[counter]``
    (``counter + "_int8"`` on int8 pools)."""
    kd, vd, ks, vs = _check(q4, k_pool, v_pool, block_tables, context_lens)
    s, t, h, d = q4.shape
    nb, bs, hkv, _ = kd.shape
    mb = block_tables.shape[1]
    out = torch.empty_like(q4)
    if s == 0:
        return out
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    if q4.dtype == torch.bfloat16:
        n_split, floats, counters = sm90_scratch_sizes(
            s, hkv, h // hkv, t, d, sm_count(q4.device))
        part, cnt = sm90_scratch(q4.device, stream, floats, counters)
    else:
        n_split, cnt = _n_split(q4, block_tables, bs), None
        part = torch.empty(n_split * q4.numel() // d * (d + 2),
                           device=q4.device, dtype=torch.float32) \
            if n_split > 1 else None
    ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    rc = getattr(_lib(), entry)(
        q4.data_ptr(), kd.data_ptr(), vd.data_ptr(), ptr(ks), ptr(vs),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        ptr(part), ptr(cnt), s, t, h, hkv, d, bs, mb, nb, n_split,
        float(scale), _DTYPES[q4.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed (cudaError {rc})")
    launch_counts[counter + ("_int8" if ks is not None else "")] += 1
    return out


@no_backward("paged_decode_attention (K2d)")
def paged_decode_attention(q, k_pool, v_pool, block_tables, context_lens,
                           sm_scale=None):
    """K2d: ``q [S, H, D]`` -> ``[S, H, D]``. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return plain_paged_decode_attention(q, k_pool, v_pool, block_tables,
                                            context_lens, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dim() != 3:
        raise ValueError(f"q {tuple(q.shape)}: want [S, H, D]")
    return _launch("ptt_paged_decode_attention", "paged_decode_attention",
                   q[:, None], k_pool, v_pool, block_tables, context_lens,
                   sm_scale)[:, 0]


@no_backward("paged_verify_attention (K2v)")
def paged_verify_attention(q, k_pool, v_pool, block_tables, context_lens,
                           sm_scale=None):
    """K2v: ``q [S, T, H, D]`` -> ``[S, T, H, D]``. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return plain_paged_verify_attention(q, k_pool, v_pool, block_tables,
                                            context_lens, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}: want [S, T, H, D]")
    return _launch("ptt_paged_verify_attention", "paged_verify_attention",
                   q, k_pool, v_pool, block_tables, context_lens, sm_scale)
