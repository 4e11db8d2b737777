"""K1f / K1dq / K1dkv — flash attention forward and its FA-2 backward:
the CUDA kernels (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``), their plain PyTorch versions and the
``torch.autograd.Function`` that joins them.

Counterpart of ``pallas_flash_attention`` in
``paddle_tpu/ops/pallas/flash_attention_kernel.py``. Tensors keep the
reference's layout: ``q`` ``[B, Lq, H, D]``, ``k``/``v``
``[B, Lk, Hkv, D]`` with ``H % Hkv == 0`` (query head ``h`` reads kv
head ``h // (H / Hkv)``); the row statistics ``lse`` and ``delta`` are
``[B, H, Lq]`` float32. Causal masking is top-left: row ``i`` sees
columns ``j <= i``, as the reference's ``cols <= rows``.

The kernels take bfloat16 (on the tensor cores) or float32 (on the CUDA
cores, so float32 stays exact to the reference), head_dim 64 or 128 and
any lengths (tail tiles are masked). CPU tensors take the plain version;
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from ...monitor.accounting import declares
from . import _build, launch_counts

__all__ = ["FlashAttention", "flash_attention", "flash_attention_fwd",
           "flash_attention_dq", "flash_attention_dkv",
           "plain_flash_attention_fwd", "plain_flash_attention_dq",
           "plain_flash_attention_dkv"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30           # the reference's NEG_INF for a row that sees nothing
_LIBS = {}


# ---------------------------------------------------------------- plain

def _visible(lq, lk, causal, device):
    """``[lq, lk]`` bool of the columns each row sees, or None (all)."""
    if not causal:
        return None
    rows = torch.arange(lq, device=device)[:, None]
    cols = torch.arange(lk, device=device)[None, :]
    return cols <= rows


def _groups(q, k):
    """``(b, g, rep, head slice)`` for each batch row and kv head: the
    plain versions work one kv group at a time, so their ``[rep, Lq,
    Lk]`` float32 scores stay small at long L."""
    b, _, h, _ = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    for bi in range(b):
        for g in range(hkv):
            yield bi, g, rep, slice(g * rep, (g + 1) * rep)


def _scores(q, k, bi, g, hs, scale, vis):
    """``scale * Q K^T`` of one group in float32, masked to NEG_INF."""
    qs = q[bi, :, hs].float().transpose(0, 1)              # [rep, Lq, D]
    s = (qs @ k[bi, :, g].float().t()) * scale             # [rep, Lq, Lk]
    if vis is not None:
        s = s.masked_fill(~vis, NEG_INF)
    return qs, s


def _probs(s, lse, vis):
    """``P = exp(S - lse)``, zero where masked."""
    p = torch.exp(s - lse[..., None])
    return p if vis is None else p.masked_fill(~vis, 0.0)


def _plain_fwd(q, k, v, scale, vis_of):
    """The forward of each kv group, its columns masked by ``vis_of(bi,
    hs)`` (``[Lq, Lk]`` or ``[rep, Lq, Lk]`` bool, or None for all)."""
    b, lq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, lq, device=q.device, dtype=torch.float32)
    for bi, g, _, hs in _groups(q, k):
        vis = vis_of(bi, hs)
        _, s = _scores(q, k, bi, g, hs, scale, vis)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        if vis is not None:
            p = p.masked_fill(~vis, 0.0)
        l = p.sum(-1, keepdim=True)
        safe = torch.where(l == 0, torch.ones_like(l), l)
        pv = p.to(v.dtype).float() @ v[bi, :, g].float()
        o[bi, :, hs] = (pv / safe).to(q.dtype).transpose(0, 1)
        lse[bi, hs] = torch.where(l == 0, torch.full_like(l, NEG_INF),
                                  m + torch.log(safe))[..., 0]
    return o, lse


def _plain_dq(q, k, v, do, lse, delta, scale, vis_of):
    dq = torch.empty_like(q)
    for bi, g, _, hs in _groups(q, k):
        vis = vis_of(bi, hs)
        _, s = _scores(q, k, bi, g, hs, scale, vis)
        p = _probs(s, lse[bi, hs], vis)
        dos = do[bi, :, hs].float().transpose(0, 1)
        dp = dos @ v[bi, :, g].float().t()
        ds = (p * (dp - delta[bi, hs][..., None]) * scale).to(k.dtype)
        dq[bi, :, hs] = (ds.float() @ k[bi, :, g].float()).to(
            q.dtype).transpose(0, 1)
    return dq


def _plain_dkv(q, k, v, do, lse, delta, scale, vis_of):
    lq, lk = q.shape[1], k.shape[1]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for bi, g, rep, hs in _groups(q, k):
        vis = vis_of(bi, hs)
        qs, s = _scores(q, k, bi, g, hs, scale, vis)
        p = _probs(s, lse[bi, hs], vis)
        dos = do[bi, :, hs].float().transpose(0, 1)
        dp = dos @ v[bi, :, g].float().t()
        ds = (p * (dp - delta[bi, hs][..., None]) * scale).to(q.dtype)
        pt = p.to(do.dtype).float().permute(2, 0, 1).reshape(lk, rep * lq)
        dv[bi, :, g] = (pt @ dos.reshape(rep * lq, -1)).to(v.dtype)
        dst = ds.float().permute(2, 0, 1).reshape(lk, rep * lq)
        dk[bi, :, g] = (dst @ qs.reshape(rep * lq, -1)).to(k.dtype)
    return dk, dv


def _causal_vis(q, k, causal):
    vis = _visible(q.shape[1], k.shape[1], causal, q.device)
    return lambda bi, hs: vis


def plain_flash_attention_fwd(q, k, v, scale, causal):
    """The forward's math in float32 torch ops: scores, mask, row max,
    ``P = exp(S - m)`` rounded to V's dtype for the P V product (the
    reference's ``p.astype(v.dtype)``), ``o = P V / l`` and
    ``lse = m + log l``. Returns ``(o, lse)``."""
    return _plain_fwd(q, k, v, scale, _causal_vis(q, k, causal))


def plain_flash_attention_dq(q, k, v, do, lse, delta, scale, causal):
    """``dq = sum_kv dS K`` with ``dS = P * (dO V^T - delta) * scale``
    rounded to K's dtype (the reference's ``ds.astype(k.dtype)``)."""
    return _plain_dq(q, k, v, do, lse, delta, scale,
                     _causal_vis(q, k, causal))


def plain_flash_attention_dkv(q, k, v, do, lse, delta, scale, causal):
    """``dv = sum P^T dO`` and ``dk = sum dS^T Q`` over every query head
    of each kv group, with P rounded to dO's dtype and dS to Q's before
    their products. Returns ``(dk, dv)``."""
    return _plain_dkv(q, k, v, do, lse, delta, scale,
                      _causal_vis(q, k, causal))


# ---------------------------------------------------------------- kernels

def _lib(name):
    lib = _LIBS.get(name)
    if lib is None:
        lib = _build.load(name)
        if name == "flash_attention_fwd":
            fns = [(lib.ptt_flash_attention_fwd, 5)]
        else:
            fns = [(lib.ptt_flash_attention_dq, 7),
                   (lib.ptt_flash_attention_dkv, 8)]
        for fn, n_ptr in fns:
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 \
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _check(q, k, v, do=None, lse=None, delta=None):
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype}: the kernels take float32 or "
                        "bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)} (want [B, L, H, D]), "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (want "
                         "[B, L, Hkv, D], equal)")
    b, _, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head_dim")
    if d not in (64, 128):
        raise ValueError(f"head_dim {d}: the kernels take 64 or 128")
    if h % hkv:
        raise ValueError(f"{h} query heads over {hkv} kv heads: need a "
                         "whole group")
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h}: the grid takes at most "
                         "65535")
    named = [("k", k), ("v", v)]
    if do is not None:
        named += [("do", do), ("lse", lse), ("delta", delta)]
        if do.shape != q.shape or do.dtype != q.dtype:
            raise ValueError("do must match q's shape and dtype")
        for name, t in (("lse", lse), ("delta", delta)):
            if t.dtype != torch.float32 or tuple(t.shape) != (
                    b, h, q.shape[1]):
                raise ValueError(f"{name} must be float32 [B, H, Lq]")
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if name in ("k", "v", "do") and t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} differs from q's "
                            f"{q.dtype}")
    for name, t in [("q", q)] + named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_rc(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed (cudaError {rc})")


def _device_ok(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type == "cuda"


def _pairs(q, k, causal):
    """(query row, key column) pairs a pass visits, over every query
    head: a causal row i sees the columns up to i + Lk - Lq."""
    b, lq, h, _ = q.shape
    lk = k.shape[1]
    if not causal:
        return b * h * lq * lk
    off = lk - lq
    return b * h * sum(max(0, min(lk, i + off + 1)) for i in range(lq)) \
        if off else b * h * lq * (lq + 1) // 2


def _flash_bytes(q, k, stats, writes):
    """q, k and v read, ``stats`` float32 row statistics (lse, delta),
    ``writes`` q-sized (or, for dk / dv, k-sized) outputs."""
    es = q.element_size()
    b, lq, h, _ = q.shape
    return es * (q.numel() + 2 * k.numel()) + 4 * b * h * lq * stats \
        + writes


def _fwd_work(q, k, v, scale, causal):
    return ("flash_attention_fwd", 4 * q.shape[-1] * _pairs(q, k, causal),
            _flash_bytes(q, k, 1, q.numel() * q.element_size()))


def _dq_work(q, k, v, do, lse, delta, scale, causal):
    return ("flash_attention_dq", 6 * q.shape[-1] * _pairs(q, k, causal),
            _flash_bytes(q, k, 2, 2 * q.numel() * q.element_size()))


def _dkv_work(q, k, v, do, lse, delta, scale, causal):
    es = q.element_size()
    return ("flash_attention_dkv", 8 * q.shape[-1] * _pairs(q, k, causal),
            _flash_bytes(q, k, 2, es * (q.numel() + 2 * k.numel())))


@declares(_fwd_work)
def flash_attention_fwd(q, k, v, scale, causal):
    """K1f: ``(o [B, Lq, H, D], lse [B, H, Lq] float32)``."""
    if not _device_ok(q):
        return plain_flash_attention_fwd(q, k, v, scale, causal)
    _check(q, k, v)
    b, lq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, lq, device=q.device, dtype=torch.float32)
    rc = _lib("flash_attention_fwd").ptt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, lq, k.shape[1], h, k.shape[2], d, float(scale),
        int(bool(causal)), _DTYPES[q.dtype], _stream(q))
    _raise_rc(rc, "flash_attention_fwd")
    launch_counts["flash_attention_fwd"] += 1
    return o, lse


@declares(_dq_work)
def flash_attention_dq(q, k, v, do, lse, delta, scale, causal):
    """K1dq: ``dq [B, Lq, H, D]`` in q's dtype."""
    if not _device_ok(q):
        return plain_flash_attention_dq(q, k, v, do, lse, delta, scale,
                                        causal)
    _check(q, k, v, do, lse, delta)
    b, lq, h, d = q.shape
    dq = torch.empty_like(q)
    rc = _lib("flash_attention_bwd").ptt_flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, lq, k.shape[1],
        h, k.shape[2], d, float(scale), int(bool(causal)), _DTYPES[q.dtype],
        _stream(q))
    _raise_rc(rc, "flash_attention_dq")
    launch_counts["flash_attention_dq"] += 1
    return dq


@declares(_dkv_work)
def flash_attention_dkv(q, k, v, do, lse, delta, scale, causal):
    """K1dkv: ``(dk, dv)``, each ``[B, Lk, Hkv, D]`` in k's dtype, the
    sum over every query head of the kv group."""
    if not _device_ok(q):
        return plain_flash_attention_dkv(q, k, v, do, lse, delta, scale,
                                         causal)
    _check(q, k, v, do, lse, delta)
    b, lq, h, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = _lib("flash_attention_bwd").ptt_flash_attention_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
        lq, k.shape[1], h, k.shape[2], d, float(scale), int(bool(causal)),
        _DTYPES[q.dtype], _stream(q))
    _raise_rc(rc, "flash_attention_dkv")
    launch_counts["flash_attention_dkv"] += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """``o = softmax(scale * Q K^T + causal) V`` with the FA-2 backward:
    the forward saves ``(q, k, v, o, lse)``; the backward forms
    ``delta = rowsum(dO * O)`` in float32 (as the reference's ``_bwd``)
    and runs the dq and dk/dv passes."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = flash_attention_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dq = flash_attention_dq(q, k, v, do, lse, delta, ctx.scale,
                                ctx.causal)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, ctx.scale,
                                     ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, scale, causal=False):
    """Differentiable flash attention over ``[B, L, H, D]`` (GQA when k
    and v carry fewer heads)."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), float(scale), bool(causal))
