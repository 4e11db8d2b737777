"""K6f / K6dq / K6dkv — flash attention forward and its FA-2 backward
under the FlashMask column-interval mask: the CUDA kernels
(``csrc/flashmask_fwd.cu``, ``csrc/flashmask_bwd.cu``), their plain
PyTorch versions and the ``torch.autograd.Function`` that joins them.

Counterpart of ``pallas_flashmask_attention`` in
``paddle_tpu/ops/pallas/flashmask_kernel.py``. Layouts are K1's
(``ops/kernels/flash_attention.py``): ``q`` ``[B, Lq, H, D]``,
``k``/``v`` ``[B, Lk, Hkv, D]``, ``lse`` / ``delta`` ``[B, H, Lq]``
float32. The mask arrives in the compact form: ``start`` and ``end``,
int32 ``[B * Hm, Lk]``; key column ``j`` of mask row ``b * Hm + m``
hides query rows ``[start_j, end_j)`` from every query head ``h`` with
``h // (H / Hm) == m``. ``causal`` adds the top-left triangle (column
``j`` hidden from row ``i < j``). A row that sees no column gets
``o = 0``, ``lse = NEG_INF`` and zero gradients, as the TPU kernel's
guarded exps give.

The kernels take K1's shapes: bfloat16 or float32, head_dim 64 or 128,
any lengths, ``Hkv`` and ``Hm`` dividing ``H``. They skip the 64 x 64
tiles the mask hides wholly, by a summary of the bounds that K6f's
entry computes (``{max start, min end}`` of each 64-column tile,
:func:`plain_flashmask_tiles`) and returns for the backward's two passes;
the plain versions skip nothing, so the skip is checked against them.
CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...monitor.accounting import declares
from . import _build, launch_counts
from .flash_attention import (_DTYPES, _check, _device_ok, _plain_dkv,
                              _plain_dq, _plain_fwd, _raise_rc, _stream)

__all__ = ["FlashMaskAttention", "flashmask_attention_core",
           "flashmask_bounds", "flashmask_fwd", "flashmask_dq",
           "flashmask_dkv", "plain_flashmask_fwd", "plain_flashmask_dq",
           "plain_flashmask_dkv", "plain_flashmask_tiles"]

TILE = 64                 # the kernels' kv tile, summarised per mask row
_LIBS = {}


def flashmask_bounds(startend_row_indices, lq, h, hkv, device=None):
    """``startend_row_indices`` ``[B, Hm, Lk, 1 or 2]`` -> contiguous
    int32 ``(start, end)``, each ``[B * Hm, Lk]``, on ``device`` (default:
    the indices'). With one bound, ``end`` is ``lq``: column ``j`` hides
    rows ``[start_j, lq)``. Raises ``ValueError`` when ``Hkv`` or ``Hm``
    does not divide ``h`` or the last axis is not 1 or 2."""
    idx = startend_row_indices
    if idx.dim() != 4 or idx.shape[-1] not in (1, 2):
        raise ValueError(f"startend_row_indices {tuple(idx.shape)}: want "
                         "[B, Hm, Lk, bounds] with bounds 1 or 2")
    b, hm, lk, n_bounds = idx.shape
    if h % hkv or h % hm:
        raise ValueError(f"head counts must divide: q={h}, kv={hkv}, "
                         f"mask={hm}")
    idx = idx.to(device or idx.device)
    start = idx[..., 0].to(torch.int32).reshape(b * hm, lk).contiguous()
    if n_bounds == 2:
        end = idx[..., 1].to(torch.int32).reshape(b * hm, lk).contiguous()
    else:
        end = torch.full_like(start, lq)
    return start, end


# ---------------------------------------------------------------- plain

def plain_flashmask_tiles(start, end):
    """The kernels' tile summary: ``[B * Hm, ceil(Lk / 64), 2]`` int32,
    ``{max start, min end}`` over the columns of each 64-column tile of
    each mask row (INT_MIN / INT_MAX where a tile has no column)."""
    r, lk = start.shape
    n = -(-lk // TILE)
    lo = start.new_full((r, n * TILE), torch.iinfo(torch.int32).min)
    hi = end.new_full((r, n * TILE), torch.iinfo(torch.int32).max)
    lo[:, :lk], hi[:, :lk] = start, end
    return torch.stack([lo.view(r, n, TILE).amax(-1),
                        hi.view(r, n, TILE).amin(-1)], -1)


def _column_vis(q, k, start, end, causal):
    """``vis_of(bi, hs)`` for K1's plain group loops: the ``[rep, Lq,
    Lk]`` (``[Lq, Lk]`` when the group shares one mask row) columns each
    query head of the group sees, by the TPU kernel's ``_mask_block``."""
    b, lq, h, _ = q.shape
    lk = k.shape[1]
    hm = start.shape[0] // b
    rows = torch.arange(lq, device=q.device)[:, None]
    above = torch.arange(lk, device=q.device)[None, :] > rows

    def row_vis(r):
        hidden = (rows >= start[r][None, :]) & (rows < end[r][None, :])
        return ~(hidden | above) if causal else ~hidden

    def vis_of(bi, hs):
        mrows = [bi * hm + hh // (h // hm)
                 for hh in range(hs.start, hs.stop)]
        if len(set(mrows)) == 1:
            return row_vis(mrows[0])
        per_row = {r: row_vis(r) for r in set(mrows)}
        return torch.stack([per_row[r] for r in mrows])
    return vis_of


def plain_flashmask_fwd(q, k, v, start, end, scale, causal):
    """K1's plain forward (float32 scores, P rounded to V's dtype for
    P V, ``safe_l`` and ``lse = NEG_INF`` where ``l = 0``) under the
    column mask. A masked score is NEG_INF and its P exactly 0, which is
    the reference's guard ``s <= NEG_INF / 2 -> 0``. Returns
    ``(o, lse)``."""
    return _plain_fwd(q, k, v, scale, _column_vis(q, k, start, end, causal))


def plain_flashmask_dq(q, k, v, do, lse, delta, start, end, scale, causal):
    """``dq = sum_kv dS K`` under the column mask (P = 0 where masked,
    dS rounded to K's dtype)."""
    return _plain_dq(q, k, v, do, lse, delta, scale,
                     _column_vis(q, k, start, end, causal))


def plain_flashmask_dkv(q, k, v, do, lse, delta, start, end, scale,
                        causal):
    """``(dk, dv)`` under the column mask: the sum over every query head
    of each kv group, each head masked by its own mask row."""
    return _plain_dkv(q, k, v, do, lse, delta, scale,
                      _column_vis(q, k, start, end, causal))


# ---------------------------------------------------------------- kernels

def _lib(name):
    lib = _LIBS.get(name)
    if lib is None:
        lib = _build.load(name)
        if name == "flashmask_fwd":
            fns = [(lib.ptt_flashmask_fwd, 8)]
        else:
            fns = [(lib.ptt_flashmask_dq, 10), (lib.ptt_flashmask_dkv, 11)]
        for fn, n_ptr in fns:
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 \
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _check_bounds(q, k, start, end, tiles=None):
    """The mask's checks (and those of the tile summary ``tiles`` the
    forward returned, when given); returns the mask head count."""
    b, h, lk = q.shape[0], q.shape[2], k.shape[1]
    for name, t in (("start", start), ("end", end)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} dtype {t.dtype}: want int32")
        if t.dim() != 2 or t.shape[1] != lk or t.shape[0] % b \
                or t.shape != start.shape:
            raise ValueError(f"{name} {tuple(t.shape)}: want int32 "
                             f"[B * Hm, Lk] with Lk = {lk}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    hm = start.shape[0] // b
    if h % hm:
        raise ValueError(f"{hm} mask heads do not divide {h} query heads")
    if tiles is not None:
        want = (start.shape[0], -(-lk // TILE), 2)
        if tiles.dtype != torch.int32 or tuple(tiles.shape) != want \
                or tiles.device != q.device or not tiles.is_contiguous():
            raise ValueError(f"tiles {tuple(tiles.shape)} {tiles.dtype} on "
                             f"{tiles.device}: want the contiguous int32 "
                             f"{want} summary flashmask_fwd returned")
    return hm


def _visible(q, start, end, causal):
    """The (query row, key column) pairs the mask leaves visible, over
    every query head (a device scalar): column j is seen by the rows
    from j (causal) or 0, less the hidden rows [start_j, end_j)."""
    b, lq, h, _ = q.shape
    s, e = start.long(), end.long().clamp(max=lq)
    j = torch.arange(start.shape[1], device=start.device)
    lo = j if causal else torch.zeros_like(j)
    hidden = (e - torch.maximum(s, lo)).clamp(min=0)
    seen = (lq - lo).clamp(min=0) - hidden
    return seen.sum() * (h // (start.shape[0] // b))


def _mask_bytes(q, k, start, end, stats, writes):
    es = q.element_size()
    b, lq, h, _ = q.shape
    return es * (q.numel() + 2 * k.numel()) + 4 * b * h * lq * stats \
        + 4 * (start.numel() + end.numel()) + writes


def _fm_fwd_work(q, k, v, start, end, scale, causal):
    return ("flashmask_fwd",
            4 * q.shape[-1] * _visible(q, start, end, causal),
            _mask_bytes(q, k, start, end, 1, q.numel() * q.element_size()))


def _fm_dq_work(q, k, v, do, lse, delta, start, end, scale, causal, *,
                tiles):
    return ("flashmask_dq",
            6 * q.shape[-1] * _visible(q, start, end, causal),
            _mask_bytes(q, k, start, end, 2,
                        2 * q.numel() * q.element_size()))


def _fm_dkv_work(q, k, v, do, lse, delta, start, end, scale, causal, *,
                 tiles):
    es = q.element_size()
    return ("flashmask_dkv",
            8 * q.shape[-1] * _visible(q, start, end, causal),
            _mask_bytes(q, k, start, end, 2,
                        es * (q.numel() + 2 * k.numel())))


@declares(_fm_fwd_work)
def flashmask_fwd(q, k, v, start, end, scale, causal):
    """K6f: ``(o [B, Lq, H, D], lse [B, H, Lq] float32, tiles)``, where
    ``tiles`` is the bounds' tile summary that K6dq and K6dkv take."""
    if not _device_ok(q):
        return plain_flashmask_fwd(q, k, v, start, end, scale, causal) \
            + (plain_flashmask_tiles(start, end),)
    _check(q, k, v)
    hm = _check_bounds(q, k, start, end)
    b, lq, h, d = q.shape
    tiles = torch.empty(start.shape[0], -(-k.shape[1] // TILE), 2,
                        dtype=torch.int32, device=q.device)
    o = torch.empty_like(q)
    lse = torch.empty(b, h, lq, device=q.device, dtype=torch.float32)
    rc = _lib("flashmask_fwd").ptt_flashmask_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), start.data_ptr(),
        end.data_ptr(), tiles.data_ptr(), o.data_ptr(), lse.data_ptr(), b,
        lq, k.shape[1], h, k.shape[2], hm, d, float(scale),
        int(bool(causal)), _DTYPES[q.dtype], _stream(q))
    _raise_rc(rc, "flashmask_fwd")
    launch_counts["flashmask_fwd"] += 1
    return o, lse, tiles


@declares(_fm_dq_work)
def flashmask_dq(q, k, v, do, lse, delta, start, end, scale, causal, *,
                 tiles):
    """K6dq: ``dq [B, Lq, H, D]`` in q's dtype; ``tiles`` is the summary
    :func:`flashmask_fwd` returned for these bounds."""
    if not _device_ok(q):
        return plain_flashmask_dq(q, k, v, do, lse, delta, start, end,
                                  scale, causal)
    _check(q, k, v, do, lse, delta)
    hm = _check_bounds(q, k, start, end, tiles)
    b, lq, h, d = q.shape
    dq = torch.empty_like(q)
    rc = _lib("flashmask_bwd").ptt_flashmask_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), start.data_ptr(), end.data_ptr(),
        tiles.data_ptr(), dq.data_ptr(), b, lq, k.shape[1], h, k.shape[2],
        hm, d, float(scale), int(bool(causal)), _DTYPES[q.dtype],
        _stream(q))
    _raise_rc(rc, "flashmask_dq")
    launch_counts["flashmask_dq"] += 1
    return dq


@declares(_fm_dkv_work)
def flashmask_dkv(q, k, v, do, lse, delta, start, end, scale, causal, *,
                  tiles):
    """K6dkv: ``(dk, dv)``, each ``[B, Lk, Hkv, D]`` in k's dtype, the
    sum over every query head of the kv group; ``tiles`` as for
    :func:`flashmask_dq`."""
    if not _device_ok(q):
        return plain_flashmask_dkv(q, k, v, do, lse, delta, start, end,
                                   scale, causal)
    _check(q, k, v, do, lse, delta)
    hm = _check_bounds(q, k, start, end, tiles)
    b, lq, h, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = _lib("flashmask_bwd").ptt_flashmask_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), start.data_ptr(), end.data_ptr(),
        tiles.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, lq, k.shape[1],
        h, k.shape[2], hm, d, float(scale), int(bool(causal)),
        _DTYPES[q.dtype], _stream(q))
    _raise_rc(rc, "flashmask_dkv")
    launch_counts["flashmask_dkv"] += 1
    return dk, dv


class FlashMaskAttention(torch.autograd.Function):
    """Attention under the FlashMask mask with the FA-2 backward: the
    forward saves ``(q, k, v, start, end, tiles, o, lse)``; the backward
    forms ``delta = rowsum(dO * O)`` in float32 (as the reference's
    ``_fm_bwd``) and runs the dq and dk/dv passes on the forward's tile
    summary. The bounds get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, start, end, scale, causal):
        o, lse, tiles = flashmask_fwd(q, k, v, start, end, scale, causal)
        ctx.save_for_backward(q, k, v, start, end, tiles, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, start, end, tiles, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        args = (q, k, v, do, lse, delta, start, end, ctx.scale, ctx.causal)
        dq = flashmask_dq(*args, tiles=tiles)
        dk, dv = flashmask_dkv(*args, tiles=tiles)
        return dq, dk, dv, None, None, None, None


def flashmask_attention_core(q, k, v, startend_row_indices, causal=False,
                             sm_scale=None):
    """Differentiable FlashMask attention over ``q [B, Lq, H, D]`` and
    ``k``/``v`` ``[B, Lk, Hkv, D]`` with the compact mask
    ``startend_row_indices [B, Hm, Lk, 1 or 2]`` (see
    :func:`flashmask_bounds`); ``sm_scale`` defaults to ``1 / sqrt(D)``.
    The counterpart of ``pallas_flashmask_attention``."""
    b, lq, h, d = q.shape
    start, end = flashmask_bounds(startend_row_indices, lq, h, k.shape[2],
                                  device=q.device)
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    return FlashMaskAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), start, end, scale,
                                    bool(causal))
