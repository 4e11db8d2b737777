"""K2r — ragged paged attention: the CUDA kernel
(``csrc/ragged_paged_attention.cu``; a bfloat16 ``q`` runs the Hopper
body of ``csrc/paged_attention_sm90.cuh`` over any pools) and its plain
PyTorch version.

Counterpart of ``pallas_ragged_paged_attention`` /
``_xla_ragged_paged`` in ``paddle_tpu/ops/pallas/paged_attention.py``.
One packed buffer ``q [R, H, D]`` holds every live query row of a
serving tick; slot ``s`` owns rows ``row_starts[s] .. row_starts[s] +
q_lens[s]``, and its row ``t`` attends the first ``context_lens[s] + t``
positions of the slot's blocks in the pool ``[NB, BS, H_kv, D]``.
Rows that belong to no slot (a serving tick's pad rows) come out zero
on both devices: the wrapper starts the kernel's output from zeros.

The pools are floating tensors of ``q``'s dtype, float32 pools under a
bfloat16 ``q`` (GPT's: the reference keeps its pools float32 whatever
the model's dtype), or a pair of
:class:`~paddle_tpu_torch.ops.paged_cache.QuantKV` (int8 pages and a
float32 scale a position and kv head), which the kernel dequantizes as
it reads them; its launches are then counted as
``ragged_paged_attention_int8``. The int8 recipe is the reference's
(``_dequant_tile``): ``q`` in float32, each page int8 -> float32 times
its scale, both products in float32 with P not rounded.

A bfloat16 ``q`` over float32 pools follows the TPU kernel's recipe on
those inputs: the scores ``q . k`` in float32 times the scale, the
online softmax in float32, P kept float32 (the kernel casts it to V's
dtype) into the product with the float32 V, and only the output rounded
to bfloat16. The Hopper body holds it on the tensor cores by splitting
K, V and P into bfloat16 hi + lo halves (S = q K_hi + q K_lo, O = P_hi
V_hi + P_lo V_hi + P_hi V_lo: ~2^-16 relative before the output's
rounding). Its launches are counted as
``ragged_paged_attention_f32pool`` (``_tree_f32pool`` in the tree mode).
The plain version holds that recipe too; the reference's XLA fallback
(``_xla_ragged_paged``) differs from it, rounding P to ``q``'s dtype.

The token-tree mode (``tree_anc``, a parent tuple of T - 1 nodes, with
``tree_slots``, int32 flags ``[S]``; the reference's ``tree_bits`` and
``tree_ref``): row ``t < T`` of a slot flagged ``> 0`` sees the
positions below ``context_lens[s]`` (the committed prefix and the root)
and, of its window, exactly its ancestors (:func:`tree_ancestor_bits`);
unflagged slots (prefill chunks and their trickle rows) keep the linear
bound in the same launch. The mask is a subset of the linear bound, and
a chain tree ``tuple(range(T - 1))`` is the linear bound itself. Its
launches are counted as ``ragged_paged_attention_tree`` (``_tree_int8``
on int8 pools).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...monitor.accounting import declares
from . import _build, held, launch_counts, no_backward
from ..paged_cache import QuantKV, kv_dequantize

__all__ = ["ragged_paged_attention", "plain_ragged_paged_attention",
           "sm90_blocks_per_sm", "sm90_scratch_sizes", "sm90_scratch",
           "sm_count",
           "pool_operands", "dtype_code", "tree_ancestor_bits"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
F32_POOL = 2    # the C entries' dtype code of a bfloat16 q over f32 pools
_LIB = None
SPLIT_POSITIONS = 256     # float32: context positions per split of a row
MAX_SPLITS = 8
# the Hopper body's (csrc/paged_attention_sm90.cuh): query vectors a
# tile, blocks an SM (its instances' Cfg::BLOCKS: one for float32 pools at
# head_dim 128), slots a call
SM90_TILE = 64
SM90_BLOCKS_PER_SM = 2
SM90_MAX_SLOTS = 512
_SCRATCH = {}


def tree_ancestor_bits(parents) -> tuple:
    """Per-node inclusive ancestor bitmasks of a speculative token tree.
    ``parents[k]`` names node ``k + 1``'s parent (``parents[k] in [0,
    k]``: nodes in topological order, node 0 the committed root); the
    chain is ``tuple(range(gamma))``. Bit ``j - 1`` of ``bits[t]`` is set
    iff window node ``j >= 1`` is an ancestor of node ``t`` or ``t``
    itself: the columns row ``t`` may attend to beyond the committed
    prefix. A chain gives ``bits[t] = (1 << t) - 1``, the linear bound.
    Raises ``ValueError`` past 31 draft nodes or on a parent that is not
    an earlier node."""
    parents = tuple(int(p) for p in parents)
    if len(parents) > 31:
        raise ValueError(
            f"spec tree supports at most 31 draft nodes (int32 "
            f"ancestor bitmask), got {len(parents)}")
    bits = [0]
    for k, p in enumerate(parents):
        if not 0 <= p <= k:
            raise ValueError(
                f"spec_tree[{k}] = {p}: node {k + 1}'s parent must be "
                f"an earlier node (0..{k})")
        bits.append(bits[p] | (1 << k))
    return tuple(bits)


def _tree_rows_fit(rows, t):
    """Raise unless ``rows`` (a host int: the most rows a flagged slot
    has) fits the tree's ``t`` nodes."""
    if rows > t:
        raise ValueError(
            f"a tree slot has {rows} rows but the tree has {t} nodes: a "
            "flagged slot's rows must fit its tree window")


def plain_ragged_paged_attention(q, k_pool, v_pool, block_tables,
                                 context_lens, q_lens, row_starts,
                                 sm_scale=None, tree_anc=None,
                                 tree_slots=None, tree_rows=None):
    """Dense per-row masked softmax over each slot's gathered blocks:
    scores, softmax and the P @ V product in float32 (the pages read as
    float32: a float32 pool as it is, so a bfloat16 ``q`` over float32
    pools keeps the kernel's recipe), output in ``q``'s dtype. ``tree_anc`` / ``tree_slots``: the tree mode (module
    docstring), the reference's ``_xla_ragged_paged`` tree mask op for
    op: ``rel = col - context_lens[s]``, kept iff ``rel < 0`` or bit
    ``rel`` of the row's ancestor mask. Raises, as the kernel's wrapper
    does, when ``tree_rows`` exceeds the tree's nodes, and also when a
    flagged slot's ``q_lens`` does."""
    bits = None
    ql = q_lens.tolist()
    if tree_anc is not None:
        bits = tree_ancestor_bits(tree_anc)
        flags = [True] * block_tables.shape[0] if tree_slots is None \
            else [int(f) > 0 for f in tree_slots.tolist()]
        if tree_rows is not None:
            _tree_rows_fit(int(tree_rows), len(bits))
        _tree_rows_fit(max([n for n, f in zip(ql, flags) if f], default=0),
                       len(bits))
    r, h, d = q.shape
    bs, hkv = k_pool.shape[1], k_pool.shape[2]
    rep = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    out = torch.zeros_like(q)
    rs = row_starts.tolist()
    cl = context_lens.tolist()
    for s, n in enumerate(ql):
        if n <= 0:
            continue
        r0 = rs[s]
        nb = min(-(-(cl[s] + n - 1) // bs), block_tables.shape[1])
        ids = block_tables[s, :nb].long()
        ks = _pages(k_pool, ids).reshape(nb * bs, hkv, d)
        vs = _pages(v_pool, ids).reshape(nb * bs, hkv, d)
        qs = q[r0:r0 + n].float().reshape(n, hkv, rep, d)
        sc = torch.einsum("tgrd,lgd->tgrl", qs, ks) * scale
        cols = torch.arange(nb * bs, device=q.device)
        bound = cl[s] + torch.arange(n, device=q.device)
        allow = cols[None, :] < bound[:, None]                # [n, L]
        if bits is not None and flags[s]:
            nt = min(n, len(bits))
            bits_a = torch.tensor(bits[:nt], dtype=torch.int64,
                                  device=q.device)
            rel = cols[None, :] - cl[s]
            bit = (bits_a[:, None] >> torch.clamp(rel, 0, 31)) & 1
            allow = allow.clone()
            allow[:nt] = (rel < 0) | (bit > 0)
        sc = sc.masked_fill(~allow[:, None, None, :], float("-inf"))
        w = torch.softmax(sc, dim=-1)
        o = torch.einsum("tgrl,lgd->tgrd", w, vs)
        out[r0:r0 + n] = o.reshape(n, h, d).to(q.dtype)
    return out


def _pages(pool, ids):
    """The pages ``ids`` of a pool in float32 (an int8 pool dequantized)."""
    if isinstance(pool, QuantKV):
        return kv_dequantize(pool.data[ids], pool.scale[ids])
    return pool[ids].float()


def sm90_blocks_per_sm(code, head_dim):
    """Blocks an SM of the Hopper body's instance for dtype code ``code``
    (1, or F32_POOL) at ``head_dim``: its grid is a wave of them. The
    library's ``ptt_paged_attention_blocks_per_sm`` gives the compiled
    value; a GPU test holds the two equal."""
    return 1 if code == F32_POOL and head_dim == 128 else SM90_BLOCKS_PER_SM


def sm90_scratch_sizes(slots, kv_heads, rep, w_max, head_dim, sms,
                       blocks=SM90_BLOCKS_PER_SM):
    """``(records, partial floats, counters)`` of the Hopper body for
    ``slots`` slots of at most ``w_max`` rows on a card of ``sms`` SMs:
    the body splits decode rows and windows only while every item fits
    one wave of its grid (``blocks`` blocks an SM:
    :func:`sm90_blocks_per_sm`), each split item's record holding (m, l,
    o) of a tile's ``min(SM90_TILE // rep, w_max) * rep`` query vectors;
    one arrival counter a (slot, kv head)."""
    records = blocks * sms
    nv = min(SM90_TILE // rep, w_max) * rep
    return records, records * nv * (head_dim + 2), slots * kv_heads


def sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def sm90_scratch(device, stream, floats, counters):
    """The Hopper body's scratch of ``stream`` (a handle) on
    ``device``, grown to ``floats`` partial floats and ``counters``
    arrival counters (zeros: every call leaves them zero). Calls on one
    stream run one after another, so they share it; a growth replaces
    the tensors, so a CUDA graph holds what it captured
    (:func:`~paddle_tpu_torch.ops.kernels.hold_scratch`)."""
    sc = _SCRATCH.get((device, stream))
    if sc is None or sc[0].numel() < floats or sc[1].numel() < counters:
        old = (0, 0) if sc is None else (sc[0].numel(), sc[1].numel())
        sc = _SCRATCH[(device, stream)] = (
            torch.empty(max(floats, old[0], 1), device=device,
                        dtype=torch.float32),
            torch.zeros(max(counters, old[1], 1), device=device,
                        dtype=torch.int32))
    return held(*sc)


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("ragged_paged_attention")
        fn = lib.ptt_ragged_paged_attention
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        # + the tree's masks (a host array), their count and the flags
        tr = lib.ptt_ragged_paged_attention_tree
        tr.argtypes = fn.argtypes + [ctypes.POINTER(ctypes.c_uint32),
                                     ctypes.c_int, ctypes.c_void_p]
        tr.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def pool_operands(q, k_pool, v_pool):
    """The kernels' pool operands ``(k data, v data, k scale, v scale)``:
    floating pools of ``q``'s dtype or, under a bfloat16 ``q``, float32
    pools (scales None), or two int8 :class:`QuantKV` of the same shape
    (int8 data, float32 scales ``[NB, BS, Hkv]``); each on ``q``'s
    device, contiguous and 16-byte aligned. Raises on anything else,
    mixed pools included."""
    quant = isinstance(k_pool, QuantKV)
    if quant != isinstance(v_pool, QuantKV):
        raise TypeError("mixed pools: K and V must both be int8 QuantKV "
                        "pools or both floating")
    if quant:
        kd, vd, ks, vs = k_pool.data, v_pool.data, k_pool.scale, \
            v_pool.scale
        if kd.dtype != torch.int8 or vd.dtype != torch.int8 \
                or ks.dtype != torch.float32 or vs.dtype != torch.float32:
            raise TypeError("int8 pools hold int8 data and float32 scales")
        if kd.dim() != 4 or tuple(ks.shape) != tuple(kd.shape[:3]) \
                or tuple(vs.shape) != tuple(vd.shape[:3]):
            raise ValueError(f"int8 pools: data {tuple(kd.shape)} / "
                             f"{tuple(vd.shape)} want [NB, BS, Hkv, D], "
                             f"scales {tuple(ks.shape)} / "
                             f"{tuple(vs.shape)} want [NB, BS, Hkv]")
    else:
        kd, vd, ks, vs = k_pool, v_pool, None, None
        want = torch.float32 if q.dtype == torch.bfloat16 \
            and kd.dtype == torch.float32 else q.dtype
        if kd.dtype != want or vd.dtype != want:
            raise TypeError(f"pools {kd.dtype} / {vd.dtype}: floating "
                            f"pools must share q's dtype ({q.dtype}), or "
                            "be float32 pools under a bfloat16 q")
    for name, t in (("k_pool", kd), ("v_pool", vd), ("k_scale", ks),
                    ("v_scale", vs)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return kd, vd, ks, vs


def dtype_code(q, kd):
    """The C entries' dtype code and the launch counter's suffix for ``q``
    over pool data ``kd`` (:func:`pool_operands`): 0 float32 (the FMA
    body), 1 bfloat16 over bfloat16 or int8 pools, F32_POOL a bfloat16 q
    over float32 pools (counted as ``*_f32pool``); 1 and F32_POOL run the
    Hopper body."""
    if q.dtype == torch.bfloat16 and kd.dtype == torch.float32:
        return F32_POOL, "_f32pool"
    return _DTYPES[q.dtype], ""


def _check(q, k_pool, v_pool, block_tables, context_lens, q_lens,
           row_starts):
    dev = q.device
    for name, t in (("block_tables", block_tables),
                    ("context_lens", context_lens), ("q_lens", q_lens),
                    ("row_starts", row_starts)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    kd, vd, ks, vs = pool_operands(q, k_pool, v_pool)
    for name, t in (("block_tables", block_tables),
                    ("context_lens", context_lens), ("q_lens", q_lens),
                    ("row_starts", row_starts)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 3 or kd.dim() != 4 or kd.shape != vd.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)} (want [R, H, D]), "
                         f"pools {tuple(kd.shape)} / "
                         f"{tuple(vd.shape)} (want [NB, BS, Hkv, D])")
    r, h, d = q.shape
    _, bs, hkv, d2 = kd.shape
    s = block_tables.shape[0]
    if d2 != d or d not in (64, 128):
        raise ValueError(f"head_dim {d} (pool {d2}): the kernel takes 64 "
                         "or 128")
    if bs not in (8, 16, 32):
        raise ValueError(f"block_size {bs}: the kernel takes 8, 16 or 32")
    if h % hkv or h // hkv > 64:
        raise ValueError(f"{h} query heads over {hkv} kv heads: need a "
                         "whole group of at most 64")
    if not (context_lens.shape == q_lens.shape == row_starts.shape
            == (s,)):
        raise ValueError("context_lens, q_lens and row_starts must be [S]")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    if dtype_code(q, kd)[0] != 0 and s > SM90_MAX_SLOTS:
        raise ValueError(f"{s} slots: the bfloat16 kernel takes at most "
                         f"{SM90_MAX_SLOTS}")
    return kd, vd, ks, vs


def _n_split(block_tables, block_size):
    """Context splits per (slot, kv head, row tile): one per
    SPLIT_POSITIONS of the table's reach, at most MAX_SPLITS."""
    reach = block_tables.shape[1] * block_size
    return max(1, min(MAX_SPLITS, -(-reach // SPLIT_POSITIONS)))


def pool_bytes_per_pos(q, k_pool, v_pool):
    """Bytes one cached position of one kv head costs in a pool: its K
    (or V) row, and its scale on int8 pools."""
    kd, _, ks, _ = pool_operands(q, k_pool, v_pool)
    return kd.shape[-1] * kd.element_size() + (0 if ks is None else 4)


def _ragged_work(q, k_pool, v_pool, block_tables, context_lens, q_lens,
                 row_starts, w_max, sm_scale=None, tree_anc=None,
                 tree_slots=None, tree_rows=None):
    """One K2r call's bound, counted from this call's lengths (device
    scalars): each slot's K and V over its ``context + rows`` positions,
    q read and the output written, the tables and per-slot rows; 4 x D
    operations a visible (row, position) pair a query head (the linear
    bound: a tree's rows see no more)."""
    kd, _, ks, _ = pool_operands(q, k_pool, v_pool)
    r, h, d = q.shape
    hkv = kd.shape[2]
    ql = q_lens.long()
    cl = context_lens.long()
    kv_pos = ((cl + ql) * (ql > 0)).sum()
    vis = (ql * cl + ql * (ql + 1) // 2).sum()
    code, mode = dtype_code(q, kd)
    name = "ragged_paged_attention" + ("_tree" if tree_anc is not None
                                       else "") \
        + ("_int8" if ks is not None else mode)
    nbytes = 2 * kv_pos * hkv * pool_bytes_per_pos(q, k_pool, v_pool) \
        + 2 * q.numel() * q.element_size() \
        + 4 * (block_tables.numel() + 3 * block_tables.shape[0])
    return name, 4 * vis * h * d, nbytes


@no_backward("ragged_paged_attention (K2r)")
@declares(_ragged_work)
def ragged_paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                           q_lens, row_starts, w_max, sm_scale=None,
                           tree_anc=None, tree_slots=None, tree_rows=None):
    """Ragged paged attention. ``w_max`` (a host int) bounds
    ``q_lens``: the kernel attends at most ``w_max`` rows a slot.
    ``tree_anc`` / ``tree_slots``: the tree mode (module docstring), with
    ``tree_rows`` (a host int, ``w_max`` when None) bounding the rows of
    the flagged slots; raises past 31 drafts, or when ``tree_rows``
    exceeds the tree's nodes. Row ``t >= T`` of a flagged slot would
    keep the linear bound. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if q.device.type == "cpu":
        return plain_ragged_paged_attention(
            q, k_pool, v_pool, block_tables, context_lens, q_lens,
            row_starts, sm_scale=sm_scale, tree_anc=tree_anc,
            tree_slots=tree_slots, tree_rows=tree_rows)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    kd, vd, ks, vs = _check(q, k_pool, v_pool, block_tables, context_lens,
                            q_lens, row_starts)
    tree = ()
    if tree_anc is not None:
        bits = tree_ancestor_bits(tree_anc)
        if tree_slots is not None:
            if tree_slots.device != q.device or tree_slots.dtype \
                    != torch.int32 or tuple(tree_slots.shape) \
                    != (block_tables.shape[0],) \
                    or not tree_slots.is_contiguous():
                raise ValueError("tree_slots must be a contiguous int32 "
                                 "[S] on q's device")
        _tree_rows_fit(int(w_max if tree_rows is None else tree_rows),
                       len(bits))
        tree = ((ctypes.c_uint32 * len(bits))(*bits), len(bits),
                None if tree_slots is None else tree_slots.data_ptr())
    r, h, d = q.shape
    nb, bs, hkv, _ = kd.shape
    s, mb = block_tables.shape
    w_max = int(w_max)
    # the kernel writes the rows some slot owns; pad rows stay zero
    out = torch.zeros_like(q)
    if w_max <= 0 or r == 0:
        return out
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code, mode = dtype_code(q, kd)
    if code != 0:
        n_split, floats, counters = sm90_scratch_sizes(
            s, hkv, h // hkv, w_max, d, sm_count(q.device),
            sm90_blocks_per_sm(code, d))
        part, cnt = sm90_scratch(q.device, stream, floats, counters)
    else:
        n_split, cnt = _n_split(block_tables, bs), None
        part = torch.empty(n_split * r * h * (d + 2), device=q.device,
                           dtype=torch.float32) if n_split > 1 else None
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    name = "ragged_paged_attention" + ("_tree" if tree else "")
    rc = getattr(_lib(), "ptt_" + name)(
        q.data_ptr(), kd.data_ptr(), vd.data_ptr(), ptr(ks), ptr(vs),
        block_tables.data_ptr(), context_lens.data_ptr(),
        q_lens.data_ptr(), row_starts.data_ptr(), out.data_ptr(), ptr(part),
        ptr(cnt), r, s, h, hkv, d, bs, mb, nb, w_max, n_split, float(scale),
        code, stream, *tree)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {rc})")
    launch_counts[name + ("_int8" if ks is not None else mode)] += 1
    return out
