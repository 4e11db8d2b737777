"""Paged KV cache: block pool + per-slot block tables (counterpart of
``paddle_tpu/ops/paged_cache.py``, the part the core serving engine
uses).

All sequences share one pool of fixed-size blocks
``[num_blocks, block_size, H_kv, D]``; each serving slot owns an int32
row of block ids (its block table). Position ``p`` of a slot lives at
``(table[p // block_size], p % block_size)``. Block 0 is the null
block: inactive slots point at it and pad rows write into it, so no
read or write ever leaves the pool.

A pool half is a floating tensor in the model dtype, or a
:class:`QuantKV`: int8 data plus one float32 absmax scale a (block,
position, kv head), quantized on store (:func:`kv_quantize`) in the one
scatter every write goes through and dequantized by the attention
kernels as they read it.

The host-side :class:`BlockAllocator` is a plain refcounted free list.
The prefix-cache publishing of the reference (content hashes, LRU
parking, copy-on-write) belongs to a later slice.

Unlike the reference's pure functions, the writes (:func:`write_prefill`,
:func:`write_decode`, :func:`write_tokens`, :func:`write_rows`) update
the pools in place: a pool is the largest tensor the engine holds and
PyTorch lets the scatter land without a copy. They return the same pool
tensors.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["NULL_BLOCK", "blocks_for", "BlockAllocator", "QuantKV",
           "kv_quantize", "kv_dequantize", "resolve_kv_cache_dtype",
           "pool_bytes", "init_pool", "write_prefill", "write_decode",
           "write_tokens", "write_rows", "permute_window", "window_moves",
           "move_rows", "gather_dense", "ragged_row_meta"]

NULL_BLOCK = 0


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache positions."""
    return -(-int(n_tokens) // int(block_size))


class QuantKV:
    """One half (K or V) of an int8 pool: ``data`` int8 ``[NB, BS, H_kv,
    D]`` and ``scale`` float32 ``[NB, BS, H_kv]`` (symmetric absmax / 127
    a position and kv head). ``shape`` / ``dtype`` / ``ndim`` mirror the
    data, so shape logic written for a floating pool reads it unchanged;
    ``nbytes`` counts data and scales."""

    __slots__ = ("data", "scale")

    def __init__(self, data, scale):
        self.data = data
        self.scale = scale

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndim(self):
        return self.data.dim()

    @property
    def nbytes(self):
        return _nbytes(self.data) + _nbytes(self.scale)

    def __repr__(self):
        return (f"QuantKV(data={tuple(self.data.shape)} int8, "
                f"scale={tuple(self.scale.shape)})")


def _nbytes(t):
    return t.numel() * t.element_size()


_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def kv_quantize(x):
    """Symmetric absmax int8 quantization of K/V rows over the head dim:
    ``x [..., D]`` -> ``(int8 [..., D], float32 scale [...])`` with
    ``scale = absmax * float32(1 / 127)``; an all-zero row stores scale 0
    (and dequantizes to exact zeros). ``torch.round`` rounds half to
    even, as the reference's ``jnp.round``, so both store the same
    bytes."""
    xf = x.float()
    # a CPU scalar tensor: read on the host, so no copy to the device
    # (which a CUDA graph capture would refuse)
    scale = xf.abs().amax(dim=-1) * _INV127
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def kv_dequantize(data, scale, dtype=torch.float32):
    """``int8 [..., D] * float32 scale [...]`` -> ``dtype [..., D]``: the
    int8 value made float32, times its scale, then cast (the recipe of
    the kernels and of the plain versions)."""
    return (data.float() * scale[..., None]).to(dtype)


def resolve_kv_cache_dtype(requested=None):
    """``"int8"`` for an int8 pool, None for a pool in the model dtype.
    ``requested`` is ``ServingConfig.kv_cache_dtype`` /
    ``generate(kv_cache_dtype=)``: None or ``"auto"`` (the model dtype)
    or ``"int8"``; anything else raises ``ValueError``."""
    if requested is None or requested == "auto":
        return None
    if str(requested).lower() == "int8":
        return "int8"
    raise ValueError(
        f"kv_cache_dtype {requested!r}; supported: None/'auto' (pool in "
        "the model dtype) or 'int8' (quantized pool)")


def pool_bytes(pools) -> int:
    """Bytes of a per-layer ``[(k, v), ...]`` pool list (an int8 pool
    counts its data and its scales)."""
    return sum((kp.nbytes if isinstance(kp, QuantKV) else _nbytes(kp))
               + (vp.nbytes if isinstance(vp, QuantKV) else _nbytes(vp))
               for kp, vp in pools)


class BlockAllocator:
    """Refcounted allocator over block ids ``1..num_blocks-1`` (block 0
    is the reserved null block). ``alloc`` hands out blocks at refcount
    1 (LIFO, so recently freed blocks are reused first); ``free`` drops
    one reference and returns a block to the free list at 0."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 null + 1 usable), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._free = list(range(self.num_blocks - 1, NULL_BLOCK, -1))
        self._refs = [0] * self.num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1):
        if n > len(self._free):
            raise RuntimeError(
                f"paged KV pool exhausted: want {n} blocks, "
                f"{len(self._free)} free of {self.num_blocks - 1}")
        out = self._free[-n:][::-1] if n else []
        if n:
            del self._free[-n:]
        for b in out:
            self._refs[b] = 1
        return out

    def free(self, block_ids):
        for b in block_ids:
            b = int(b)
            if not (NULL_BLOCK < b < self.num_blocks):
                raise ValueError(f"freeing invalid block id {b}")
            if self._refs[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)

    def check_leaks(self, live_blocks=()):
        """Every block is exactly one of {free, referenced}, and the
        referenced set equals ``live_blocks``. Raises RuntimeError."""
        live = {int(b) for b in live_blocks}
        free = set(self._free)
        if len(free) != len(self._free):
            raise RuntimeError("a block sits on the free list twice")
        refd = {b for b in range(1, self.num_blocks) if self._refs[b] > 0}
        if refd & free:
            raise RuntimeError(
                f"referenced blocks on the free list: {sorted(refd & free)}")
        lost = set(range(1, self.num_blocks)) - free - refd
        if lost:
            raise RuntimeError(f"leaked blocks: {sorted(lost)}")
        if refd != live:
            raise RuntimeError(
                f"live-block mismatch: allocator holds {sorted(refd)}, "
                f"caller expects {sorted(live)}")
        return True


def init_pool(num_blocks: int, block_size: int, num_kv_heads: int,
              head_dim: int, dtype, device) -> tuple:
    """Zeroed ``(k_pool, v_pool)``, each
    ``[num_blocks, block_size, H_kv, D]``: floating tensors of ``dtype``,
    or, for ``dtype="int8"``, two :class:`QuantKV` (int8 data, float32
    scales ``[NB, BS, H_kv]``; zero scales dequantize to exact zeros)."""
    shape = (num_blocks, block_size, num_kv_heads, head_dim)
    if dtype == "int8":
        return tuple(QuantKV(torch.zeros(shape, dtype=torch.int8,
                                         device=device),
                             torch.zeros(shape[:3], dtype=torch.float32,
                                         device=device))
                     for _ in range(2))
    if not dtype.is_floating_point:
        raise ValueError(f"pool dtype {dtype}: a floating dtype or 'int8'")
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _store_half(pool, bi, off, rows):
    if isinstance(pool, QuantKV):
        q, s = kv_quantize(rows)
        pool.data[bi, off] = q
        pool.scale[bi, off] = s
    else:
        pool[bi, off] = rows.to(pool.dtype)


def _store(k_pool, v_pool, bi, off, k_rows, v_rows):
    """The scatter every write funnels through: rows land at
    ``[bi, off]`` of both pools, in place, cast to the pool dtype or, in
    an int8 pool, quantized with their scales at the same indices (so
    the null routing decided upstream covers both)."""
    _store_half(k_pool, bi, off, k_rows)
    _store_half(v_pool, bi, off, v_rows)
    return k_pool, v_pool


def _table_rows(block_tables, blk, mb):
    """``block_tables[s, blk]`` for ``blk [S, ...]``, with blocks past
    the table's reach routed to the null block (never clamped onto the
    slot's last block)."""
    t = block_tables.long()
    idx = torch.clamp(blk, 0, mb - 1).reshape(t.shape[0], -1)
    bi = torch.gather(t, 1, idx).reshape(blk.shape)
    return torch.where(blk < mb, bi, torch.full_like(bi, NULL_BLOCK))


def write_prefill(k_pool, v_pool, block_tables, k_new, v_new, n_real=None):
    """Scatter a dense prefill's K/V ``[B, P, H_kv, D]`` into the pool
    (position ``p`` of slot ``b`` through ``block_tables [B, MB]``).
    Positions ``>= n_real`` (``[B]`` or a scalar; default all ``P``) go
    to the null block, so a right-padded prompt's tail never lands in
    live blocks."""
    b, p = k_new.shape[0], k_new.shape[1]
    bs, mb = k_pool.shape[1], block_tables.shape[1]
    pos = torch.arange(p, device=k_new.device)
    bi = block_tables.long()[:, torch.clamp(pos // bs, max=mb - 1)]
    if n_real is not None:
        n = torch.as_tensor(n_real, device=k_new.device).reshape(-1, 1)
        bi = torch.where(pos[None, :] < n, bi,
                         torch.full_like(bi, NULL_BLOCK))
    off = (pos % bs).expand(b, p)
    return _store(k_pool, v_pool, bi, off, k_new, v_new)


def write_decode(k_pool, v_pool, block_tables, cache_lens, k_new, v_new):
    """Write ONE token per slot (``[S, H_kv, D]``) at position
    ``cache_lens[s]`` (the valid length before it); positions past the
    table's reach go to the null block."""
    bs, mb = k_pool.shape[1], block_tables.shape[1]
    lens = cache_lens.long()
    bi = _table_rows(block_tables, lens // bs, mb)
    return _store(k_pool, v_pool, bi, lens % bs, k_new, v_new)


def write_tokens(k_pool, v_pool, block_tables, cache_lens, k_new, v_new):
    """Append T tokens per slot (``[S, T, H_kv, D]``): token ``t`` of
    slot ``s`` lands at ``cache_lens[s] + t``. Positions past the
    table's reach (``MB * block_size`` and on) go to the null block.
    Rolling back rejected speculated tokens needs no cache edit: the
    caller keeps its lengths, and the next window overwrites them."""
    t = k_new.shape[1]
    bs, mb = k_pool.shape[1], block_tables.shape[1]
    pos = cache_lens.long()[:, None] + torch.arange(t, device=k_new.device)
    bi = _table_rows(block_tables, pos // bs, mb)
    return _store(k_pool, v_pool, bi, pos % bs, k_new, v_new)


def write_rows(k_pool, v_pool, block_tables, row_slot, row_pos, k_new,
               v_new):
    """Scatter a ragged batch in place: row ``r`` of ``k_new``/``v_new``
    (``[R, H_kv, D]``) lands at cache position ``row_pos[r]`` of slot
    ``row_slot[r]``. Rows whose position is negative or past the table's
    reach (the pad rows' overflow position) go to the null block.
    Returns the (same) pools."""
    bs = k_pool.shape[1]
    mb = block_tables.shape[1]
    pos = row_pos.long()
    slot = row_slot.long()
    blk = torch.div(pos, bs, rounding_mode="floor")
    bi = block_tables.long()[slot, torch.clamp(blk, 0, mb - 1)]
    bi = torch.where((pos >= 0) & (blk < mb), bi,
                     torch.full_like(bi, NULL_BLOCK))
    off = torch.remainder(pos, bs)
    return _store(k_pool, v_pool, bi, off, k_new, v_new)


def permute_window(k_pool, v_pool, block_tables, cache_lens, perm, n_keep):
    """Tree-acceptance K/V compaction, in place: after a tree verify,
    slot ``s``'s accepted root path lies at the window positions
    ``cache_lens[s] + perm[s, j]``; move each onto ``cache_lens[s] + j``
    (``j < n_keep[s]``), so the accepted tokens' rows lie in order, as
    sequential decoding would put them. ``perm [S, T]`` is a root path in node
    order (``perm[s, j] >= j``), ``n_keep [S]`` the positions to keep (0
    skips the slot). Every source row is gathered into a fresh tensor
    before any write, so overlapping moves cannot clobber each other;
    positions past ``n_keep`` (and slots with ``n_keep == 0``) go to the
    null block. An int8 pool moves data and scales. Returns the (same)
    pools."""
    return move_rows(k_pool, v_pool, window_moves(
        k_pool.shape[1], block_tables, cache_lens, perm, n_keep))


def window_moves(block_size, block_tables, cache_lens, perm, n_keep):
    """The pool addresses of :func:`permute_window`'s moves, ``(source
    blocks, source offsets, destination blocks, destination offsets)``,
    each ``[S, T]``; one set serves every layer's pools."""
    bs, mb = int(block_size), block_tables.shape[1]
    lens = cache_lens.long()
    tables = block_tables.long()
    t = perm.shape[1]
    j = torch.arange(t, device=lens.device)[None, :]
    keep = j < torch.as_tensor(n_keep, device=lens.device).long() \
        .reshape(-1, 1)

    def addr(pos):
        blk = torch.div(pos, bs, rounding_mode="floor")
        bi = torch.gather(tables, 1, torch.clamp(blk, 0, mb - 1))
        bi = torch.where(keep & (pos >= 0) & (blk < mb), bi,
                         torch.full_like(bi, NULL_BLOCK))
        return bi, torch.remainder(pos, bs)

    return addr(lens[:, None] + perm.long()) + addr(lens[:, None] + j)


def move_rows(k_pool, v_pool, moves):
    """Apply :func:`window_moves`' moves to one layer's pools, in place
    (the gather is a fresh tensor, written after it is whole). Returns
    the pools."""
    sbi, soff, dbi, doff = moves
    for pool in (k_pool, v_pool):
        for x in ((pool.data, pool.scale) if isinstance(pool, QuantKV)
                  else (pool,)):
            x[dbi, doff] = x[sbi, soff]
    return k_pool, v_pool


def gather_dense(pool, block_tables):
    """``[S, MB * BS, H_kv, D]`` dense view of each slot's blocks
    (positions past a slot's length read whatever the blocks hold; the
    caller masks by length). An int8 pool comes back dequantized to
    float32."""
    s, mb = block_tables.shape
    t = block_tables.long()
    if isinstance(pool, QuantKV):
        g = kv_dequantize(pool.data[t], pool.scale[t])
    else:
        g = pool[t]                             # [S, MB, BS, H_kv, D]
    return g.reshape(s, mb * pool.shape[1], pool.shape[2], pool.shape[3])


def ragged_row_meta(q_lens, base_lens, total_rows, overflow_pos):
    """Host-side row layout of one ragged step: slot ``s`` contributes
    ``q_lens[s]`` consecutive rows whose cache positions start at
    ``base_lens[s]``; rows are packed in slot order into
    ``total_rows``. Returns ``(row_slot [R], row_pos [R], row_starts
    [S], last_rows [S])`` int32; pad rows carry slot 0 and
    ``overflow_pos``; ``last_rows[s]`` is the row whose logits continue
    slot ``s`` (0 for rowless slots)."""
    q = np.asarray(q_lens, np.int64).reshape(-1)
    base = np.asarray(base_lens, np.int64).reshape(-1)
    if int(q.sum()) > int(total_rows):
        raise ValueError(
            f"ragged batch of {int(q.sum())} rows exceeds the "
            f"row budget ({int(total_rows)})")
    row_slot = np.zeros(int(total_rows), np.int32)
    row_pos = np.full(int(total_rows), int(overflow_pos), np.int32)
    row_starts = np.zeros(len(q), np.int32)
    last_rows = np.zeros(len(q), np.int32)
    r = 0
    for s, n in enumerate(map(int, q)):
        row_starts[s] = r
        if n:
            row_slot[r:r + n] = s
            row_pos[r:r + n] = base[s] + np.arange(n)
            last_rows[s] = r + n - 1
        r += n
    return row_slot, row_pos, row_starts, last_rows
