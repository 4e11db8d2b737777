"""Paged KV cache: block pool + per-slot block tables (counterpart of
``paddle_tpu/ops/paged_cache.py``, the part the serving engine uses).

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

The host-side :class:`BlockAllocator` is refcounted and
content-addressed: a retired sequence's full blocks are published under
rolling content hashes (:func:`chain_hashes`, a blake2b chain over the
tokens' int32 bytes seeded by a model fingerprint), and published blocks
whose refcount drops to 0 park in an LRU list, reusable by a later
prompt with the same prefix until memory pressure evicts them. A shared
block that must be appended into is copied first (:func:`copy_blocks`).
:func:`export_blocks` / :func:`import_blocks` move blocks' bytes out of
and back into the pools, and :class:`HostKVTier` keeps such payloads in
host memory (preempted requests' blocks, evicted published blocks).

Unlike the reference's pure functions, every write (:func:`write_prefill`,
:func:`write_decode`, :func:`write_tokens`, :func:`write_rows`,
:func:`move_rows`, :func:`copy_blocks`, :func:`import_blocks`) updates
the pools in place: a pool is the largest tensor the engine holds, and a
CUDA graph captured over the pools keeps reading the same storage. They
return the same pool tensors.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["NULL_BLOCK", "blocks_for", "BlockAllocator", "iter_chain_hashes",
           "chain_hashes", "model_fingerprint", "prompt_block_hashes",
           "QuantKV", "kv_quantize", "kv_dequantize",
           "resolve_kv_cache_dtype", "pool_bytes", "init_pool",
           "write_prefill", "write_decode", "write_tokens", "write_rows",
           "permute_window", "window_moves", "move_rows", "copy_blocks",
           "export_blocks", "import_blocks", "payload_to_host",
           "payload_nbytes", "payload_rows", "payload_pad", "HostKVTier",
           "gather_dense", "ragged_row_meta"]

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
    """Host-side refcounted, content-addressed allocator over block ids
    ``1..num_blocks-1`` (block 0 is the reserved null block).

    ``alloc`` hands out blocks at refcount 1 (LIFO, so recently freed
    blocks are reused first); ``free`` drops one reference, and a block
    at refcount 0 either returns to the free list (unpublished) or parks
    in the LRU cache list (published by ``publish``: it keeps its
    content hash and stays reachable through ``lookup`` until ``alloc``
    evicts it, oldest first). ``lookup`` + ``ref`` map a cached or live
    block into another sequence's table (prefix reuse); ``is_shared``
    tells the caller that a block must be copied before an append lands
    in it (refcount > 1, or published: the cache itself holds an
    interest in published content)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 null + 1 usable), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._free = list(range(self.num_blocks - 1, NULL_BLOCK, -1))
        self._refs = [0] * self.num_blocks
        self._hash_of = {}          # published block id -> content hash
        self._by_hash = {}          # content hash -> block id (bijective)
        self._lru = OrderedDict()   # refcount-0 published blocks, LRU->MRU
        self.evictions = 0          # cached blocks reclaimed by alloc()
        # ``on_evict(block_id, content_hash)`` runs when ``alloc`` reclaims
        # a cached block, before the id is handed out again, so the pool's
        # owner can still copy its bytes out (the host KV tier)
        self.on_evict = None

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: free plus evictable cached ones."""
        return len(self._free) + len(self._lru)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 published blocks parked in the LRU list."""
        return len(self._lru)

    def alloc(self, n: int = 1):
        """Pop ``n`` block ids, evicting the oldest cached blocks when the
        free list runs short; raises when even the cache cannot cover
        it."""
        if n > self.free_blocks:
            raise RuntimeError(
                f"paged KV pool exhausted: want {n} blocks, "
                f"{self.free_blocks} free of {self.num_blocks - 1}")
        while len(self._free) < n:
            b, _ = self._lru.popitem(last=False)
            h = self._hash_of.pop(b)
            self._by_hash.pop(h, None)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(b, h)
            self._free.append(b)
        out = self._free[-n:][::-1] if n else []
        if n:
            del self._free[-n:]
        for b in out:
            self._refs[b] = 1
        return out

    def free(self, block_ids):
        """Drop one reference a block; at refcount 0 a published block
        parks in the LRU cache, any other returns to the free list."""
        for b in block_ids:
            b = int(b)
            if not (NULL_BLOCK < b < self.num_blocks):
                raise ValueError(f"freeing invalid block id {b}")
            if self._refs[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                if b in self._hash_of:
                    self._lru[b] = None
                    self._lru.move_to_end(b)
                else:
                    self._free.append(b)

    def ref(self, block_id: int) -> int:
        """Take one more reference on a live or cached block (a cached
        block leaves the LRU list: it is live again)."""
        b = int(block_id)
        if not (NULL_BLOCK < b < self.num_blocks):
            raise ValueError(f"ref of invalid block id {b}")
        if self._refs[b] == 0:
            if b not in self._lru:
                raise ValueError(f"ref of free block {b}")
            del self._lru[b]
        self._refs[b] += 1
        return b

    def refcount(self, block_id: int) -> int:
        return self._refs[int(block_id)]

    def is_shared(self, block_id: int) -> bool:
        """True when an append into the block would be seen beyond the
        caller: more than one reference, or published."""
        b = int(block_id)
        return self._refs[b] > 1 or b in self._hash_of

    def lookup(self, content_hash):
        """Block id published under ``content_hash`` (cached or live), or
        None; ``ref`` it before mapping it."""
        return self._by_hash.get(content_hash)

    def publish(self, block_id: int, content_hash) -> bool:
        """Register a live block's content hash so later prompts can reuse
        it. First writer wins: when the hash already maps to a block, or
        the block is already published, nothing changes; returns whether
        this block backs the hash."""
        b = int(block_id)
        if self._refs[b] <= 0:
            raise ValueError(f"publishing dead block {b}")
        if content_hash in self._by_hash:
            return self._by_hash[content_hash] == b
        if b in self._hash_of:
            return False
        self._by_hash[content_hash] = b
        self._hash_of[b] = content_hash
        return True

    def unpublish_all(self) -> int:
        """Wipe the content index: cached blocks return to the free list,
        live blocks keep their references and lose their hashes. Returns
        the number of index entries dropped."""
        n = len(self._hash_of)
        for b in self._lru:
            self._free.append(b)
        self._lru.clear()
        self._hash_of.clear()
        self._by_hash.clear()
        return n

    def check_leaks(self, live_blocks=()):
        """Every block is exactly one of {free, cached, referenced}, the
        referenced set equals ``live_blocks``, and the hash index is
        bijective. Raises RuntimeError."""
        live = {int(b) for b in live_blocks}
        free = set(self._free)
        if len(free) != len(self._free):
            raise RuntimeError("a block sits on the free list twice")
        cached = set(self._lru)
        if free & cached:
            raise RuntimeError(
                f"blocks both free and cached: {sorted(free & cached)}")
        refd = {b for b in range(1, self.num_blocks) if self._refs[b] > 0}
        if refd & (free | cached):
            raise RuntimeError(
                "referenced blocks on a free/cache list: "
                f"{sorted(refd & (free | cached))}")
        lost = set(range(1, self.num_blocks)) - free - cached - refd
        if lost:
            raise RuntimeError(f"leaked blocks: {sorted(lost)}")
        if refd != live:
            raise RuntimeError(
                f"live-block mismatch: allocator holds {sorted(refd)}, "
                f"caller expects {sorted(live)}")
        for b, h in self._hash_of.items():
            if self._by_hash.get(h) != b:
                raise RuntimeError(
                    f"hash index not bijective at block {b}")
        for b in cached:
            if b not in self._hash_of:
                raise RuntimeError(f"cached block {b} has no hash")
        return True


def iter_chain_hashes(seed: bytes, tokens, block_size: int):
    """Lazy :func:`chain_hashes`: yields one full block's hash at a time,
    so a walk that stops at its first miss hashes no further."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    bs = int(block_size)
    h = bytes(seed)
    for i in range(len(toks) // bs):
        m = hashlib.blake2b(h, digest_size=16)
        m.update(toks[i * bs:(i + 1) * bs].tobytes())
        h = m.digest()
        yield h


def chain_hashes(seed: bytes, tokens, block_size: int):
    """Rolling hashes of the FULL blocks of ``tokens``: ``h_i =
    blake2b(h_{i-1} || int32 bytes of block i)``, 16 bytes, with ``h_-1 =
    seed``. Each hash commits to the whole prefix through its block; a
    partial last block is never hashed (never shared)."""
    return list(iter_chain_hashes(seed, tokens, block_size))


def model_fingerprint(model) -> bytes:
    """Seed of the hash chains: the model's class name and config, so
    that blocks are shared only between caches of the same model."""
    import dataclasses
    desc = [type(model).__name__]
    cfg = getattr(model, "config", None)
    if cfg is not None:
        try:
            fields = dataclasses.asdict(cfg)
        except TypeError:
            fields = dict(vars(cfg))
        desc.append(repr(sorted(fields.items())))
    return hashlib.blake2b("\x1f".join(desc).encode(),
                           digest_size=16).digest()


def prompt_block_hashes(fingerprint: bytes, prompt, block_size: int):
    """The prompt -> full-block hash walk of serving admission (lazy):
    the chain hash of each full block of ``prompt``, in order."""
    return iter_chain_hashes(fingerprint, prompt, block_size)


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
        for x in _halves(pool):
            x[dbi, doff] = x[sbi, soff]
    return k_pool, v_pool


def _halves(pool):
    """The tensors of one pool half: an int8 pool's data and scales, or
    the floating pool itself."""
    return (pool.data, pool.scale) if isinstance(pool, QuantKV) else (pool,)


def copy_blocks(pools, src: int, dst: int):
    """Copy-on-write: duplicate block ``src`` into block ``dst`` in every
    layer's ``(k, v)`` pools, in place (an int8 pool copies data and
    scales, so the copy dequantizes to its source's values). Returns the
    (same) pools."""
    for pair in pools:
        for pool in pair:
            for x in _halves(pool):
                x[int(dst)].copy_(x[int(src)])
    return pools


def _ids(block_ids, device):
    return torch.as_tensor(np.asarray(block_ids, np.int64).reshape(-1),
                           device=device)


def export_blocks(pools, block_ids):
    """Gather the self-contained bytes of ``block_ids`` out of every
    layer's ``(k, v)`` pools: a floating pool as ``[M, BS, H_kv, D]`` rows
    in its dtype, an int8 pool as a :class:`QuantKV` of data and scales.
    The pools are read, not changed."""
    def gx(pool, idx):
        if isinstance(pool, QuantKV):
            return QuantKV(pool.data[idx], pool.scale[idx])
        return pool[idx]

    if not pools:
        return []
    idx = _ids(block_ids, _halves(pools[0][0])[0].device)
    return [(gx(kp, idx), gx(vp, idx)) for kp, vp in pools]


def import_blocks(pools, block_ids, payload):
    """Scatter an :func:`export_blocks` payload into the pools at
    ``block_ids``, in place (an int8 payload writes data and scales).
    Layer count and pool types must match the exporter's. Returns the
    (same) pools."""
    if len(payload) != len(pools):
        raise ValueError(
            f"import_blocks: payload has {len(payload)} layers, pool "
            f"has {len(pools)}")

    def sx(pool, rows, idx):
        if isinstance(pool, QuantKV):
            if not isinstance(rows, QuantKV):
                raise TypeError(
                    "import_blocks: int8 pool fed a non-quantized payload "
                    "(exporter and importer must share kv_cache_dtype)")
            pool.data[idx] = rows.data.to(pool.data.device)
            pool.scale[idx] = rows.scale.to(pool.scale.device)
            return
        if isinstance(rows, QuantKV):
            raise TypeError(
                "import_blocks: fp pool fed a quantized payload (exporter "
                "and importer must share kv_cache_dtype)")
        pool[idx] = rows.to(pool.device, pool.dtype)

    if not pools:
        return pools
    idx = _ids(block_ids, _halves(pools[0][0])[0].device)
    for (kp, vp), (kr, vr) in zip(pools, payload):
        sx(kp, kr, idx)
        sx(vp, vr, idx)
    return pools


def _payload_map(fn, payload):
    def one(x):
        if isinstance(x, QuantKV):
            return QuantKV(fn(x.data), fn(x.scale))
        return fn(x)

    return [(one(k), one(v)) for k, v in payload]


def payload_to_host(payload):
    """An :func:`export_blocks` payload copied into host memory (CPU
    tensors; an int8 payload keeps its :class:`QuantKV` shell). The copy
    waits for the gather, so a caller timing it measures the transfer."""
    return _payload_map(lambda x: x.cpu(), payload)


def payload_nbytes(payload) -> int:
    """Bytes of a payload (int8: data and scales)."""
    return sum((k.nbytes if isinstance(k, QuantKV) else _nbytes(k))
               + (v.nbytes if isinstance(v, QuantKV) else _nbytes(v))
               for k, v in payload)


def payload_rows(payload, n: int):
    """The first ``n`` block rows of a payload."""
    return _payload_map(lambda x: x[:n], payload)


def payload_pad(payload, m: int):
    """A payload zero-padded to ``m`` block rows (the inverse of
    :func:`payload_rows`)."""
    def pad(x):
        if x.shape[0] == m:
            return x
        return torch.cat([x, x.new_zeros((m - x.shape[0],)
                                         + tuple(x.shape[1:]))])

    return _payload_map(pad, payload)


class HostKVTier:
    """Host-memory block tier: an LRU, byte-bounded cache of payloads in
    host memory (:func:`payload_to_host`). Two kinds of entries share it:
    evicted published blocks (keyed ``("pub", content_hash)``, one block
    each, which a later prefix hit restores instead of prefilling) and
    preempted requests' blocks (keyed ``("victim", rid)``, which a swap
    resume imports back). Inserting past ``capacity_bytes`` drops the
    oldest entries; a dropped victim resumes by recompute. Counters:
    ``spills``, ``restores``, ``drops`` and the ``bytes_used`` gauge."""

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        if self.capacity <= 0:
            raise ValueError(
                f"HostKVTier needs a positive byte capacity, got "
                f"{capacity_bytes!r} (0 disables the tier: pass None to "
                "the engine instead)")
        self._items = OrderedDict()     # key -> (payload, nbytes)
        self.bytes_used = 0
        self.spills = 0                 # payloads accepted
        self.restores = 0               # payloads consumed by pop()
        self.drops = 0                  # payloads evicted or refused

    def __len__(self):
        return len(self._items)

    def __contains__(self, key):
        return key in self._items

    def put(self, key, payload, nbytes: int) -> bool:
        """Insert (or refresh) ``key``, dropping the oldest entries to
        fit. Returns False (a drop) when the payload alone exceeds the
        capacity."""
        nbytes = int(nbytes)
        if nbytes > self.capacity:
            self.drops += 1
            return False
        old = self._items.pop(key, None)
        if old is not None:
            self.bytes_used -= old[1]
        while self.bytes_used + nbytes > self.capacity and self._items:
            _, (_, nb) = self._items.popitem(last=False)
            self.bytes_used -= nb
            self.drops += 1
        self._items[key] = (payload, nbytes)
        self.bytes_used += nbytes
        self.spills += 1
        return True

    def get(self, key):
        """The payload of ``key`` (touched as most recent), or None; the
        entry stays."""
        it = self._items.get(key)
        if it is None:
            return None
        self._items.move_to_end(key)
        return it[0]

    def pop(self, key, restore: bool = True):
        """Remove and return ``key``'s payload (None when absent);
        ``restore=False`` discards it without counting a restore."""
        it = self._items.pop(key, None)
        if it is None:
            return None
        self.bytes_used -= it[1]
        if restore:
            self.restores += 1
        return it[0]

    def purge_published(self) -> int:
        """Drop every evicted published-block entry (keys ``("pub",
        hash)``); victims' entries stay. Returns the entries dropped."""
        keys = [k for k in self._items
                if isinstance(k, tuple) and k and k[0] == "pub"]
        for k in keys:
            _, nb = self._items.pop(k)
            self.bytes_used -= nb
            self.drops += 1
        return len(keys)


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
