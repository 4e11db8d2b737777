"""Batched multi-LoRA serving: per-row adapter deltas through K4's grouped
matmuls (counterpart of ``paddle_tpu/ops/lora.py``).

One serving tick packs rows of many tenants; row ``r`` of the packed
``[R, d]`` activations carries the adapter of the slot that owns it. The
delta is the low-rank update ``y += (x @ A_g) @ B_g * alpha / rank`` with
``g`` varying per row: the MoE dispatch's shape, so it runs on K4's
float32 modes (``ops/kernels/moe_gmm.py``): the rows sorted by adapter
form the group partition, ``gather_gmm`` reads each row straight out of
the unsorted activations (gather on read), ``scatter_gmm`` stores each
row back at its packed position (scatter on write). On a CUDA tensor
both launch the kernel or raise; on the CPU they take their plain
versions.

- :class:`AdapterPool`: the host registry of every adapter's float32 A /
  B pairs and, per target module, one device stack of ``max_resident +
  1`` rows, row 0 the all-zero null adapter. Rows are an LRU window over
  the registry, pinned by refcounts while a request uses them. The
  stacks are allocated once and written in place (a captured CUDA graph
  reads them by address); they hold the rank padded up to a multiple of
  8 (the kernel reads 16-byte rows), with zero columns of A and zero
  rows of B, so the padded terms add exact zeros. ``quant=True`` keeps
  int8 stacks with one absmax scale a matrix, dequantized in the tick.
- :func:`tag_modules`: stamps ``_lora_slot`` on the model's target
  projections, in the order of the reference's walk.
- :func:`serving_lora_scope`: the thread-local scope the engine enters
  around the target model's forward; it sorts the tick's rows by adapter
  once, for every projection of the tick.
- :func:`apply`: the projection hook (``nn.Linear.forward`` calls it):
  a no-op outside a scope, on untagged modules and on activations that
  are not the tick's packed rows, else ``y + delta``.
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..framework.place import resolve_device
from .kernels import moe_gmm as _mg

__all__ = ["ATTN_TARGETS", "MLP_TARGETS", "tag_modules", "AdapterPool",
           "serving_lora_scope", "armed", "apply", "sort_rows",
           "ragged_delta", "plain_ragged_delta", "padded_rank",
           "prefix_seed"]

# the leaf names of the target projections: attention always, the MLP
# under targets="all" (Llama / Qwen2 q/k/v/o and gate/up/down; GPT's
# fused qkv_proj, out_proj and linear1 / linear2)
ATTN_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                "qkv_proj", "out_proj")
MLP_TARGETS = ("gate_proj", "up_proj", "down_proj", "linear1", "linear2")


def padded_rank(rank: int) -> int:
    """The rank the device stacks hold: ``rank`` up to a multiple of 8,
    the smallest width K4 takes for K (the B side) and N (the A side)."""
    return -(-int(rank) // 8) * 8


def _sublayers(model):
    """``(qualified name, module)`` in the reference's ``named_sublayers()``
    order: a depth-first walk that names a module's children, the last
    registered first, when it takes that module off its stack."""
    stack = [("", model)]
    while stack:
        pfx, layer = stack.pop()
        for name, sub in reversed(list(layer._modules.items())):
            if sub is None:
                continue
            qual = f"{pfx}.{name}" if pfx else name
            yield qual, sub
            stack.append((qual, sub))


def tag_modules(model, targets: str = "attn"):
    """Stamp ``_lora_slot`` (the module's index into the adapter stacks)
    on every target projection of ``model`` and return the spec list
    ``[(qualified_name, leaf, d_in, d_out), ...]`` in the order of the
    reference's walk, so the two packages stack modules alike. A
    non-target module of a target name (an MLP projection under
    ``"attn"``) has a stamp from an earlier engine cleared."""
    names = set(ATTN_TARGETS)
    if targets == "all":
        names |= set(MLP_TARGETS)
    elif targets != "attn":
        raise ValueError(
            f"lora_targets must be 'attn' or 'all', got {targets!r}")
    all_names = set(ATTN_TARGETS) | set(MLP_TARGETS)
    specs = []
    for qual, layer in _sublayers(model):
        leaf = qual.rsplit(".", 1)[-1]
        w = getattr(layer, "weight", None)
        if leaf not in all_names or w is None or w.dim() != 2:
            continue
        if leaf in names:
            layer._lora_slot = len(specs)
            specs.append((qual, leaf, int(w.shape[0]), int(w.shape[1])))
        else:
            layer._lora_slot = None
    return specs


def prefix_seed(fingerprint: bytes, adapter_id, generation: int) -> bytes:
    """The prefix cache's hash seed for a request under ``adapter_id``
    (a base request keeps the model's ``fingerprint``): one that also
    names the adapter and the ``generation`` of its weights, so blocks
    computed under one adapter (or an adapter's earlier weights) are
    never reused under another."""
    tag = np.asarray([int(adapter_id), int(generation)], np.int64)
    return hashlib.blake2b(fingerprint + b"lora" + tag.tobytes(),
                           digest_size=16).digest()


class AdapterPool:
    """The host registry of adapters and their device-resident LRU
    window (the reference's ``AdapterPool``, device stacks written in
    place).

    ``register`` keeps every adapter's float32 ``(A [d, rank], B [rank,
    out])`` pairs on the host for good. ``acquire`` pins an adapter into
    one of the ``max_resident`` rows of every module's stack (row 0 is
    the null adapter), loading it into a free or the least recently used
    unpinned row, and returns that row; None when every row is pinned.
    ``release`` unpins; ``evict`` drops an unpinned adapter and refuses a
    pinned one. ``swaps`` counts the resident adapters dropped for room
    or by ``evict``; ``version`` moves with every stack write.
    """

    def __init__(self, specs, rank: int, alpha=None, max_resident: int = 8,
                 quant: bool = False, device=None):
        if rank <= 0:
            raise ValueError(f"lora rank must be positive, got {rank}")
        if max_resident < 1:
            raise ValueError(
                f"max_adapters (resident budget) must be >= 1, got "
                f"{max_resident}")
        self.specs = list(specs)
        self.rank = int(rank)
        self.rank_padded = padded_rank(rank)
        self.alpha = float(rank if alpha is None else alpha)
        self.scaling = self.alpha / self.rank
        self.max_resident = int(max_resident)
        self.quant = bool(quant)
        self.device = resolve_device(device)
        self.version = 0
        self.swaps = 0
        self._host = {}                     # aid -> [(A, B) | None]
        self._gen = {}                      # aid -> registrations
        self._resident = OrderedDict()      # aid -> row (LRU order)
        self._refs = {}                     # aid -> pins
        n, rp, dev = self.max_resident + 1, self.rank_padded, self.device
        stacks = []
        for (_, _, d, out) in self.specs:
            if self.quant:
                stacks.append((
                    torch.zeros(n, d, rp, dtype=torch.int8, device=dev),
                    torch.ones(n, 1, 1, dtype=torch.float32, device=dev),
                    torch.zeros(n, rp, out, dtype=torch.int8, device=dev),
                    torch.ones(n, 1, 1, dtype=torch.float32, device=dev)))
            else:
                stacks.append((
                    torch.zeros(n, d, rp, dtype=torch.float32, device=dev),
                    torch.zeros(n, rp, out, dtype=torch.float32,
                                device=dev)))
        self._stacks = tuple(stacks)

    # -- the host registry -------------------------------------------------
    def register(self, adapter_id, weights) -> int:
        """Install (or replace) adapter ``adapter_id``: ``weights`` maps
        target names, qualified (``llama.layers.0.self_attn.q_proj``) or
        leaf (``q_proj``, every layer's), to ``(A [d, rank], B [rank,
        out])``; a module it does not name gets an exact-zero delta. A
        resident adapter's rows are rewritten in place at once."""
        aid = int(adapter_id)
        mats, used = [], set()
        for (qual, leaf, d, out) in self.specs:
            key = qual if qual in weights else (
                leaf if leaf in weights else None)
            if key is None:
                mats.append(None)
                continue
            used.add(key)
            A = np.asarray(weights[key][0], np.float32)
            B = np.asarray(weights[key][1], np.float32)
            if A.shape != (d, self.rank) or B.shape != (self.rank, out):
                raise ValueError(
                    f"adapter {aid}: {qual} expects A {(d, self.rank)} "
                    f"/ B {(self.rank, out)}, got {A.shape} / {B.shape}")
            mats.append((A, B))
        unknown = set(weights) - used
        if unknown:
            raise ValueError(
                f"adapter {aid}: no target module matches "
                f"{sorted(unknown)}")
        self._host[aid] = mats
        self._gen[aid] = self._gen.get(aid, 0) + 1
        if aid in self._resident:
            self._write_row(self._resident[aid], mats)
        return aid

    def known(self, adapter_id) -> bool:
        return int(adapter_id) in self._host

    def generation(self, adapter_id) -> int:
        """How many times ``adapter_id`` was registered (its weights'
        generation, which the prefix cache's keys name)."""
        return self._gen.get(int(adapter_id), 0)

    def refcount(self, adapter_id) -> int:
        return self._refs.get(int(adapter_id), 0)

    def resident(self, adapter_id) -> bool:
        return int(adapter_id) in self._resident

    # -- residency ---------------------------------------------------------
    def acquire(self, adapter_id):
        """Pin ``adapter_id`` resident and return its stack row (fixed
        while pinned); None when every row is pinned by other adapters."""
        aid = int(adapter_id)
        if aid not in self._host:
            raise KeyError(f"unknown adapter_id {aid}")
        if aid in self._resident:
            self._resident.move_to_end(aid)
            self._refs[aid] = self._refs.get(aid, 0) + 1
            return self._resident[aid]
        row = self._free_row()
        if row is None:
            return None
        self._write_row(row, self._host[aid])
        self._resident[aid] = row
        self._refs[aid] = 1
        return row

    def release(self, adapter_id):
        """Drop one pin; the adapter stays resident, an eviction candidate
        at no pins."""
        aid = int(adapter_id)
        n = self._refs.get(aid, 0)
        if n > 0:
            self._refs[aid] = n - 1

    def evict(self, adapter_id):
        """Drop ``adapter_id`` from the resident window; refused while a
        request pins it (its slot would gather another tenant's row)."""
        aid = int(adapter_id)
        if aid not in self._resident:
            return
        n = self._refs.get(aid, 0)
        if n > 0:
            raise ValueError(
                f"adapter {aid} is pinned by {n} in-flight request(s); "
                "eviction mid-request is blocked")
        del self._resident[aid]
        self._refs.pop(aid, None)
        self.swaps += 1

    def _free_row(self):
        used = set(self._resident.values())
        for row in range(1, self.max_resident + 1):
            if row not in used:
                return row
        victim = next((a for a in self._resident
                       if self._refs.get(a, 0) == 0), None)
        if victim is None:
            return None
        row = self._resident.pop(victim)
        self._refs.pop(victim, None)
        self.swaps += 1
        return row

    def _write_row(self, row, mats):
        """Write ``mats`` into stack row ``row`` of every module, in place,
        on the current stream (after the ticks already queued there); the
        padded rank's columns of A and rows of B stay zero."""
        r = self.rank
        for stacks, mat in zip(self._stacks, mats):
            if self.quant:
                ad, asc, bd, bsc = stacks
                if mat is None:
                    for t, v in ((ad, 0), (asc, 1.0), (bd, 0), (bsc, 1.0)):
                        t[row].fill_(v)
                    continue
                A, B = mat
                sa = float(np.max(np.abs(A))) / 127.0 or 1.0
                sb = float(np.max(np.abs(B))) / 127.0 or 1.0
                ad[row, :, :r].copy_(torch.from_numpy(np.clip(
                    np.round(A / sa), -127, 127).astype(np.int8)))
                bd[row, :r].copy_(torch.from_numpy(np.clip(
                    np.round(B / sb), -127, 127).astype(np.int8)))
                asc[row].fill_(sa)
                bsc[row].fill_(sb)
            else:
                a_stack, b_stack = stacks
                if mat is None:
                    a_stack[row].zero_()
                    b_stack[row].zero_()
                else:
                    a_stack[row, :, :r].copy_(torch.from_numpy(mat[0]))
                    b_stack[row, :r].copy_(torch.from_numpy(mat[1]))
        self.version += 1

    # -- the operand and accounting ------------------------------------------
    def operand(self):
        """One tuple per target module: ``(A, B)`` float32 stacks ``[n, d,
        rank_padded]`` / ``[n, rank_padded, out]``, or ``(A_q, A_scale,
        B_q, B_scale)`` under int8 quant. The same tensors for the pool's
        life."""
        return self._stacks

    @property
    def n_resident(self) -> int:
        return len(self._resident)

    @property
    def host_tier_bytes(self) -> int:
        """Bytes of the registered adapters not resident (float32, at
        their rank)."""
        total = 0
        for aid, mats in self._host.items():
            if aid in self._resident:
                continue
            for mat in mats:
                if mat is not None:
                    total += mat[0].nbytes + mat[1].nbytes
        return total


# ---------------------------------------------------------------------------
# the tick's scope and the projection hook
# ---------------------------------------------------------------------------

_SCOPE = threading.local()


class _Tick:
    """An armed scope: the stacks, each packed row's stack row, the
    scale, and the rows sorted by adapter (``order`` int32 ``[R]``,
    ``sizes`` int32 ``[groups]``), computed once for every projection."""
    __slots__ = ("operands", "row_adapter", "scaling", "order", "sizes")

    def __init__(self, operands, row_adapter, scaling):
        self.operands = operands
        self.row_adapter = row_adapter
        self.scaling = float(scaling)
        self.order, self.sizes = sort_rows(row_adapter,
                                           operands[0][0].shape[0])


def sort_rows(row_adapter, n_groups):
    """``(order, sizes)``: the rows' stable order by adapter (int32) and
    each group's row count (int32 ``[n_groups]``). Counted by a scatter
    into a fixed-size tensor: nothing is read back, so a CUDA graph can
    hold it."""
    ra = row_adapter.long()
    order = torch.argsort(ra, stable=True).to(torch.int32)
    sizes = torch.zeros(n_groups, dtype=torch.int32, device=ra.device)
    sizes.scatter_add_(0, ra, torch.ones_like(ra, dtype=torch.int32))
    return order, sizes


@contextlib.contextmanager
def serving_lora_scope(operands, row_adapter, scaling):
    """Arm the per-row delta for the calls inside the scope: ``operands``
    is :meth:`AdapterPool.operand`, ``row_adapter`` an integer ``[R]``
    tensor naming each packed row's stack row (0: the null adapter),
    ``scaling`` ``alpha / rank``. Thread-local, as ``spec_tree_scope``."""
    prev = getattr(_SCOPE, "ctx", None)
    _SCOPE.ctx = _Tick(operands, row_adapter, scaling)
    try:
        yield
    finally:
        _SCOPE.ctx = prev


def armed(module) -> bool:
    """Is ``module`` a tagged target inside an active scope? The fused
    decode layers branch on it."""
    return (getattr(_SCOPE, "ctx", None) is not None
            and getattr(module, "_lora_slot", None) is not None)


def plain_ragged_delta(rows, row_adapter, A, B):
    """The per-row delta ``(rows[i] @ A[g_i]) @ B[g_i]``, float32 and
    unscaled, by the reference's stacked gather and two einsums."""
    ra = row_adapter.long()
    ax = torch.einsum("rd,rdk->rk", rows, A[ra])
    return torch.einsum("rk,rko->ro", ax, B[ra])


def ragged_delta(rows, row_adapter, A, B, sort=None):
    """The per-row delta of :func:`plain_ragged_delta` through K4: the
    gather-on-read grouped matmul of the rows by adapter against ``A
    [G, d, r]``, then the scatter-on-write one against ``B [G, r, out]``
    back to the rows' order. ``rows [R, d]`` float32; ``sort``:
    :func:`sort_rows`'s ``(order, sizes)`` when already computed. Counted
    as ``lora_gmm`` and ``lora_scatter_gmm``."""
    order, sizes = sort if sort is not None else sort_rows(
        row_adapter, A.shape[0])
    ax = _mg.gather_gmm(rows, order, A, sizes, count="lora_gmm")
    return _mg.scatter_gmm(ax, B, sizes, order, count="lora_scatter_gmm")


def apply(module, x, y):
    """The projection hook: ``y + delta(x)`` for a tagged ``module`` in an
    active scope, else ``y``. The delta is float32 and unscaled, then
    times the scale, then cast to ``y``'s dtype and added, in the
    reference's order. Activations whose leading dims do not multiply to
    the scope's rows (or widths other than the module's) pass
    unchanged."""
    ctx = getattr(_SCOPE, "ctx", None)
    idx = getattr(module, "_lora_slot", None)
    if ctx is None or idx is None:
        return y
    mod = ctx.operands[idx]
    quant = len(mod) == 4
    d = mod[0].shape[1]
    out = (mod[2] if quant else mod[1]).shape[2]
    n_rows = ctx.row_adapter.shape[0]
    if x.shape[:-1].numel() != n_rows or x.shape[-1] != d \
            or y.shape[-1] != out:
        return y
    if quant:
        A = mod[0].float() * mod[1]
        B = mod[2].float() * mod[3]
    else:
        A, B = mod
    rows = x.reshape(n_rows, d).float().contiguous()
    delta = ragged_delta(rows, ctx.row_adapter, A, B,
                         sort=(ctx.order, ctx.sizes)) * ctx.scaling
    return y + delta.reshape(*x.shape[:-1], out).to(y.dtype)
