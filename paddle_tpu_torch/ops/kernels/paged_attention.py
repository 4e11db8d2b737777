"""K2d and K2v — paged decode and speculative-verify attention: the CUDA
kernels (``csrc/paged_decode_attention.cu``; a bfloat16 ``q`` runs K2r's
Hopper body of ``csrc/paged_attention_sm90.cuh`` over any pools with a
window of T rows a slot, its scratch kept as K2r's) and their plain
PyTorch versions.

Counterparts of ``pallas_paged_attention`` (K2d: one query token per
slot, ``q [S, H, D]``) and ``pallas_paged_verify_attention`` (K2v: a
window of T query tokens per slot, ``q [S, T, H, D]``, a linear chain or
a token tree) in
``paddle_tpu/ops/pallas/paged_attention.py``. Both attend each slot's
blocks of the pool ``[NB, BS, H_kv, D]`` through ``block_tables [S, MB]``;
window token ``t`` of slot ``s`` sees the first ``context_lens[s] + t``
positions. A row that sees no position is 0.

K2v's token-tree mode (``tree_anc``, the reference's ``tree_bits``):
window node ``j`` sits at cache position ``context_lens - 1 + j``, and
row ``t`` sees the committed prefix and root (``col < context_lens``)
plus exactly its own ancestors in the window
(:func:`tree_ancestor_bits`). The ancestors of node ``t`` have ids of at
most ``t``, so the tree mask is a subset of the linear bound; a chain
tree ``tuple(range(gamma))`` is the linear bound itself. The wrapper
reads the ambient :func:`spec_tree_scope` by default, so model forwards
stay untouched; its launches are counted as
``paged_verify_attention_tree`` (``_tree_int8`` on int8 pools).

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

A bfloat16 ``q`` over float32 pools (GPT's: the reference keeps its
pools float32 whatever the model's dtype) follows the TPU kernel's
recipe on those inputs: float32 scores, softmax and P (the kernel casts
P to V's dtype, float32) into the product with the float32 V, the output
rounded to bfloat16; the Hopper body holds it with K, V and P split into
bfloat16 hi + lo halves (K2r's module docstring). Its launches are
counted as
``paged_decode_attention_f32pool`` / ``paged_verify_attention_f32pool``
(``paged_verify_attention_tree_f32pool`` in the tree mode). The plain
versions hold that recipe in this case (the products in the pool's
dtype), where the reference's gather fallback rounds K, V and P to the
query's dtype.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import torch

from ...monitor.accounting import declares
from . import _build, launch_counts, no_backward
from ..paged_cache import QuantKV, gather_dense
from .ragged_paged_attention import (SM90_MAX_SLOTS, dtype_code,
                                     pool_bytes_per_pos,
                                     pool_operands, sm_count,
                                     sm90_blocks_per_sm, sm90_scratch,
                                     sm90_scratch_sizes, tree_ancestor_bits)

__all__ = ["paged_decode_attention", "paged_verify_attention",
           "plain_paged_decode_attention", "plain_paged_verify_attention",
           "tree_ancestor_bits", "spec_tree_scope"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None
# The shapes the kernels take. Both bodies: a window of at most MAX_T
# tokens (a tree's 31 drafts + the root fill the 32 ancestor bits) and a
# GQA group of at most MAX_Q query heads. float32 (the FMA body): one
# block holds a kv group's T * group <= MAX_Q query vectors. A bfloat16 q
# (the Hopper body, over any pools): a window of more than MAX_Q // group
# rows takes several 64-vector tiles, so it has no such product bound.
MAX_Q = 64
MAX_T = 32
# float32: the context's split over SMs
SPLIT_POSITIONS = 64      # fewest context positions worth a split
MAX_SPLITS = 16           # the kernel's MAX_SPLITS; it refuses more
BLOCKS_PER_SM = 8


_SPEC_TREE = threading.local()    # a scope a thread
_AMBIENT = object()               # "read the ambient scope"


@contextlib.contextmanager
def spec_tree_scope(tree_anc, tree_slots=None, tree_rows=None):
    """Arm the token-tree verify mask for the calls inside the scope:
    :func:`paged_verify_attention` and the ragged attention step (and the
    paged attention step above K2v) read it when they run, so model
    forwards stay untouched. ``tree_anc`` is the parent tuple (None
    disarms); ``tree_slots`` an optional int32 ``[S]`` tensor on the
    attention's device naming the slots whose rows are a tree window
    (``> 0``) in a ragged tick, whose other slots (prefill chunks and
    their trickle rows) keep the linear bound; None: every slot.
    ``tree_rows`` (a host int) bounds the flagged slots' rows in a ragged
    tick (None: the tick's ``w_max``). K2v masks every window by the tree
    whatever the flags. Thread-local: a tree verify on one thread never
    arms another's."""
    prev = getattr(_SPEC_TREE, "ctx", None)
    _SPEC_TREE.ctx = (None if tree_anc is None
                      else tuple(int(p) for p in tree_anc), tree_slots,
                      tree_rows)
    try:
        yield
    finally:
        _SPEC_TREE.ctx = prev


def _tree_ctx():
    """``(parent tuple, tree slots, tree rows)`` of the innermost
    :func:`spec_tree_scope`, or ``(None, None, None)`` outside one."""
    ctx = getattr(_SPEC_TREE, "ctx", None)
    return (None, None, None) if ctx is None else ctx


def window_tree(tree_anc, t):
    """The tree a window of ``t`` rows carries: ``tree_anc``, read from
    the ambient scope when it is the default, or None where its length
    + 1 is not ``t`` (not a verify window: the linear bound stands)."""
    if tree_anc is _AMBIENT:
        tree_anc = _tree_ctx()[0]
    if tree_anc is not None and len(tree_anc) + 1 != t:
        return None
    return tree_anc


def plain_paged_verify_attention(q, k_pool, v_pool, block_tables,
                                 context_lens, sm_scale=None,
                                 tree_anc=None):
    """``q [S, T, H, D]`` -> ``[S, T, H, D]``; token ``t`` sees
    ``context_lens + t`` positions, or with ``tree_anc`` (a parent tuple
    of T - 1 nodes) the committed prefix and its ancestors in the window
    (the reference's ``_xla_paged_verify`` tree mask, op for op)."""
    s, t, h, d = q.shape
    hkv = k_pool.shape[2]
    rep = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    # the products' dtype: the pool's (q's own, or float32 pools under a
    # bfloat16 q: the kernel's recipe); int8 pools: float32 through both
    # products (the reference's recipe)
    ad = torch.float32 if isinstance(k_pool, QuantKV) else k_pool.dtype
    k = gather_dense(k_pool, block_tables)          # [S, L, Hkv, D]
    v = gather_dense(v_pool, block_tables)
    q6 = q.reshape(s, t, hkv, rep, d)
    scores = torch.einsum("stgrd,slgd->sgtrl", q6.float(),
                          k.to(ad).float()) * scale
    pos = torch.arange(k.shape[1], device=q.device)
    lens = context_lens.long()
    bound = lens[:, None] + torch.arange(t, device=q.device)
    allow = pos[None, None, :] < bound[:, :, None]            # [S, T, L]
    if tree_anc is not None:
        bits = tree_ancestor_bits(tree_anc)
        if len(bits) != t:
            raise ValueError(
                f"spec tree has {len(bits)} nodes but the verify window "
                f"carries {t} rows")
        bits_a = torch.tensor(bits, dtype=torch.int64, device=q.device)
        rel = pos[None, None, :] - lens[:, None, None]
        bit = (bits_a[None, :, None] >> torch.clamp(rel, 0, 31)) & 1
        allow = (rel < 0) | (bit > 0)
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
        args = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.ptt_paged_decode_attention,
                   lib.ptt_paged_verify_attention):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        # + the window's T ancestor bitmasks (a host array)
        lib.ptt_paged_verify_attention_tree.argtypes = args \
            + [ctypes.POINTER(ctypes.c_uint32)]
        lib.ptt_paged_verify_attention_tree.restype = ctypes.c_int
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
    if h % hkv or h // hkv > MAX_Q:
        raise ValueError(f"{h} query heads over {hkv} kv heads: need a "
                         f"whole group of at most {MAX_Q}")
    code = dtype_code(q4, kd)[0]
    if code == 0 and t * (h // hkv) > MAX_Q:
        raise ValueError(f"{h // hkv} query heads a kv head at T {t}: the "
                         f"float32 body takes T * group <= {MAX_Q}")
    if block_tables.dim() != 2 or block_tables.shape[0] != s \
            or tuple(context_lens.shape) != (s,):
        raise ValueError("block_tables must be [S, MB] and context_lens [S]")
    if q4.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    if code != 0 and s > SM90_MAX_SLOTS:
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
            context_lens, sm_scale, tree_anc=None):
    """Check and launch; a launch adds one to ``launch_counts[counter]``
    (``counter + "_int8"`` on int8 pools). ``tree_anc``: K2v's tree mode
    (a parent tuple of T - 1 nodes), counted as ``counter + "_tree"``."""
    tree = ()
    if tree_anc is not None:
        bits = tree_ancestor_bits(tree_anc)
        entry, counter = entry + "_tree", counter + "_tree"
        tree = ((ctypes.c_uint32 * len(bits))(*bits),)
    kd, vd, ks, vs = _check(q4, k_pool, v_pool, block_tables, context_lens)
    s, t, h, d = q4.shape
    nb, bs, hkv, _ = kd.shape
    mb = block_tables.shape[1]
    out = torch.empty_like(q4)
    if s == 0:
        return out
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    code, mode = dtype_code(q4, kd)
    if code != 0:
        n_split, floats, counters = sm90_scratch_sizes(
            s, hkv, h // hkv, t, d, sm_count(q4.device),
            sm90_blocks_per_sm(code, d))
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
        float(scale), code, stream, *tree)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed (cudaError {rc})")
    launch_counts[counter + ("_int8" if ks is not None else mode)] += 1
    return out


def _paged_work(counter, q4, k_pool, v_pool, block_tables, context_lens,
                tree_anc=None):
    """One K2d / K2v call's bound over a window of T rows a slot, from
    this call's lengths: K and V over each slot's ``context + T - 1``
    positions (at most the table's reach), q read and the output
    written, tables and lengths; 4 x D operations a visible pair a query
    head."""
    kd, _, ks, _ = pool_operands(q4, k_pool, v_pool)
    s, t, h, d = q4.shape
    nb, bs, hkv, _ = kd.shape
    n = context_lens.long()
    kv_pos = (n + t - 1).clamp(max=block_tables.shape[1] * bs).sum()
    vis = (t * n + t * (t - 1) // 2).sum()
    mode = dtype_code(q4, kd)[1]
    name = counter + ("_tree" if tree_anc is not None else "") \
        + ("_int8" if ks is not None else mode)
    nbytes = 2 * kv_pos * hkv * pool_bytes_per_pos(q4, k_pool, v_pool) \
        + 2 * q4.numel() * q4.element_size() \
        + 4 * (block_tables.numel() + s + (t if tree_anc is not None
                                           else 0))
    return name, 4 * vis * h * d, nbytes


def _decode_work(q, k_pool, v_pool, block_tables, context_lens,
                 sm_scale=None):
    return _paged_work("paged_decode_attention", q[:, None], k_pool,
                       v_pool, block_tables, context_lens)


def _verify_work(q, k_pool, v_pool, block_tables, context_lens,
                 sm_scale=None, tree_anc=_AMBIENT):
    return _paged_work("paged_verify_attention", q, k_pool, v_pool,
                       block_tables, context_lens,
                       window_tree(tree_anc, q.shape[1]))


@no_backward("paged_decode_attention (K2d)")
@declares(_decode_work)
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
@declares(_verify_work)
def paged_verify_attention(q, k_pool, v_pool, block_tables, context_lens,
                           sm_scale=None, tree_anc=_AMBIENT):
    """K2v: ``q [S, T, H, D]`` -> ``[S, T, H, D]``. ``tree_anc`` (a
    parent tuple) masks every slot's window by ancestor path; by default
    it is read from the ambient :func:`spec_tree_scope`, and a tree whose
    length + 1 is not T leaves the linear bound. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}: want [S, T, H, D]")
    tree_anc = window_tree(tree_anc, q.shape[1])
    if q.device.type == "cpu":
        return plain_paged_verify_attention(q, k_pool, v_pool, block_tables,
                                            context_lens, sm_scale=sm_scale,
                                            tree_anc=tree_anc)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch("ptt_paged_verify_attention", "paged_verify_attention",
                   q, k_pool, v_pool, block_tables, context_lens, sm_scale,
                   tree_anc)
