"""Mixture-of-Experts dispatch on one device (counterpart of the
single-device forward of ``paddle_tpu/distributed/moe.py``).

Router -> expert-major grouping -> two grouped matmuls over stacked
SwiGLU experts (``gate_up [e, d, 2f]``, ``down [e, f, d]``) -> combine:

- routing: float32 softmax of the router logits, then the top ``k``
  experts of each token with ties going to the lower expert index (as
  ``lax.top_k``: a stable descending sort);
- grouping (:func:`_sort_pairs`): one stable argsort of the (token,
  slot) pairs by expert, its inverse by one int32 scatter, the counts
  by a scatter-add; the counts are the matmuls' group sizes as they
  stand (every pair has an expert: the sentinel pairs and the tail pad
  of the reference's expert-parallel buffers come with that slice);
- :func:`moe_dispatch_combine_dropless` keeps every pair;
  :func:`moe_dispatch_combine_grouped` keeps GShard's capacity rule
  (earlier pairs win an expert's ``ceil(cf * s * k / e)`` slots) and
  zero-gates the dropped pairs, running the same dropless total of
  rows through the matmuls;
- the fused path (``fused`` True or None, the default): the sort is the
  first matmul's gather-on-read and swiglu its epilogue
  (``gather_gmm_swiglu``), the unsort the second's scatter store
  (``scatter_gmm``), then ``sum_k gates * rows`` in ``x``'s dtype — K4;
- the sorted path (``fused=False``): gather, K5's ``gmm``,
  ``silu(g.float()).to(dtype) * u`` (rounded before the product, unlike
  the fused epilogue), ``gmm``, then the unsort — K5's forward gmm.

Both paths train. The fused core is the ``torch.autograd.Function``
:class:`_FusedMoeCore`, whose backward replays the forward's gather and
scatter structure (the reference's ``_fused_moe_bwd``): K4's transposed
gather for d(h), K5's ``tgmm`` for both weight gradients, the forward's
gather recomputing the gate/up projection, K4's transposed scatter for
d(x). The sorted path's grouped matmuls go through :class:`_Gmm` (the
reference's ``_gmm32`` custom VJP): d(lhs) by the transposed gmm, d(rhs)
by ``tgmm``. On the CPU the same Functions run the plain versions, so
the structure the CPU tests check is the one the card runs.

Everything stays on the device: nothing here reads a value back to the
host (no ``bincount``, ``.item()``, ``nonzero`` or mask indexing), in the
forward or in a backward, so an eager step of many MoE layers never
waits on routing: the kernels find their rows from ``group_sizes`` on
the device.

``MOE_STATS`` is a dict-shaped view with the reference's keys, served by
the metrics registry as the reference's (``moe_path_calls{path=...}``
gauge, ``moe_grouped_mm_kernel`` info): ``grouped_mm_calls`` (grouped
matmuls run), ``grouped_mm_kernel`` (``"fused_gmm"`` or ``"gmm"``: the
path the last dispatch took), ``ep_shard_map_calls`` and
``padded_einsum_calls`` (paths of later slices, always 0).
:func:`serving_stats_tap` lets the serving engine collect each
dispatch's per-expert counts on the device during a tick, and
:func:`serving_rows_mask` keeps a tick's parked rows out of them.

:class:`ClipGradForMOEByGlobalNorm` keeps the reference's constructor;
on one device its norm is the plain global norm.

Not in this slice (each raises ``NotImplementedError``): expert
parallelism over more than one process, GShard's random second-expert
routing (``rng_key``) and the padded ``moe_dispatch_combine``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from collections.abc import MutableMapping

import torch
import torch.nn.functional as F

from .. import monitor as _monitor
from ..nn.clip import ClipGradByGlobalNorm as _ClipGradByGlobalNorm
from ..ops.kernels import moe_gmm as _gmm

__all__ = ["moe_dispatch_combine", "moe_dispatch_combine_dropless",
           "moe_dispatch_combine_grouped", "moe_stats", "reset_moe_stats",
           "serving_stats_tap", "serving_rows_mask", "num_routed_experts",
           "capacity_routed",
           "ClipGradForMOEByGlobalNorm", "MOE_STATS"]

_moe_path_calls = _monitor.gauge(
    "moe_path_calls",
    "MoE dispatch path selections recorded at trace time",
    labels=("path",))
_moe_kernel_info = _monitor.info(
    "moe_grouped_mm_kernel",
    "last grouped-matmul kernel a compilation selected")


class _MoeStats(MutableMapping):
    """Dict-shaped view over the registry-backed MoE path counters (the
    reference's ``_MoeStats``)."""

    _COUNTER_KEYS = ("grouped_mm_calls", "ep_shard_map_calls",
                     "padded_einsum_calls")
    _KEYS = ("grouped_mm_calls", "grouped_mm_kernel",
             "ep_shard_map_calls", "padded_einsum_calls")

    def __getitem__(self, k):
        if k == "grouped_mm_kernel":
            return _moe_kernel_info.get()
        if k in self._COUNTER_KEYS:
            return int(_moe_path_calls.labels(path=k).value())
        raise KeyError(k)

    def __setitem__(self, k, v):
        if k == "grouped_mm_kernel":
            _moe_kernel_info.set(v)
        elif k in self._COUNTER_KEYS:
            _moe_path_calls.labels(path=k).set(int(v))
        else:
            raise KeyError(k)

    def __delitem__(self, k):
        raise TypeError("MOE_STATS keys are fixed")

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self):
        return len(self._KEYS)

    def __repr__(self):
        return repr(dict(self))


MOE_STATS = _MoeStats()
_TAP = threading.local()    # .sinks: lists collecting each dispatch's counts


class ClipGradForMOEByGlobalNorm(_ClipGradByGlobalNorm):
    """MoE-aware global-norm clip with the reference's constructor. The
    reference splits expert and other parameters so that, under expert
    parallelism, the expert set's norm can be summed over the MoE group;
    on one device the stacked experts are whole, so the plain global
    norm over every gradient is the same quantity (``is_expert_param_func``
    and ``moe_group`` are kept as metadata)."""

    def __init__(self, clip_norm, is_expert_param_func=None,
                 moe_group=None, group_name="default_moe_group"):
        super().__init__(clip_norm, group_name=group_name)
        self.is_expert_param_func = is_expert_param_func
        self.moe_group = moe_group


def reset_moe_stats():
    MOE_STATS.update(grouped_mm_calls=0, grouped_mm_kernel=None,
                     ep_shard_map_calls=0, padded_einsum_calls=0)


def moe_stats():
    return dict(MOE_STATS)


@contextlib.contextmanager
def serving_stats_tap(sink: list):
    """Within the context, every dispatch appends its per-expert pair
    counts (an int32 ``[e]`` tensor on the device) to ``sink``; the
    caller reads them back when it next synchronises. Armed per thread."""
    sinks = getattr(_TAP, "sinks", None)
    if sinks is None:
        sinks = _TAP.sinks = []
    sinks.append(sink)
    try:
        yield sink
    finally:
        sinks.pop()


@contextlib.contextmanager
def serving_rows_mask(mask):
    """Arm a per-row validity mask (``[s]`` bool on the device) for the
    dispatches inside the context: the counts :func:`serving_stats_tap`
    collects then count only the rows it keeps. A pipelined serving tick
    parks a finished slot's row, which still routes through the dispatch
    but is no traffic; the grouping itself is unchanged."""
    prev = getattr(_TAP, "rows_mask", None)
    _TAP.rows_mask = mask
    try:
        yield
    finally:
        _TAP.rows_mask = prev


def num_routed_experts(config) -> int:
    """Routed experts of a model config: Qwen2's ``num_experts`` or
    DeepSeek's ``n_routed_experts``; 0 for a dense model."""
    return int(getattr(config, "num_experts", 0)
               or getattr(config, "n_routed_experts", 0) or 0)


def capacity_routed(config) -> bool:
    """Whether ``config`` is an MoE that routes under a capacity (not
    ``dropless``): its tokens compete for expert slots, so a row's output
    depends on the other rows of the batch. The serving engine, prompt
    bucketing and speculative decoding exclude such a model."""
    return bool(num_routed_experts(config)) \
        and not getattr(config, "dropless", False)


def _later(what, slice_name):
    return NotImplementedError(
        f"{what} comes with the {slice_name} slice of the PyTorch port")


def _check_axis(expert_axis):
    """``expert_axis`` names a mesh axis in the reference; the port runs
    one process per device, so any name means one shard unless a process
    group of several ranks is live."""
    if expert_axis is None:
        return
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise _later(f"expert parallelism over {dist.get_world_size()} "
                     f"ranks (expert_axis={expert_axis!r})", "distribution")


def _top_k(probs, k):
    """``(values, indices)`` of the ``k`` largest per row, ties to the
    lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _sort_pairs(flat_e, e):
    """``(order, rank, counts)``: ``order[r]`` the pair at sorted
    position ``r`` (stable, expert-major), ``rank`` its inverse and
    ``counts[j]`` (int32) the pairs routed to expert ``j``."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=flat_e.device))
    counts = torch.zeros(e, dtype=torch.int32, device=flat_e.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    return order, rank, counts


def _grouped_mm_dlhs(dy, rhs, group_sizes):
    """d(lhs) of the grouped matmul: ``dy[r] @ rhs[g].T`` on sorted rows
    (K5's d(lhs), the transposed gmm)."""
    MOE_STATS["grouped_mm_calls"] += 1
    return _gmm.gather_gmm(dy, None, rhs, group_sizes, transpose_rhs=True)


def _grouped_mm_drhs(lhs, dy, group_sizes, num_groups):
    """d(rhs) of the grouped matmul: ``lhs[rows of g].T @ dy[rows of g]``
    for each group (K5's ``tgmm``), ``[e, K, N]``."""
    MOE_STATS["grouped_mm_calls"] += 1
    return _gmm.tgmm(lhs, dy, group_sizes, num_groups)


class _Gmm(torch.autograd.Function):
    """The sorted path's grouped matmul ``lhs [m, K] x rhs [e, K, N] ->
    [m, N]`` over the partition ``gs`` (K5's gmm), with its backward:
    d(lhs) by the transposed gmm and d(rhs) by ``tgmm``, each cast to its
    input's dtype (the reference's ``_gmm32`` custom VJP)."""

    @staticmethod
    def forward(ctx, lhs, rhs, gs):
        ctx.save_for_backward(lhs, rhs, gs)
        return _gmm.gather_gmm(lhs, None, rhs, gs)

    @staticmethod
    def backward(ctx, dy):
        lhs, rhs, gs = ctx.saved_tensors
        dy = dy.contiguous()
        dlhs = _grouped_mm_dlhs(dy, rhs, gs)
        drhs = _grouped_mm_drhs(lhs, dy, gs, rhs.shape[0])
        return dlhs.to(lhs.dtype), drhs.to(rhs.dtype), None


class _FusedMoeCore(torch.autograd.Function):
    """``y[s] = sum_k gates[s, k] * swiglu_expert(x[s])`` over the sorted
    partition ``gs`` with the sort fused into the first matmul's load
    (``src_rows = order // k``) and the unsort into the second's store
    (``order``). The backward replays that structure (the reference's
    ``_fused_moe_bwd``, step for step and with its roundings)."""

    @staticmethod
    def forward(ctx, x, gate_up, down, gates, order, src_rows, gs, top_k):
        h = _gmm.gather_gmm_swiglu(x, src_rows, gate_up.to(x.dtype), gs)
        ys_tok = _gmm.scatter_gmm(h, down.to(x.dtype), gs, order)
        ctx.top_k = top_k
        ctx.save_for_backward(x, gate_up, down, gates, order, src_rows, gs,
                              h, ys_tok)
        picked = ys_tok.reshape(x.shape[0], top_k, -1)
        return torch.einsum("sk,skd->sd", gates.to(x.dtype), picked)

    @staticmethod
    def backward(ctx, dy):
        x, gate_up, down, gates, order, src_rows, gs, h, ys_tok = \
            ctx.saved_tensors
        k = ctx.top_k
        (s, d), e = x.shape, gate_up.shape[0]
        dy = dy.contiguous()
        picked = ys_tok.reshape(s, k, d)
        dgates = torch.einsum("sd,skd->sk", dy.float(), picked.float())
        # the token-major pair cotangent; the first backward matmul
        # gathers it into sorted order on read, as src_rows did forward
        dpair_tok = (gates.to(dy.dtype)[..., None] * dy[:, None, :]) \
            .reshape(s * k, d)
        dh = _gmm.gather_gmm(dpair_tok, order, down.to(dy.dtype), gs,
                             transpose_rhs=True)
        ddown = _grouped_mm_drhs(h, dpair_tok[order.long()], gs, e)
        # the gate/up projection the forward never stored, recomputed
        gu = _gmm.gather_gmm(x, src_rows, gate_up.to(x.dtype), gs)
        g_a, u_a = gu.chunk(2, dim=-1)
        g32 = g_a.float()
        sig = torch.sigmoid(g32)
        dh32 = dh.float()
        dg = dh32 * u_a.float() * sig * (1 + g32 * (1 - sig))
        du = dh32 * (g32 * sig)
        dgu = torch.cat([dg, du], dim=-1).to(x.dtype)
        dguw = _grouped_mm_drhs(x[src_rows.long()], dgu, gs, e)
        # d(x) leaves the last backward matmul through its scatter store
        dx_tok = _gmm.scatter_gmm(dgu, gate_up.to(x.dtype), gs, order,
                                  transpose_rhs=True)
        dx = dx_tok.reshape(s, k, d).sum(dim=1)
        return (dx.to(x.dtype), dguw.to(gate_up.dtype),
                ddown.to(down.dtype), dgates.to(gates.dtype), None, None,
                None, None)


def _expert_swiglu_grouped(xs, gate_up, down, gs, dtype):
    """The sorted path's expert MLP: two grouped matmuls (K5's gmm,
    through :class:`_Gmm`) with ``silu(g.float()).to(dtype) * u`` between
    them."""
    gu = _Gmm.apply(xs, gate_up.to(dtype), gs)
    g, u = gu.chunk(2, dim=-1)
    h = F.silu(g.float()).to(dtype) * u
    return _Gmm.apply(h, down.to(dtype), gs)


def _grouped_dispatch(x, gate_logits, num_expert, top_k, gate_up, down, *,
                      capacity_factor, normalize_gates=True,
                      second_expert_policy="all", rng_key=None,
                      expert_axis=None, return_stats=False, fused=None):
    """Route -> group -> grouped expert matmuls -> combine; returns
    ``(y [s, d], aux)`` (+ ``{"drop_rate": ...}`` with
    ``return_stats``)."""
    _check_axis(expert_axis)
    if second_expert_policy == "random" and rng_key is not None \
            and top_k >= 2:
        raise _later("GShard random second-expert routing (rng_key)",
                     "expert parallelism and gates")
    s, d = x.shape
    e = int(num_expert)
    probs = torch.softmax(gate_logits.float(), dim=-1)
    topk_prob, topk_idx = _top_k(probs, top_k)                # [s, k]
    flat_e = topk_idx.reshape(-1)
    order, rank, counts = _sort_pairs(flat_e, e)
    sinks = getattr(_TAP, "sinks", ())
    if sinks:
        tap = counts
        mask = getattr(_TAP, "rows_mask", None)
        if mask is not None and mask.shape[0] * top_k == flat_e.shape[0]:
            kept = mask.to(torch.int32)[:, None].expand(-1, top_k)
            tap = torch.zeros(e, dtype=torch.int32, device=x.device) \
                .scatter_add_(0, flat_e, kept.reshape(-1))
        for sink in sinks:
            sink.append(tap)

    keep = None
    if capacity_factor is not None:
        c = max(int(math.ceil(capacity_factor * s * top_k / e)), 1)
        starts = torch.cumsum(counts, 0) - counts
        pos = (rank - starts[flat_e]).reshape(s, top_k)
        keep = pos < c
    gates = topk_prob
    if normalize_gates:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    if keep is not None:
        gates = torch.where(keep, gates, torch.zeros_like(gates))
    gates = gates.to(x.dtype)

    gs = counts                 # partitions all s * k sorted rows
    MOE_STATS["grouped_mm_calls"] += 2
    if fused is None or fused:
        MOE_STATS["grouped_mm_kernel"] = "fused_gmm"
        src_rows = torch.div(order, top_k, rounding_mode="floor")
        y = _FusedMoeCore.apply(x, gate_up, down, gates,
                                order.to(torch.int32),
                                src_rows.to(torch.int32), gs, top_k)
    else:
        MOE_STATS["grouped_mm_kernel"] = "gmm"
        xs = x[torch.div(order, top_k, rounding_mode="floor")]
        ys = _expert_swiglu_grouped(xs, gate_up, down, gs, x.dtype)
        picked = ys[rank].reshape(s, top_k, -1)
        y = torch.einsum("sk,skd->sd", gates, picked)

    # GShard load-balance aux (top-1 occupancy)
    me = probs.mean(0)
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).scatter_add_(
        0, topk_idx[:, 0], torch.ones(s, device=x.device)) / s
    aux = e * torch.sum(me * ce)
    if return_stats:
        drop = torch.zeros((), device=x.device) if keep is None \
            else 1.0 - keep.float().sum() / float(s * top_k)
        return y, aux, {"drop_rate": drop}
    return y, aux


def moe_dispatch_combine_dropless(x, gate_logits, num_expert, top_k,
                                  gate_up, down, normalize_gates=True,
                                  expert_axis=None, return_stats=False,
                                  fused=None):
    """Dropless dispatch -> SwiGLU experts -> combine. ``x [s, d]``,
    ``gate_logits [s, e]``, ``gate_up [e, d, 2f]``, ``down [e, f, d]``.
    Returns ``(y [s, d], aux)`` (+ stats with ``return_stats``). The
    reference's ``ep_buffer_factor`` sizes expert-parallel buffers and
    comes with that slice."""
    return _grouped_dispatch(
        x, gate_logits, num_expert, top_k, gate_up, down,
        capacity_factor=None, normalize_gates=normalize_gates,
        expert_axis=expert_axis, return_stats=return_stats, fused=fused)


def moe_dispatch_combine_grouped(x, gate_logits, num_expert, top_k,
                                 gate_up, down, capacity_factor=1.25,
                                 normalize_gates=True,
                                 second_expert_policy="all", rng_key=None,
                                 expert_axis=None, return_stats=False,
                                 fused=None):
    """GShard capacity semantics on the grouped matmuls: a pair past its
    expert's capacity keeps its row in the matmuls but combines with
    gate 0."""
    return _grouped_dispatch(
        x, gate_logits, num_expert, top_k, gate_up, down,
        capacity_factor=capacity_factor, normalize_gates=normalize_gates,
        second_expert_policy=second_expert_policy, rng_key=rng_key,
        expert_axis=expert_axis, return_stats=return_stats, fused=fused)


def moe_dispatch_combine(x, gate_logits, num_expert, top_k=2,
                         capacity_factor=1.25, expert_fn=None, **kwargs):
    """The padded ``[e, c, d]`` GShard dispatch with an arbitrary
    ``expert_fn`` (the reference's ``MoELayer`` path)."""
    raise _later("the padded GShard moe_dispatch_combine (expert_fn over "
                 "[e, c, d] buffers)", "expert parallelism and gates")
