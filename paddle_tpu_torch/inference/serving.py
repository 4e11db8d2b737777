"""Continuous-batching serving engine, core slice (counterpart of
``paddle_tpu/inference/serving.py``'s ragged engine).

One engine tick packs every live query row into ONE ragged batch: each
decoding slot gives one row; pending prompts share the tick's prefill
row budget, with one slot at the chunk width and the others trickling at
one row, exactly as the reference schedules them. The model runs the
packed rows once; each slot's continuation row is sampled; the host then
commits tokens, prefill progress and retirements.

Admission takes the highest priority class first, FIFO within a class,
when the pool covers the request's worst case (prompt + max_new_tokens)
on top of every seated slot's reservation; with preemption on
(``ServingConfig(enable_preemption=True)``, the default) it may also
overcommit the pool down to ``admission_watermark_blocks`` of headroom.
Under slot or block pressure a lower-priority slot is preempted: its
full blocks are published into the prefix cache, its live blocks are
copied into the host KV tier (:class:`~paddle_tpu_torch.ops.paged_cache.
HostKVTier`), and it is queued again at the front of its class with its
continuation, to resume by importing those bytes (swap) or by
re-prefilling what the prefix cache lost (recompute), token-exact either
way. ``submit(max_queue_wait_ms=)`` bounds a request's queue wait,
``shed_queue_depth`` refuses arrivals at the front door
(:class:`QueueShedError`), and ``cancel()`` ends a request anywhere in
its life.

The prefix cache (``enable_prefix_cache=True``, the default) publishes a
retired or preempted sequence's full blocks under content hashes; a
later prompt maps its longest published prefix into its table and
prefills only the rest, copying a shared block before it appends into
it. Every move of pool bytes (a copy, an import, a restore) writes the
pools in place, so a captured tick reads what it moved.

Each tick with a prefill row packs to the reference's static width
(``num_slots * (gamma + 1) + ragged_prefill_rows`` rows, a slot's
window at most the widest prefill chunk): pad rows carry the pad token,
slot 0 and the overflow position, so their K/V writes go to the null
block, and the MoE telemetry does not count them. A *pure* tick (each
seated slot decodes or verifies, no prefill row) keeps its packed live
rows. On CUDA every tick replays a CUDA graph captured at the first
tick of its layout: one graph for each number of seated slots of a pure
tick, one for each number of verifying slots of a tick with prefill rows
(a non-speculating engine has one), so a replay runs the eager tick's
width, kernels and operands and is bit for bit that tick; the draft
model's prime and loop, the forward, the sampling or acceptance, the
draft heads and the async carry are all inside it. Every tick on the
CPU runs eagerly. ``stats()["executables_compiled"]`` counts the graphs
captured.

``ServingConfig(async_depth=1)`` arms the reference's depth-1 async
pipeline: a pure decode tick also writes the next tick's packs (each
slot's token, length + 1, budget - 1, and a ``done`` mask that parks a
slot finished by EOS at the overflow position, whose K/V write goes to
the null block) over its own inputs, and while the composition stays
unchanged the next tick is dispatched from that carry before this one's
tokens are committed; its tokens come back through a non-blocking copy
into pinned memory. Any change of composition flushes the pipeline
first, so the streams equal the synchronous engine's.
``stats()["host_gap_ms"]`` digests the host time between dispatches.

Mixture-of-Experts models (Qwen2-MoE, DeepSeek-MoE) serve when their
routing is dropless; ``stats()`` then reports the routing of the tick's
sparse layers from their device-side expert counts, read back once per
tick together with the tick's tokens.

``ServingConfig(kv_cache_dtype="int8")`` serves from int8 pools
(:class:`~paddle_tpu_torch.ops.paged_cache.QuantKV`: ~0.53x the bf16
pool's bytes): each tick's K/V rows are quantized as they are stored,
and K2r reads the int8 pages. ``stats()`` reports ``kv_cache_dtype``,
``kv_pool_bytes`` (data and scales, every layer) and
``kv_bytes_per_step`` (the last tick's attended positions times the
bytes a cached position costs), whatever the pool.

Speculative decoding (``ServingConfig(num_speculative_tokens=gamma)``)
runs in the same tick: each decoding slot packs its window ``[last
token, gamma drafts]`` as ``gamma + 1`` rows beside the prefill rows,
the model verifies every window in that one ragged forward, and each
slot commits 1 to ``gamma + 1`` tokens; the rejected tail is rolled back
by not advancing the slot's length. Drafters (``drafter``): ``"ngram"``
(prompt lookup over the slot's history), ``"model"`` (a smaller
``draft_model`` whose pools share the engine's block tables: its cache
is primed over the tick's prefill rows by its ragged forward, then its
``gamma + 1`` decode steps run through K2d), or, with ``spec_tree`` (a
parent tuple of gamma nodes), a token tree filled by the top-k n-gram
chains (``"ngram"``) or by Medusa-style draft heads (``"heads"``: one
float32 ``[hidden, vocab]`` projection a tree depth over the final
hidden state of the accepted path, ``spec_heads`` or seeded weights),
verified by K2r's per-slot tree mask (``spec_tree_scope``) and
compacted onto the linear tail by ``permute_window``. Greedy engines
emit the target's greedy tokens; sampling engines run rejection
sampling with each slot's own knobs on both distributions.

Batched multi-LoRA serving (``ServingConfig(lora_rank=r)``): adapters
registered by :meth:`ServingEngine.load_adapter` are pinned into a
device-resident LRU window of ``max_adapters`` stack rows while a
request (``submit(adapter_id=)``) is seated; each slot's stack row rides
the tick's packed vector, and every packed row adds its slot's low-rank
delta to the target projections through K4's float32 gather and scatter
modes (:mod:`paddle_tpu_torch.ops.lora`). The stacks are written in
place, so adapter churn recaptures no graph. A request under an adapter
keys its prompt blocks in the prefix cache by a seed that also names the
adapter and its weights' generation (the reference keys them by the
model alone and so reuses one adapter's K/V under another).

Telemetry, as the reference's (:mod:`paddle_tpu_torch.monitor`): every
``serving_*`` metric of the reference engine is registered in the port's
registry under its name, labels and buckets (the cluster's and tensor
parallelism's stay at zero); the TTFT, inter-token, queue-wait and
end-to-end digests; one span tracer an engine (``tracer``,
``dump_trace``; tid 0 the ticks, tid ``1 + i`` slot ``i``, the last tid
the queue); the health engine (``health()``, ``watchdog_stuck()``; a
graph capture is the reference's compile); a non-finite probe on the
logits each tick samples from, riding the tick's one read-back vector;
and the per-layout roofline (``stats()['roofline']``): each layout's
FLOPs and bytes, counted once from its eager warm-up
(:class:`~paddle_tpu_torch.monitor.accounting.CostRecorder`), over its
measured dispatch-to-read-back time. ``kernel_census()`` joins those
counts with the node census of each captured graph, and ``profile(n)``
arms a ``torch.profiler`` window over the next ``n`` ticks. All of it is
host code outside the captured ticks: ``PADDLE_TPU_TRACE=0`` and
``PADDLE_TPU_HEALTH=0`` (or ``health=False``) change no token and no
graph.

The reference's per-width engine (``ServingConfig(ragged_batch=
False)``): each tick runs ONE fixed-width step over every slot, the
decode step (each decoding slot's token at its length; K2d) or, when
speculating, the n-gram drafts or the draft model's loop and the
fixed-gamma verify step (K2v at ``T = gamma + 1``); idle and pending
slots ride it as null rows. Prompts prefill by ``[1, prefill_chunk]``
chunk steps (K2v at ``T = prefill_chunk``), whole at admission or, with
``max_prefill_chunks_per_step > 0``, that many a tick between the decode
steps (a pending slot's table row stays null until its prefill ends).
``chunked_prefill=False`` (on either engine) prefills a prompt at
admission by one dense cached forward at its power-of-two bucket
(``min_prefill_bucket``), scattered into its blocks, and turns the
prefix cache and preemption off, as the reference does. Each of these
steps runs its layers fused (K3a / K3b around K2d / K2v, inside
:func:`~paddle_tpu_torch.ops.kernels.decode_fused.paged_fused_scope`)
and is captured once as a CUDA graph on the card (its first call on the
CPU is counted instead), as the reference compiles each once:
``decode_compiles``, ``prefill_compiles`` (by bucket label) and
``executables_compiled`` count them.

Later slices bring tensor parallelism and the cluster; a config field
or argument asking for one of them raises ``NotImplementedError`` naming
that slice; their ``stats()`` keys are present at their off values.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..distributed import moe as _moe
from ..framework.place import resolve_device
from ..framework.random import generator
from ..generation import _filter_logits, _prompt_bucket, _select_token
from ..generation import speculative as _spec
from .. import monitor
from ..monitor import LatencyDigest
from ..monitor import accounting as _acct
from ..monitor import health as _health
from ..monitor import tracing as _tracing
from ..ops import lora as _lora
from ..ops import paged_cache as _pc
from ..ops.cuda_graphs import Upload as _Upload
from ..ops.cuda_graphs import capture as _capture_graph
from ..ops.cuda_graphs import capture_stream
from ..ops.cuda_graphs import graphs_usable
from ..ops.kernels import decode_fused as _df
from ..ops.kernels import launch_counts
from ..ops.kernels import paged_attention as _pa_k
from ..ops.kernels.paged_attention import spec_tree_scope

__all__ = ["ServingConfig", "ServingRequest", "ServingEngine",
           "QueueShedError"]


class QueueShedError(RuntimeError):
    """Raised by ``submit()`` when queue-depth shedding is armed
    (``ServingConfig.shed_queue_depth``) and the queue already holds that
    many requests: the request is refused at the front door, so queued
    work keeps its latency budget under overload."""


# later-slice fields: accepted only at their "off" value
_LATER = {
    "tp_degree": (1, "tensor-parallel serving"),
    "role": ("both", "disaggregated cluster serving"),
}
_ENGINE_IDS = itertools.count()


@dataclass
class ServingConfig:
    num_slots: int = 8                  # fixed decode batch width
    block_size: int = 16                # tokens per KV block
    max_model_len: int = 1024           # prompt + generated cap per seq
    num_blocks: Optional[int] = None    # None: every slot at max length
    max_new_tokens: int = 128           # per-request default
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    decode_strategy: str = "greedy_search"   # or "sampling"
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # smallest prompt bucket of the bucketed prefill (chunked_prefill
    # False)
    min_prefill_bucket: int = 16
    prefill_chunk: int = 128            # widest prefill rows of one slot
    ragged_prefill_rows: Optional[int] = None   # per-tick prefill budget
    # chunked prefill: a prompt advances prefill_chunk rows a step (the
    # ragged tick's rows, or the per-width chunk step, K2v at T = C);
    # False prefills a whole prompt at admission by one dense forward at
    # its power-of-two bucket (and turns the prefix cache and preemption
    # off, as the reference does)
    chunked_prefill: bool = True
    # the per-width engine (ragged_batch False) with chunked prefill:
    # > 0 leaves prompts pending at admission and advances at most this
    # many chunk steps a tick, across the pending slots, before the decode
    # step; 0 prefills each prompt whole at admission
    max_prefill_chunks_per_step: int = 0
    # False: the reference's per-width engine: a fixed-width decode step
    # over every slot (K2d), a fixed-gamma verify step (K2v), prefill by
    # chunk steps or buckets; True: one ragged tick packs every row
    ragged_batch: bool = True
    fused_decode: bool = True           # fused norm/projection kernels
    # MoE routing telemetry (stats()'s moe_routing_entropy /
    # moe_expert_load_max): each sparse layer's expert counts, read back
    # with the tick's tokens. False skips the collection.
    moe_telemetry: bool = True
    # KV-pool storage: None / "auto" = the model dtype; "int8" = int8
    # data + a float32 absmax scale a (block, position, kv head)
    kv_cache_dtype: Optional[str] = None
    # speculative decoding: draft gamma tokens a slot a tick and verify
    # them in the tick's one forward (0 = off); drafter: "ngram" (prompt
    # lookup), "model" (pass draft_model) or "heads" (tree draft heads)
    num_speculative_tokens: int = 0
    drafter: str = "ngram"
    spec_ngram_max: int = 3             # longest prompt-lookup n-gram
    # a token tree of num_speculative_tokens nodes: node k + 1's parent
    # is spec_tree[k] (0 = the committed root); None = a linear chain
    spec_tree: Optional[tuple] = None
    # the async tick pipeline: 1 dispatches the next pure decode tick from
    # the in-flight tick's device carry before committing it; None / 0
    # dispatch then block
    async_depth: Optional[int] = None
    # content-addressed prefix reuse over the block pool: retired and
    # preempted sequences publish their full blocks; False frees them
    enable_prefix_cache: bool = True
    # False: retirement drops each request's tokens instead of holding
    # them for run() (a streaming deployment that drives step() itself)
    retain_results: bool = True
    # priorities, watermark admission and preemption with the host KV
    # tier; False keeps FIFO admission with worst-case reservations
    enable_preemption: bool = True
    # overcommit headroom of admission, in blocks (None: num_slots)
    admission_watermark_blocks: Optional[int] = None
    # host-memory tier for preempted and evicted blocks (0: none)
    host_kv_tier_bytes: int = 64 << 20
    # how a preempted request resumes: "auto" (the measured cheaper of
    # the two), "swap" (import its spilled bytes) or "recompute"
    preempt_resume: str = "auto"
    # submit() raises QueueShedError at this queue depth (None: never)
    shed_queue_depth: Optional[int] = None
    # default queue-wait budget of a request (None: unbounded)
    max_queue_wait_ms: Optional[float] = None
    # batched multi-LoRA serving: lora_rank > 0 arms the adapter pool
    # (load_adapter, submit(adapter_id=)); max_adapters rows of it stay
    # on the device (besides the null adapter), the rest in host memory
    lora_rank: int = 0
    max_adapters: int = 8
    # the delta's scale is lora_alpha / lora_rank (None: 1)
    lora_alpha: Optional[float] = None
    # "attn": the attention projections; "all": the MLP's too
    lora_targets: str = "attn"
    # int8 resident stacks (an absmax scale a matrix)
    lora_quant: bool = False
    # the health engine (monitor/health.py): SLO burn rates, anomaly
    # detectors, the stuck-tick watchdog and incident capture, host code
    # only; False (or PADDLE_TPU_HEALTH=0, which beats True) builds none
    health: bool = True
    # a request misses its SLO when its TTFT exceeds health_slo_ttft_ms
    # or any inter-token gap health_slo_itl_ms
    health_slo_ttft_ms: float = 2000.0
    health_slo_itl_ms: float = 500.0
    # SLO target (error budget 1 - target) and the fast / slow burn
    # windows: the fast alert pages only when both windows burn faster
    # than health_burn_threshold x budget over at least
    # health_burn_min_requests retirements
    health_slo_target: float = 0.99
    health_burn_fast_s: float = 5.0
    health_burn_slow_s: float = 60.0
    health_burn_threshold: float = 2.0
    health_burn_min_requests: int = 8
    # the watchdog's deadline: max(floor, mult x the tick's time EMA)
    health_watchdog_mult: float = 50.0
    health_watchdog_floor_s: float = 5.0
    # arm a profile of this many ticks when an alert fires (0: off;
    # lands only with PADDLE_TPU_PROFILE_DIR)
    health_profile_ticks: int = 0
    # -- later slices: accepted only at their off value ------------------
    tp_degree: int = 1
    role: str = "both"

    def __post_init__(self):
        if self.preempt_resume not in ("auto", "swap", "recompute"):
            raise ValueError(
                f"preempt_resume must be auto|swap|recompute, got "
                f"{self.preempt_resume!r}")
        if self.host_kv_tier_bytes < 0:
            raise ValueError(
                f"host_kv_tier_bytes must be >= 0, got "
                f"{self.host_kv_tier_bytes!r}")
        if self.shed_queue_depth is not None \
                and int(self.shed_queue_depth) < 1:
            raise ValueError(
                f"shed_queue_depth must be >= 1 (or None), got "
                f"{self.shed_queue_depth!r}")
        if not 0.0 < self.health_slo_target < 1.0:
            raise ValueError(
                f"health_slo_target must be in (0, 1), got "
                f"{self.health_slo_target!r}")
        if not 0.0 < self.health_burn_fast_s < self.health_burn_slow_s:
            raise ValueError(
                f"need 0 < health_burn_fast_s < health_burn_slow_s, got "
                f"{self.health_burn_fast_s!r}, {self.health_burn_slow_s!r}")
        if self.health_watchdog_floor_s <= 0:
            raise ValueError(
                f"health_watchdog_floor_s must be > 0, got "
                f"{self.health_watchdog_floor_s!r}")
        if self.health_watchdog_mult < 1.0:
            raise ValueError(
                f"health_watchdog_mult must be >= 1, got "
                f"{self.health_watchdog_mult!r}")
        ad = self.async_depth
        if ad is not None and (not isinstance(ad, int)
                               or isinstance(ad, bool)
                               or ad < 0 or ad > 1):
            raise ValueError(
                f"async_depth must be 0, 1 or None, got {ad!r}")
        lr = self.lora_rank
        if not isinstance(lr, int) or isinstance(lr, bool) or lr < 0:
            raise ValueError(
                f"lora_rank must be an int >= 0, got {lr!r}")
        if lr > 0:
            if int(self.max_adapters) < 1:
                raise ValueError(
                    f"max_adapters must be >= 1, got "
                    f"{self.max_adapters!r}")
            if self.lora_targets not in ("attn", "all"):
                raise ValueError(
                    f"lora_targets must be 'attn' or 'all', got "
                    f"{self.lora_targets!r}")
            if self.lora_alpha is not None \
                    and float(self.lora_alpha) <= 0.0:
                raise ValueError(
                    f"lora_alpha must be > 0 (or None), got "
                    f"{self.lora_alpha!r}")
        if ad and not self.ragged_batch:
            raise NotImplementedError(
                "async_depth requires the ragged engine (ragged_batch="
                "True); to disable the pipeline itself set async_depth=0")
        for name, (off, what) in _LATER.items():
            v = getattr(self, name)
            if v != off:
                raise NotImplementedError(
                    f"ServingConfig({name}={v!r}) asks for {what}, which "
                    "comes with a later slice of the PyTorch port; this "
                    "engine serves the core ragged tick only")
        _pc.resolve_kv_cache_dtype(self.kv_cache_dtype)   # ValueError
        if self.decode_strategy not in ("greedy_search", "sampling"):
            raise NotImplementedError(
                f"decode_strategy {self.decode_strategy!r}; supported: "
                "greedy_search, sampling")
        for name in ("num_slots", "block_size", "max_model_len",
                     "prefill_chunk"):
            if int(getattr(self, name)) < 1:
                raise ValueError(f"{name} must be >= 1")
        # the reference validates these when it builds its engine
        gamma = int(self.num_speculative_tokens or 0)
        if gamma < 0:
            raise ValueError(
                f"num_speculative_tokens must be >= 0, got {gamma}")
        if self.spec_tree is not None:
            tree = tuple(int(p) for p in self.spec_tree)
            if len(tree) != gamma or gamma == 0:
                raise ValueError(
                    f"spec_tree has {len(tree)} non-root nodes; must equal "
                    f"num_speculative_tokens={gamma} (> 0)")
            _spec.tree_ancestor_bits(tree)       # topology / depth
            if self.drafter == "model":
                raise ValueError(
                    "spec_tree drafts via drafter='ngram' (top-k prompt "
                    "lookup) or drafter='heads' (draft-head projections); "
                    "a separate draft_model proposes one chain, not a tree")
        if self.drafter == "heads" and self.spec_tree is None:
            raise ValueError("drafter='heads' requires spec_tree (the "
                             "draft heads fill a token tree)")
        if gamma and self.drafter not in ("ngram", "model", "heads"):
            raise ValueError(f"drafter {self.drafter!r}; supported: "
                             "ngram, model, heads")


@dataclass
class ServingRequest:
    request_id: int
    prompt: np.ndarray                  # [L] int32
    max_new_tokens: int
    submit_time: float
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    # scheduling class: higher admits first and may preempt strictly
    # lower classes; FIFO within a class (ignored without preemption)
    priority: int = 0
    # queue-wait budget (ms): still queued past it, the request ends
    # with an empty result
    max_queue_wait_ms: Optional[float] = None
    # a preempted request's continuation (None for a fresh one):
    # cache_len, last_token, n_emitted, history, worst_blocks, n_blocks,
    # nbytes and key (its host-tier entry, or None)
    resume: Optional[dict] = None
    # the LoRA adapter it decodes under (None: the base model), pinned
    # while it is seated and carried across a preemption
    adapter_id: Optional[int] = None


class _Slot:
    __slots__ = ("rid", "blocks", "worst_blocks", "cache_len",
                 "last_token", "n_emitted", "max_new", "prompt", "pend_pos",
                 "history", "priority", "admit_t", "resume", "adapter_id",
                 "seed")

    def __init__(self, rid, blocks, worst_blocks, max_new, prompt,
                 cache_len=0, history=None, priority=0, adapter_id=None,
                 seed=None):
        self.rid = rid
        self.blocks = blocks            # allocated block ids (ordered)
        self.worst_blocks = worst_blocks
        self.cache_len = cache_len      # valid cache positions
        self.last_token = None
        self.n_emitted = 1              # counts the first token once out
        self.max_new = max_new
        self.prompt = prompt            # int32 prompt (a resume's context)
        self.pend_pos = cache_len       # next prefill row; None = decoding
        # prompt + emitted tokens: position p of the cache holds
        # history[p] for p < cache_len; the n-gram drafter's corpus and
        # what publishing hashes
        self.history = [int(t) for t in prompt] if history is None \
            else list(history)
        self.priority = int(priority)
        self.admit_t = time.monotonic()
        # (last_token, n_emitted) a recompute resume restores when its
        # re-prefill completes
        self.resume = None
        self.adapter_id = adapter_id
        self.seed = seed                # its prefix hashes' seed


class _Layout(NamedTuple):
    """The static shape of one tick's packed inputs (one int64 vector on
    the device: the per-row triple, the per-slot rows, then the verifying
    slots and their windows) and of what its body computes; it keys the
    tick's CUDA graph."""
    rows: int           # packed query rows R (the static width if mixed)
    w_max: int          # rows of the widest slot (the static bound if mixed)
    srows: int          # per-slot rows: base, q_lens, row_starts,
    #                     last_rows (+ tree flags) (+ LoRA stack rows)
    #                     (+ the draft's prime lengths) (+ the carry's
    #                     budget)
    active: int         # verifying slots (0: no verify window this tick)
    pure: bool          # decode / verify rows only, packed live
    carry: bool         # writes the next tick's packs over its own

    def name(self, gamma) -> str:
        """The layout's name in telemetry (the reference's executable
        name, ``decode`` or ``verify``, then the layout):
        ``kind-pure|mixed-r<rows>-w<w_max>-a<active>[-carry]``."""
        return (f"{'verify' if gamma else 'decode'}-"
                f"{'pure' if self.pure else 'mixed'}-r{self.rows}-"
                f"w{self.w_max}-a{self.active}"
                + ("-carry" if self.carry else ""))


class _TickOut(NamedTuple):
    """A tick body's device outputs: the one vector the host reads back
    (tokens, windows, accept flags, paths, head drafts, MoE counts, and
    last the non-finite probe), the logits, and what the tree's pool
    moves need after the read-back."""
    flat: torch.Tensor
    logits: torch.Tensor
    path: Optional[torch.Tensor]        # tree: accepted node a depth
    base: torch.Tensor                  # per-slot cache lengths (int32)
    act: Optional[torch.Tensor]         # the verifying slots (int64)
    moe_counts: Optional[tuple]         # (MoE layers, experts) at the
    #                                     end of flat


class _TickGraph(NamedTuple):
    """One captured tick: the graph (with the host counts a replay
    adds), its input vector and its outputs."""
    step: object        # ops.cuda_graphs.StepGraph
    inp: _Upload
    outs: _TickOut


class _PwStep:
    """One step of the per-width engine (or of the bucketed prefill), by
    the reference's executable name: on CUDA its graph (captured at its
    first call, after that call ran eagerly) and the graph's outputs, a
    body's ``(flat, logits, MoE counts' shape)``."""
    __slots__ = ("graph", "outs")

    def __init__(self):
        self.graph = self.outs = None


class _Pipe:
    """One dispatched tick not yet committed (the async pipeline's
    in-flight record): its device outputs, the host's copy of ``flat``
    and the event it waits on (async pure ticks), and the row layout the
    commit needs. ``carry``: the input vector now holding the next tick's
    packs (async pure decode ticks), from which a pipelined dispatch
    runs. ``t0``: the launch time (the prefill rate's and the roofline's
    clock); ``t_tick``: the tick's start (its span's); ``q_lens``,
    ``n_pending`` and ``pend_pos0``: what the tick's spans report;
    ``timed``: False for a layout's first tick (its capture, or its
    counted eager run), which the roofline leaves out."""
    __slots__ = ("outs", "host", "event", "layout", "active", "given",
                 "rid_of", "carry", "t0", "t_tick", "q_lens", "n_pending",
                 "pend_pos0", "timed")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


def _seeded_heads(n_heads, hidden, vocab, device):
    """The reference's default draft heads, ``[n_heads, hidden, vocab]``
    float32: head ``d`` is ``default_rng(0x5EED + d)``'s standard normal
    draw rounded to float32, times 0.02, so every engine derives the same
    ones. Drawn in blocks of 256 rows of one stream: the values of one
    draw of the whole array, without its float64 copy."""
    heads = torch.empty((n_heads, hidden, vocab), dtype=torch.float32,
                        device=device)
    for d in range(n_heads):
        rng = np.random.default_rng(0x5EED + d)
        for r0 in range(0, hidden, 256):
            r1 = min(hidden, r0 + 256)
            heads[d, r0:r1] = torch.from_numpy(
                rng.standard_normal((r1 - r0, vocab)).astype(np.float32)
                * np.float32(0.02))
    return heads


class ServingEngine:
    """Continuous-batching serving over a port causal LM (the
    ``init_paged_caches`` + ragged ``forward`` protocol of
    :class:`paddle_tpu_torch.models.llama.LlamaForCausalLM`).

    Usage::

        engine = ServingEngine(model, ServingConfig(num_slots=8))
        rid = engine.submit([1, 2, 3], max_new_tokens=32)
        results = engine.run()          # {rid: np.ndarray of tokens}

    or stream: pass ``stream_callback=lambda rid, tok: ...`` and drive
    ``step()`` yourself. The engine runs on ``device`` (default: cuda),
    which must be the model's device (and the draft model's).
    ``draft_model`` drafts for ``drafter="model"``; ``spec_heads`` (one
    ``[hidden, vocab]`` array a tree depth) are the draft heads of
    ``drafter="heads"``. ``cuda_graphs`` (True) replays every tick from
    a CUDA graph on CUDA; set it False on an instance or the class to run
    every tick eagerly, at the same widths (kernels patched to plain
    versions that read values back cannot be captured).
    """

    cuda_graphs = True

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 stream_callback: Optional[Callable] = None, device=None,
                 draft_model=None, spec_heads=None):
        if not hasattr(model, "init_paged_caches"):
            raise TypeError(f"{type(model).__name__} does not implement "
                            "init_paged_caches (paged-KV serving)")
        cfg = config or ServingConfig()
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"model is on {model.device}, engine on {dev}: "
                             "build the model on the engine's device")
        gamma = int(cfg.num_speculative_tokens or 0)
        if draft_model is not None and \
                (gamma == 0 or cfg.drafter != "model"):
            # drafting by n-gram while the caller handed over a draft
            # model would measure the wrong configuration
            raise ValueError(
                "draft_model requires num_speculative_tokens > 0 and "
                f"drafter='model' (got gamma={gamma}, "
                f"drafter={cfg.drafter!r})")
        if gamma:
            if cfg.drafter == "model" and draft_model is None:
                raise ValueError("drafter='model' requires a draft_model")
            reason = _spec.spec_exclusion_reason(model)
            if reason is not None:
                raise NotImplementedError(
                    f"speculative serving unavailable: {reason}")
            if cfg.drafter == "model":
                reason = _spec.draft_exclusion_reason(model, draft_model)
                if reason is not None:
                    raise NotImplementedError(
                        f"draft model unusable: {reason}")
                if draft_model.device.type != dev.type:
                    raise ValueError(
                        f"draft model is on {draft_model.device}, engine "
                        f"on {dev}")
        if spec_heads is not None and cfg.drafter != "heads":
            raise ValueError(
                "spec_heads requires drafter='heads' (and spec_tree)")
        # capacity routing would let the packed rows of other slots compete
        # for an expert's capacity, so a row's logits would depend on the
        # batch: only dropless MoE serves
        mcfg = getattr(model, "config", None)
        if _moe.capacity_routed(mcfg):
            raise NotImplementedError(
                "capacity-routed MoE model cannot serve: batched slots' "
                "tokens would compete for expert capacity, so logits would "
                "depend on batch composition. Set config.dropless=True "
                "(grouped dropless routing) to serve this model.")
        if draft_model is not None and _moe.capacity_routed(
                getattr(draft_model, "config", None)):
            raise NotImplementedError(
                "capacity-routed MoE draft model cannot serve: batched "
                "slots' tokens would compete for expert capacity. Set "
                "config.dropless=True to serve this model.")
        max_pos = getattr(model.config, "max_position_embeddings", None)
        if max_pos is not None and cfg.max_model_len + gamma > max_pos:
            raise ValueError(
                f"max_model_len ({cfg.max_model_len})"
                + (f" + speculative window ({gamma})" if gamma else "")
                + f" exceeds the model's max_position_embeddings "
                f"({max_pos})")
        # the per-width engine and the bucketed prefill; a tree verify
        # rides only the ragged tick, as in the reference
        self._ragged = bool(cfg.ragged_batch)
        self._chunked = bool(cfg.chunked_prefill)
        if cfg.spec_tree is not None and not self._ragged:
            raise NotImplementedError(
                "spec_tree requires the ragged engine (ragged_batch=True); "
                "to disable tree speculation itself leave spec_tree None")
        if cfg.lora_rank > 0 and not (self._ragged and self._chunked):
            raise NotImplementedError(
                "multi-LoRA serving requires the ragged engine with chunked "
                "prefill (ragged_batch=True and chunked_prefill on) — "
                "prompt rows must ride the ragged tick so adapter deltas "
                "reach the prefill KV; to disable LoRA itself set "
                "lora_rank=0")
        self.model = model.eval()
        self.config = cfg
        self.device = dev
        self._stream = stream_callback
        self._do_sample = cfg.decode_strategy == "sampling"
        self._samp_default = np.asarray(
            [float(cfg.temperature), float(cfg.top_k), float(cfg.top_p)],
            np.float32)
        self._slot_samp = np.tile(self._samp_default, (cfg.num_slots, 1))
        self._samp_dev = _Upload(self._slot_samp.shape, torch.float32, dev)
        self._samp_dirty = True
        self._gen = generator(cfg.seed, dev)

        # -- speculation -------------------------------------------------
        # a verify window overhangs the last token by up to gamma
        # positions: written, then rolled back by not advancing
        self._gamma = gamma
        self._ngram_max = int(cfg.spec_ngram_max)
        self._tree = None if cfg.spec_tree is None \
            else tuple(int(p) for p in cfg.spec_tree)
        if self._tree is not None:
            (self._tree_depth, _, self._tree_chains,
             self._tree_max_depth) = _spec.tree_chain_layout(self._tree)
        self._heads = None
        self._slot_props = {}           # slot -> next tick's head drafts
        if self._tree is not None and cfg.drafter == "heads":
            self._init_heads(model, spec_heads, dev)
        draft = self._draft = draft_model.eval() if gamma and \
            cfg.drafter == "model" else None
        # the loop closes over the draft model, not the engine: a closure
        # over ``self`` would hold the engine, its pools and the draft's
        # in a reference cycle until the collector ran
        self._dloop = None if draft is None else \
            _spec.build_draft_loop(
                lambda ids, pools, tables, lens: draft(
                    ids, caches=pools, block_tables=tables,
                    cache_lens=lens),
                gamma=gamma, do_sample=self._do_sample,
                want_probs=self._do_sample, slot_params=True)
        # the per-width engine's verify step: one target forward over
        # every slot's window, filtered by the per-slot knobs (a closure
        # over the model, not the engine: no reference cycle)
        self._pw_verify = None
        if gamma and not self._ragged:
            fused = bool(cfg.fused_decode)
            self._pw_verify = _spec.build_verify_step(
                lambda ids, pools, tables, lens: model(
                    ids, caches=pools, block_tables=tables,
                    cache_lens=lens, fused=fused),
                gamma=gamma, do_sample=self._do_sample, slot_params=True)
        self._n_spec_proposed = 0
        self._n_spec_accepted = 0
        self._n_spec_verifies = 0       # slot verify windows
        self._n_spec_emitted = 0

        # -- multi-LoRA ----------------------------------------------------
        # each slot's resident stack row (0: the null adapter), one more
        # per-slot row of the tick's vector
        self._slot_adapter = np.zeros(cfg.num_slots, np.int64)
        self._lora = None
        if cfg.lora_rank > 0:
            specs = _lora.tag_modules(model, str(cfg.lora_targets))
            if not specs:
                raise NotImplementedError(
                    "no LoRA-taggable projection layers found on this "
                    "model (expected q/k/v/o | qkv/out projections "
                    "named per Llama/GPT idiom)")
            self._lora = _lora.AdapterPool(
                specs, int(cfg.lora_rank), alpha=cfg.lora_alpha,
                max_resident=int(cfg.max_adapters),
                quant=bool(cfg.lora_quant), device=dev)

        self._bs = int(cfg.block_size)
        self._mb = _pc.blocks_for(cfg.max_model_len + gamma, self._bs)
        nb = (1 + cfg.num_slots * self._mb) if cfg.num_blocks is None \
            else int(cfg.num_blocks)
        self._alloc = _pc.BlockAllocator(nb)
        # -- the prefix cache, preemption and the host KV tier ------------
        # both need the chunked prefill, as in the reference: a bucketed
        # prefill rewrites the whole prompt, and a recompute resume is a
        # chunked re-prefill
        self._prefix_on = self._chunked and bool(cfg.enable_prefix_cache)
        # the hash chains' seed: blocks are shared within one model only
        self._fp = _pc.model_fingerprint(model)
        self._preempt_on = self._chunked and bool(cfg.enable_preemption)
        wm = cfg.admission_watermark_blocks
        self._watermark = int(cfg.num_slots if wm is None else wm)
        self._resume_policy = str(cfg.preempt_resume)
        self._shed_depth = cfg.shed_queue_depth
        self._default_qwait = cfg.max_queue_wait_ms
        # a spill holds a request's prompt and output blocks at most
        self._mb_xfer = _pc.blocks_for(cfg.max_model_len, self._bs)
        tier_bytes = int(cfg.host_kv_tier_bytes or 0)
        self._host_tier = _pc.HostKVTier(tier_bytes) \
            if self._preempt_on and tier_bytes > 0 else None
        if self._host_tier is not None and self._prefix_on:
            # evicted published blocks go to the host tier, from which a
            # later prefix hit restores them; through a weak reference,
            # or the allocator would hold its engine in a cycle
            me = weakref.ref(self)
            self._alloc.on_evict = lambda b, h: me()._spill_evicted(b, h)
        self._n_preempt = 0             # slots preempted
        self._n_spilled = 0             # blocks copied into the host tier
        self._n_restored = 0            # blocks imported from it
        self._n_swap_resumes = 0
        self._n_recompute_resumes = 0
        self._n_shed = 0
        self._n_timeout = 0
        self._n_cancelled = 0
        # the resume cost model's rates (EMA): prefill rows a second, and
        # host-transfer bytes a second
        self._prefill_rows_s = 0.0
        self._xfer_bytes_s = 0.0
        self._n_prefix_blocks = 0       # cached blocks mapped into slots
        self._n_prefix_tokens = 0       # prompt tokens not prefilled
        self._n_prompt_tokens = 0       # prompt tokens admitted
        self._n_cow = 0
        self._chunk = max(1, min(int(cfg.prefill_chunk),
                                 int(cfg.max_model_len)))
        self._chunk_budget = int(cfg.max_prefill_chunks_per_step)
        if not self._ragged and self._chunked \
                and self._chunk > _pa_k.MAX_WINDOW:
            # the chunk step is K2v at T = prefill_chunk
            raise ValueError(
                f"prefill_chunk {self._chunk} exceeds the verify kernel's "
                f"window of {_pa_k.MAX_WINDOW} rows (the per-width chunk "
                "step)")
        if self._chunked:
            want = cfg.ragged_prefill_rows
            self._prefill_rows = max(1, min(
                int(self._chunk if want is None else want),
                int(cfg.max_model_len)))
        else:
            self._prefill_rows = 0      # the buckets prefill at admission
        # the static width of a tick with prefill rows, the reference's:
        # every decoding slot's window plus one tick's prefill row budget,
        # a slot at most the widest chunk (the ragged grid's window dim)
        self._rows = cfg.num_slots * (gamma + 1) + self._prefill_rows
        self._wmax = max(gamma + 1, min(self._chunk, self._prefill_rows)
                         if self._chunked else 1)
        # the per-width chunk steps' attended positions, folded into the
        # next tick's KV-read gauge
        self._kv_read_pend = 0
        # pad rows (and a pipelined tick's finished slots) park past every
        # table's reach: the write null-routes, the rope gather clamps
        self._overflow = self._mb * self._bs
        self._kv_dtype = _pc.resolve_kv_cache_dtype(cfg.kv_cache_dtype)
        kw = {"kv_cache_dtype": self._kv_dtype} if self._kv_dtype else {}
        self._pools = model.init_paged_caches(nb, self._bs, **kw)
        # the draft's pools share the engine's block tables
        self._dpools = None if self._draft is None else \
            self._draft.init_paged_caches(nb, self._bs, **kw)
        k0 = self._pools[0][0]
        self._kv_dtype_name = self._kv_dtype or str(k0.dtype).replace(
            "torch.", "")
        self._kv_pool_bytes = _pc.pool_bytes(self._pools)
        # bytes one cached position costs over every layer's K and V
        self._kv_pos_bytes = self._kv_pool_bytes / float(nb * self._bs)
        self._kv_step_bytes_last = 0
        self._tables = np.zeros((cfg.num_slots, self._mb), np.int32)
        # one device table for the engine's life (a graph's operand),
        # written in place whenever the host's changed
        self._tables_up = _Upload(self._tables.shape, torch.int32, dev)
        self._tables_dev = self._tables_up.dev
        self._tables_dirty = True
        self._slots: List[Optional[_Slot]] = [None] * cfg.num_slots
        self._reserved = 0              # blocks promised to active slots
        self._queue: deque = deque()
        self._results: Dict[int, list] = {}
        self._done: Dict[int, np.ndarray] = {}
        self._next_rid = 0
        self._eos = -1 if cfg.eos_token_id is None else int(cfg.eos_token_id)
        self._pad = int(cfg.pad_token_id)
        self._submit_t: Dict[int, float] = {}
        self._n_ticks = 0
        self._n_rows = 0
        self._n_tokens = 0
        self._n_completed = 0
        self._n_prefill_chunks = 0
        self._moe = bool(_moe.num_routed_experts(mcfg))
        self._moe_tap_on = self._moe and bool(cfg.moe_telemetry)
        self._moe_fused = False         # a tick ran the fused path (K4)
        self._moe_ent_last = 0.0
        self._moe_load_max_last = 0.0
        self._n_moe_dispatches = 0
        self.last_logits = None         # [S, V] of the latest tick

        # -- CUDA graphs of the ticks, and the async pipeline -----------
        # a sampling tick draws from self._gen, which each graph registers
        # to draw what the eager tick would; a PyTorch without that keeps
        # a sampling engine's ticks eager
        self._graphs_ok = graphs_usable(dev, self._do_sample)
        self._graphs: Dict[_Layout, _TickGraph] = {}
        # the per-width engine's steps (and the bucketed prefill's), by
        # the reference's executable names
        self._pw: Dict[str, _PwStep] = {}
        self._pw_inputs: Dict[str, _Upload] = {}
        self._pw_dq = None              # the draft loop's distributions
        self._row_up = _Upload((1, self._mb), torch.int32, dev)
        self._n_exec_compiled = 0       # every graph / step built
        self._n_prefill_compiles = 0
        self._lay_names: Dict[_Layout, str] = {}    # layouts counted
        self._graph_pool = None         # one memory pool for all of them
        self._async_on = bool(cfg.async_depth)
        self._pipe: Optional[_Pipe] = None      # the in-flight tick
        self._n_pipe_flushes = 0
        self._n_pure = 0                # ticks of decode / verify rows only
        self._n_pipelined = 0           # dispatched from a carry
        self._last_dispatch_t = None
        self._d_host_gap = LatencyDigest()
        self._d_accept = LatencyDigest()    # tokens a verify window
        self._init_telemetry(cfg, gamma)

    def _init_telemetry(self, cfg, gamma):
        """The reference engine's metrics (same names, labels and
        buckets, registered whatever the features on, so every export
        carries every key), the SLO digests, the tracer, the roofline's
        state and the health monitor."""
        self._m_occupancy = monitor.gauge(
            "serving_slot_occupancy", "active serving slots")
        self._m_util = monitor.histogram(
            "serving_batch_utilization",
            "active slots / num_slots per decode step",
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
        self._m_queue_wait = monitor.histogram(
            "serving_queue_wait_ms",
            "submit -> queue-exit wait, labeled by outcome (admitted |"
            " cancelled | rejected | shutdown) — EVERY exit path "
            "observes, so the distribution can't survivor-bias toward "
            "admitted requests",
            labels=("outcome",))
        self._m_tokens = monitor.counter(
            "serving_tokens_total", "tokens generated (all requests)")
        self._m_steps = monitor.counter(
            "serving_decode_steps", "batched decode steps executed")
        self._m_decode_compiles = monitor.counter(
            "serving_decode_compiles",
            "tick CUDA graphs captured (one a ragged tick layout, none on "
            "the CPU; the per-width engine's decode or verify step, counted "
            "at its first run on the CPU)")
        self._m_prefill_compiles = monitor.counter(
            "serving_prefill_compiles",
            "prefill steps built per prompt bucket (the per-width chunk "
            "step, its draft twin, the bucketed prefill's buckets; each a "
            "CUDA graph on the card)", labels=("bucket",))
        self._m_completed = monitor.counter(
            "serving_requests_completed", "requests fully served")
        self._m_prefix_blocks = monitor.counter(
            "serving_prefix_blocks_reused",
            "cached KV blocks mapped into admitted slots")
        self._m_prefix_tokens = monitor.counter(
            "serving_prefix_tokens_reused",
            "prompt tokens served from the prefix cache (not "
            "re-prefilled)")
        self._m_cow = monitor.counter(
            "serving_cow_copies",
            "copy-on-write block duplications (shared block appended "
            "into)")
        self._m_evict = monitor.counter(
            "serving_cache_evictions",
            "cached blocks evicted under memory pressure (LRU)")
        self._m_hit_rate = monitor.gauge(
            "serving_prefix_hit_rate",
            "cumulative reused / admitted prompt tokens")
        monitor.counter(
            "serving_kv_blocks_transferred",
            "KV blocks streamed between engine pools (disaggregated "
            "prefill -> decode handoffs; counted at import, data + "
            "scales travel together on int8 pools)")
        self._m_preempt = monitor.counter(
            "serving_preemptions",
            "victim slots preempted (blocks published + spilled, slot "
            "freed, request re-enqueued at the front of its priority "
            "class)")
        self._m_spill = monitor.counter(
            "serving_kv_blocks_spilled",
            "KV blocks spilled to the host-DRAM tier (preempted "
            "victims' live blocks + LRU-evicted published blocks; "
            "int8 data + scales travel together)")
        self._m_restore = monitor.counter(
            "serving_kv_blocks_restored",
            "KV blocks restored from the host-DRAM tier (swap resumes "
            "+ prefix hits on spilled published blocks)")
        self._m_host_bytes = monitor.gauge(
            "serving_host_tier_bytes",
            "bytes resident in the host-DRAM KV tier (spilled block "
            "payloads awaiting restore or LRU eviction)")
        self._m_lora_resident = monitor.gauge(
            "serving_lora_adapters_resident",
            "LoRA adapters resident in the device stacks (excludes "
            "the always-present null adapter)")
        self._m_lora_swaps = monitor.counter(
            "serving_lora_adapter_swaps",
            "adapter loads that evicted an unpinned resident adapter "
            "to make room (LRU churn against the max_adapters budget)")
        self._m_lora_host = monitor.gauge(
            "serving_lora_host_tier_bytes",
            "bytes of registered adapters NOT currently resident on "
            "device (host-DRAM registry tier awaiting an LRU swap-in)")
        self._lora_swaps_seen = 0
        monitor.info(
            "serving_tp_degree",
            "tensor-parallel degree of the most recent engine").set(1)
        monitor.counter(
            "serving_tp_collective_bytes",
            "cross-shard collective payload executed per engine step "
            "(per-shard bytes; 0 until tensor-parallel serving)")
        pool_bytes = self._kv_pool_bytes
        if self._dpools is not None:
            pool_bytes += _pc.pool_bytes(self._dpools)
        self._pool_bytes_per_shard = pool_bytes
        monitor.gauge(
            "serving_tp_pool_bytes_per_shard",
            "KV block-pool bytes each shard holds (kv_head slice)").set(
            pool_bytes)
        monitor.info(
            "serving_kv_cache_dtype",
            "KV block-pool storage dtype of the most recent engine "
            "(int8 = quantized pool + absmax scales)").set(
            self._kv_dtype_name)
        monitor.gauge(
            "serving_kv_pool_bytes",
            "total KV block-pool bytes (all layers + scale pools, "
            "target and draft models, every shard)").set(pool_bytes)
        self._m_kv_step = monitor.gauge(
            "serving_kv_bytes_per_step",
            "analytic target-pool KV bytes the last engine tick's "
            "attention streamed from HBM (attended positions x bytes "
            "per cached position; int8 pools count data + scales)")
        self._m_kernels = monitor.gauge(
            "serving_kernels_per_tick",
            "kernel nodes of the last captured tick graph (the kernels "
            "one replay launches)")
        # -- the per-tick roofline: each layout's counted work (static
        # half) over its measured launch -> read-back time (EMA)
        self._kcensus: Dict[str, dict] = {}     # layout name -> census
        self._exec_cost: Dict[str, dict] = {}   # layout name -> cost
        self._step_time: Dict[str, float] = {}
        self._step_ticks: Dict[str, int] = {}
        self._last_exec = None          # the last committed tick's layout
        self._n_decode_compiles = 0     # tick graphs captured
        self._peak_flops = _acct.device_peak_flops(self.device)
        self._peak_hbm_bw = _acct.device_peak_hbm_bw(self.device)
        self._ridge = self._peak_flops / self._peak_hbm_bw
        self._cpu_proxy = self.device.type != "cuda"
        self._m_mfu = monitor.gauge(
            "serving_step_mfu",
            "per-tick model FLOPs utilization of the last tick's layout "
            "(counted FLOPs / measured launch->read-back time / the "
            "card's peak FLOPs; nominal peaks on the CPU — cpu_proxy)")
        self._m_bw_util = monitor.gauge(
            "serving_hbm_bw_util",
            "per-tick device-memory bandwidth utilization of the last "
            "tick's layout (counted bytes / measured launch->read-back "
            "time / the card's peak bytes/s; nominal peaks on the CPU "
            "— cpu_proxy)")
        self._prof = _tracing.ProfilerWindow()
        self._m_moe_load = monitor.histogram(
            "serving_moe_expert_load",
            "per-expert share of routed (token, slot) pairs per "
            "dispatch (0 = expert idle this step)",
            buckets=(0.001, 0.01, 0.05, 0.1, 0.2, 0.4, 0.6, 0.8, 1.0))
        self._m_moe_entropy = monitor.gauge(
            "serving_moe_routing_entropy",
            "decode-time routing entropy, normalized to [0, 1] by "
            "log(num_experts) (1 = perfectly balanced routing)")
        # -- the tracer: tid 0 the ticks, 1 + i slot i, the last the queue
        self._engine_id = next(_ENGINE_IDS)
        self._tid_queue = cfg.num_slots + 1
        self._trace = None
        if _tracing.tracing_enabled():
            tr = _tracing.Tracer(f"ServingEngine[{self._engine_id}]")
            tr.set_thread(0, "engine")
            for i in range(cfg.num_slots):
                tr.set_thread(1 + i, f"slot {i}")
            tr.set_thread(self._tid_queue, "queue")
            self._trace = tr
        # -- the SLO digests (always on, whatever the trace switch)
        self._d_ttft = LatencyDigest()
        self._d_itl = LatencyDigest()
        self._d_queue = LatencyDigest()
        self._d_e2e = LatencyDigest()
        self._last_emit: Dict[int, float] = {}
        self._m_host_gap = monitor.gauge(
            "serving_host_gap_ms",
            "host time between consecutive tick dispatches (P2 "
            "digest; under async_depth=1 commit bookkeeping overlaps "
            "device execution, so the gap shrinks toward pure "
            "pack+launch time)", labels=("q",))
        self._m_accept = monitor.gauge(
            "serving_spec_accept_len",
            "accepted-length quantiles per slot verify window (P2 "
            "digest; tokens emitted = accepted drafts + bonus — tree "
            "and linear speculation both observe; empty on "
            "non-speculative engines)", labels=("q",))
        self._m_lat = {
            "ttft": monitor.gauge(
                "serving_ttft_ms",
                "time-to-first-token quantiles (P2 digest; submit -> "
                "first streamed token)", labels=("q",)),
            "itl": monitor.gauge(
                "serving_itl_ms",
                "inter-token latency quantiles (P2 digest; gap "
                "between consecutive streamed tokens of one request)",
                labels=("q",)),
            "queue_wait": monitor.gauge(
                "serving_queue_wait_quantile_ms",
                "queue-wait quantiles (P2 digest; terminal "
                "cancelled/rejected/shutdown outcomes included)",
                labels=("q",)),
            "e2e": monitor.gauge(
                "serving_e2e_ms",
                "submit -> retirement latency quantiles (P2 digest)",
                labels=("q",)),
        }
        self._n_evictions_seen = 0
        if gamma:
            self._m_spec_len = monitor.histogram(
                "serving_spec_accepted_len",
                "tokens emitted per slot verify window "
                "(accepted drafts + the correction/bonus token)",
                buckets=(1, 2, 3, 4, 5, 6, 7, 8, 9))
            self._m_spec_proposed = monitor.counter(
                "spec_tokens_proposed", "draft tokens proposed")
            self._m_spec_accepted = monitor.counter(
                "spec_tokens_accepted", "draft tokens accepted")
            self._m_spec_rate = monitor.gauge(
                "serving_spec_acceptance_rate",
                "accepted / proposed draft tokens (cumulative)")
        # -- the health engine: the gauges always, the monitor only when
        # on (PADDLE_TPU_HEALTH=0 beats the config)
        self._health_on = bool(cfg.health) \
            and os.environ.get("PADDLE_TPU_HEALTH", "1") != "0"
        self._m_health = monitor.gauge(
            "serving_health_score",
            "engine health in [0,1]: 1 - severity penalties of firing "
            "alerts (page 0.5, warn 0.15)")
        self._m_burn = monitor.gauge(
            "serving_slo_burn_rate",
            "fast-window SLO burn rate (violation fraction / error "
            "budget; 1.0 = budget consumed exactly on schedule)")
        self._m_alerts = monitor.gauge(
            "serving_alerts_firing", "number of currently-firing alerts")
        self._m_health.set(1.0)
        self._nonfinite_ticks = 0
        self._nf_last = False
        self._slo_ok: Dict[int, bool] = {}
        self._h_slo_ttft = float(cfg.health_slo_ttft_ms)
        self._h_slo_itl = float(cfg.health_slo_itl_ms)
        self._health = None
        if self._health_on:
            # the callbacks reach the engine through a weak reference: a
            # bound method would hold it in a cycle with its pools
            me = weakref.ref(self)
            profile_cb = None
            if int(cfg.health_profile_ticks) > 0:
                n_prof = int(cfg.health_profile_ticks)

                def profile_cb(n=n_prof):
                    try:
                        me().profile(n)
                    except Exception:
                        pass
            self._health = _health.HealthMonitor(
                slo_target=cfg.health_slo_target,
                burn_fast_s=cfg.health_burn_fast_s,
                burn_slow_s=cfg.health_burn_slow_s,
                burn_threshold=cfg.health_burn_threshold,
                burn_min_requests=cfg.health_burn_min_requests,
                watchdog_mult=cfg.health_watchdog_mult,
                watchdog_floor_s=cfg.health_watchdog_floor_s,
                # an incident's snapshot leaves the pipeline as it is
                stats_cb=lambda: me()._stats(),
                trace_cb=lambda: me()._health_trace(),
                profile_cb=profile_cb,
                incident=_health.IncidentCapture())

    def _health_trace(self):
        """Chrome-trace dict for incident bundles (None w/o a tracer)."""
        if self._trace is None:
            return None
        return {"traceEvents": list(self._trace.chrome_events()),
                "displayTimeUnit": "ms"}

    # -- front door ----------------------------------------------------

    def load_adapter(self, adapter_id, weights) -> int:
        """Register (or hot-reload) LoRA adapter ``adapter_id`` from a
        ``{module_name: (A, B)}`` dict: names qualified
        (``llama.layers.0.self_attn.q_proj``) or leaf (``q_proj``, every
        layer's), ``A [d_in, lora_rank]``, ``B [lora_rank, d_out]``. The
        weights stay in host memory and load onto the device when a
        request first needs them. Re-registering a resident adapter
        rewrites its stack rows in place, after the ticks already queued:
        requests seated under it read the new weights from the next tick
        on. Returns the id."""
        if self._lora is None:
            raise ValueError(
                "load_adapter requires a LoRA-serving engine "
                "(ServingConfig(lora_rank=...))")
        aid = self._lora.register(adapter_id, weights)
        self._sync_lora_metrics()
        return aid

    def adapter_resident(self, adapter_id) -> bool:
        """True while the adapter holds a device stack row: a request
        under it seats without loading it."""
        return self._lora is not None and self._lora.resident(adapter_id)

    def submit(self, prompt, max_new_tokens=None, temperature=None,
               top_k=None, top_p=None, priority=0, max_queue_wait_ms=None,
               adapter_id=None) -> int:
        """Queue one request; returns its request id. ``temperature`` /
        ``top_k`` / ``top_p`` override the config for this request
        (sampling engines only). ``priority`` is its scheduling class
        (higher admits first and may preempt strictly lower classes;
        ignored without preemption); ``max_queue_wait_ms`` bounds its
        queue wait (default: the config's): still queued past it, it ends
        with an empty result. ``adapter_id`` decodes the request under a
        LoRA adapter registered by :meth:`load_adapter` (None: the base
        model). At the config's ``shed_queue_depth`` ``submit`` raises
        :class:`QueueShedError` (a ``shed`` queue-wait observation); a
        request refused by validation lands a ``rejected`` one."""
        t0 = time.monotonic()
        if self._shed_depth is not None \
                and len(self._queue) >= int(self._shed_depth):
            self._n_shed += 1
            self._m_queue_wait.labels(outcome="shed").observe(0.0)
            self._d_queue.observe(0.0)
            if self._trace is not None:
                self._trace.instant("shed", tid=self._tid_queue,
                                    args={"queued": len(self._queue)})
            raise QueueShedError(
                f"admission queue at shed threshold ({len(self._queue)} >= "
                f"{int(self._shed_depth)}): request refused (load "
                "shedding)")
        try:
            ids, max_new, max_queue_wait_ms, adapter_id = \
                self._validate_request(prompt, max_new_tokens, temperature,
                                       top_k, top_p, priority,
                                       max_queue_wait_ms, adapter_id)
        except ValueError:
            wait = 1000.0 * (time.monotonic() - t0)
            self._m_queue_wait.labels(outcome="rejected").observe(wait)
            self._d_queue.observe(wait)
            if self._trace is not None:
                self._trace.instant("rejected", tid=self._tid_queue)
            raise
        rid = self._next_rid
        self._next_rid += 1
        req = ServingRequest(
            rid, ids, max_new, time.monotonic(),
            temperature=None if temperature is None else float(temperature),
            top_k=None if top_k is None else int(top_k),
            top_p=None if top_p is None else float(top_p),
            priority=int(priority),
            max_queue_wait_ms=None if max_queue_wait_ms is None
            else float(max_queue_wait_ms), adapter_id=adapter_id)
        self._queue.append(req)
        self._submit_t[rid] = req.submit_time
        if self._trace is not None:
            self._trace.instant(
                "submit", tid=self._tid_queue,
                args={"rid": rid, "prompt_tokens": int(ids.size),
                      "max_new": max_new, "priority": int(priority)})
        return rid

    def _validate_request(self, prompt, max_new_tokens, temperature, top_k,
                          top_p, priority, max_queue_wait_ms, adapter_id):
        """``submit``'s checks; returns the prompt ids, the token budget,
        the queue-wait budget and the adapter id, or raises
        ``ValueError``."""
        ids = np.asarray(prompt, np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty prompt")
        max_new = int(self.config.max_new_tokens if max_new_tokens is None
                      else max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if ids.size + max_new > self.config.max_model_len:
            raise ValueError(
                f"prompt ({ids.size}) + max_new_tokens ({max_new}) "
                f"exceeds max_model_len ({self.config.max_model_len})")
        worst = self._worst_for(ids.size, max_new)
        if worst > self._alloc.num_blocks - 1:
            raise ValueError(f"request needs {worst} blocks; pool has only "
                             f"{self._alloc.num_blocks - 1}")
        if any(v is not None for v in (temperature, top_k, top_p)) \
                and not self._do_sample:
            raise ValueError(
                "per-request temperature/top_k/top_p require "
                "decode_strategy='sampling' (this engine decodes "
                f"{self.config.decode_strategy!r})")
        if temperature is not None and float(temperature) < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and int(top_k) < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if isinstance(priority, bool) or not isinstance(
                priority, (int, np.integer)):
            raise ValueError(f"priority must be an int, got {priority!r}")
        if max_queue_wait_ms is None:
            max_queue_wait_ms = self._default_qwait
        if max_queue_wait_ms is not None \
                and float(max_queue_wait_ms) <= 0.0:
            raise ValueError(
                f"max_queue_wait_ms must be > 0 (or None), got "
                f"{max_queue_wait_ms}")
        if adapter_id is not None:
            if self._lora is None:
                raise ValueError(
                    "adapter_id requires a LoRA-serving engine "
                    "(ServingConfig(lora_rank=...)); this engine serves "
                    "the base model only")
            adapter_id = int(adapter_id)
            if not self._lora.known(adapter_id):
                raise ValueError(
                    f"unknown adapter_id {adapter_id}: register it with "
                    "load_adapter() before submitting against it")
        return ids, max_new, max_queue_wait_ms, adapter_id

    def cancel(self, request_id: int) -> bool:
        """Cancel a request anywhere in its life. Queued: removed (a
        preempted one surfaces the tokens it already streamed). Seated:
        retired at once, its blocks freed unpublished (a cancelled
        stream's continuation must not seed the prefix cache), its tokens
        so far in ``run()``'s results. Returns False when the id is
        unknown (never submitted, finished or already cancelled)."""
        self._flush_pipe()      # commit the in-flight tick first
        for k, req in enumerate(self._queue):
            if req.request_id == request_id:
                del self._queue[k]
                self._queue_exit(req, "cancelled")
                self._finish_unserved(req)
                return True
        for i, s in enumerate(self._slots):
            if s is not None and s.rid == request_id:
                self._cancel_slot(i)
                return True
        return False

    def _finish_unserved(self, req, record_empty=False):
        """A request leaving the queue unserved (cancel, timeout): drop
        its spilled payload, and surface what it already streamed (a
        preempted request's tokens, whose end the e2e digest observes;
        ``record_empty``: an empty result for a request that never
        started)."""
        rid = req.request_id
        if req.resume is not None:
            if self._host_tier is not None:
                self._host_tier.pop(("victim", rid), restore=False)
                self._m_host_bytes.set(self._host_tier.bytes_used)
            self._submit_t.pop(rid, None)
            self._d_e2e.observe(
                1000.0 * (time.monotonic() - req.submit_time))
        self._slo_ok.pop(rid, None)
        self._last_emit.pop(rid, None)
        toks = self._results.pop(rid, None)
        if self.config.retain_results and (
                toks is not None or record_empty):
            self._done[rid] = np.asarray(toks or [], np.int64)

    def _cancel_slot(self, i):
        """Retire slot ``i`` for ``cancel()``: no completion and no
        publishing; its blocks are freed and its tokens so far
        surfaced."""
        slot = self._slots[i]
        now = time.monotonic()
        t0 = self._submit_t.pop(slot.rid, None)
        if t0 is not None:
            self._d_e2e.observe(1000.0 * (now - t0))
        self._slo_ok.pop(slot.rid, None)    # cancels don't burn budget
        self._last_emit.pop(slot.rid, None)
        if self._trace is not None:
            self._trace.emit(
                f"req{slot.rid}", tid=1 + i, t0=slot.admit_t, t1=now,
                args={"tokens": slot.n_emitted,
                      "cache_len": slot.cache_len, "cancelled": True})
            self._trace.instant("cancelled", tid=1 + i,
                                args={"rid": slot.rid})
        self._vacate(i)
        toks = self._results.pop(slot.rid, [])
        if self.config.retain_results:
            self._done[slot.rid] = np.asarray(toks, np.int64)
        self._n_cancelled += 1
        self._m_occupancy.set(self.num_active)

    def _queue_exit(self, req, outcome: str) -> float:
        """The queue-wait observation of every way a request leaves the
        queue (admitted, resumed, cancelled, timeout, shutdown; submit
        observes rejected and shed itself), so neither the histogram nor
        the digest favours the admitted."""
        now = time.monotonic()
        wait = 1000.0 * (now - req.submit_time)
        self._m_queue_wait.labels(outcome=outcome).observe(wait)
        self._d_queue.observe(wait)
        if outcome not in ("admitted", "resumed"):
            # it will never emit or retire (a resumed one keeps its
            # submit time for the e2e digest)
            self._submit_t.pop(req.request_id, None)
        if self._trace is not None:
            self._trace.emit(
                f"req{req.request_id} queued", tid=self._tid_queue,
                t0=req.submit_time, t1=now, args={"outcome": outcome})
        return wait

    def queue_depth(self, priority=None):
        """Queued plus seated requests. With ``priority`` (and preemption
        on) lower-priority work counts 0.25: an arrival of that class can
        preempt or pass it."""
        if priority is None or not self._preempt_on:
            return self.num_queued + self.num_active
        w = 0.0
        for r in self._queue:
            w += 1.0 if r.priority >= priority else 0.25
        for s in self._slots:
            if s is not None:
                w += 1.0 if s.priority >= priority else 0.25
        return w

    def published_overlap(self, hashes) -> int:
        """The leading run of ``hashes`` (:func:`~paddle_tpu_torch.ops.
        paged_cache.prompt_block_hashes`) this engine holds, in its index
        or its host tier: the blocks of that prompt it would not prefill.
        0 with the prefix cache off."""
        if not self._prefix_on:
            return 0
        n = 0
        for h in hashes:
            if self._alloc.lookup(h) is None and not (
                    self._host_tier is not None
                    and ("pub", h) in self._host_tier):
                break
            n += 1
        return n

    def purge_published(self) -> int:
        """Forget every published block, in the index and in the host
        tier, so ``published_overlap()`` scores 0 from now on. Returns
        the entries dropped."""
        n = self._alloc.unpublish_all()
        if self._host_tier is not None:
            n += self._host_tier.purge_published()
        return n

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def num_queued(self) -> int:
        return len(self._queue)

    def run(self) -> Dict[int, np.ndarray]:
        """Drive ``step()`` until queue and slots drain; returns (and
        drains) the tokens of every request completed since the last
        ``run()``, keyed by request id."""
        while self._queue or self.num_active:
            self.step()
        self._flush_pipe()
        done, self._done = self._done, {}
        return done

    def serve(self, prompts, max_new_tokens=None) -> List[np.ndarray]:
        """Submit all, run to completion, return token arrays in
        submission order."""
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        done = self.run()
        return [done[r] for r in rids]

    def stats(self) -> dict:
        """Scheduler and telemetry snapshot: every key of the reference
        engine's ``stats()`` (its features this port has not brought up
        at their off values) and the port's own (``ticks``,
        ``kernel_launches``, the async pipeline's). Commits the in-flight
        tick first."""
        self._flush_pipe()
        return self._stats()

    def _stats(self) -> dict:
        self._sync_cache_metrics()
        census = self._kcensus.get(self._last_exec, {})
        out = {
            "active": self.num_active,
            "queued": self.num_queued,
            "free_blocks": self._alloc.free_blocks,
            "reserved_blocks": self._reserved,
            "decode_steps": self._n_ticks,
            # tick graphs captured (the reference's one compile of its
            # tick executable), or the per-width decode / verify step's
            "decode_compiles": self._n_decode_compiles,
            "prefill_compiles": self._n_prefill_compiles,
            "ticks": self._n_ticks,
            "rows_total": self._n_rows,
            "tokens_total": self._n_tokens,
            "requests_completed": self._n_completed,
            "prefill_chunks": self._n_prefill_chunks,
            "fused_decode": bool(self.config.fused_decode),
            "fused_decode_mode": "kernel" if self.config.fused_decode
            else "off",
            "device": str(self.device),
            "kernel_launches": dict(launch_counts),
            # the port has no fallback off its kernels
            "kernel_fallbacks": 0,
            # the last tick's layout: its graph's kernel nodes (0 on the
            # CPU, which captures none) and its counted launches
            "kernels_per_tick": census.get("kernel_nodes", 0),
            "kernel_launch_proxy_per_tick": census.get("launch_proxy", 0),
            "ragged_batch": self._ragged,
            "chunked_prefill": self._chunked,
            # the cluster's and tensor parallelism's keys, at their off
            # values until those slices
            "role": "both",
            "prefills_exported": 0,
            "kv_blocks_exported": 0,
            "kv_blocks_imported": 0,
            "sessions_migrated_out": 0,
            "sessions_migrated_in": 0,
            "tp_degree": 1,
            "tp_collective_bytes_per_step": 0,
            "tp_collective_bytes_total": 0,
            "tp_pool_bytes_per_shard": self._pool_bytes_per_shard,
            # MoE keys are always present (False / 0 for dense models)
            "moe": self._moe,
            "moe_fused_gmm": self._moe_fused,
            "moe_dispatches": self._n_moe_dispatches,
            "moe_routing_entropy": self._moe_ent_last,
            "moe_expert_load_max": self._moe_load_max_last,
            # the KV pool's keys are present whatever its dtype
            "kv_cache_dtype": self._kv_dtype_name,
            "kv_pool_bytes": self._kv_pool_bytes,
            "kv_bytes_per_step": self._kv_step_bytes_last,
            # tracing, profiling, the roofline and the SLO digests (each
            # *_ms a P2 summary {count, mean, min, max, p50, p95, p99})
            "engine_id": self._engine_id,
            "tracing": self._trace is not None,
            "trace_events": len(self._trace)
            if self._trace is not None else 0,
            "trace_events_dropped": self._trace.dropped
            if self._trace is not None else 0,
            "profile_captures": self._prof.captures,
            "profile_ticks_remaining": self._prof.pending,
            "roofline": self._roofline(),
            "ttft_ms": self._d_ttft.summary(),
            "itl_ms": self._d_itl.summary(),
            "queue_wait_ms": self._d_queue.summary(),
            "e2e_ms": self._d_e2e.summary(),
            # the health keys (1.0 / zeros with the health engine off)
            "health_score": self._health.score()
            if self._health is not None else 1.0,
            "alerts_firing": len(self._health.firing())
            if self._health is not None else 0,
            "alerts_fired_total": self._health.fired_total
            if self._health is not None else 0,
            "incidents_captured": self._health._incident.captured
            if self._health is not None
            and self._health._incident is not None else 0,
            "nonfinite_logits_ticks": self._nonfinite_ticks,
            # always present (0 on linear and non-speculative engines; the
            # digest of tokens a verify window zeroed without speculation)
            "spec_tree_nodes": len(self._tree) + 1 if self._tree else 0,
            "spec_accept_len": self._d_accept.summary(),
            # the async pipeline's keys, present on sync engines too
            # (their host gap includes the blocking read-back)
            "async_depth": int(self._async_on),
            "pipeline_flushes": self._n_pipe_flushes,
            "host_gap_ms": self._d_host_gap.summary(),
            "pure_ticks": self._n_pure,
            "pipelined_ticks": self._n_pipelined,
            # every step built: each tick layout's CUDA graph (none on the
            # CPU), and each per-width or bucketed prefill step (its graph,
            # or on the CPU its first counted run)
            "executables_compiled": self._n_exec_compiled,
            # the prefix cache's and the scheduler's keys, present (False
            # / 0) with either feature off
            "prefix_cache_enabled": self._prefix_on,
            "prefix_blocks_reused": self._n_prefix_blocks,
            "prefix_tokens_reused": self._n_prefix_tokens,
            "prefix_hit_rate":
                self._n_prefix_tokens / self._n_prompt_tokens
                if self._n_prompt_tokens else 0.0,
            "cow_copies": self._n_cow,
            "cache_evictions": self._alloc.evictions,
            "cached_blocks": self._alloc.cached_blocks,
            "preemption_enabled": self._preempt_on,
            "preemptions": self._n_preempt,
            "kv_blocks_spilled": self._n_spilled,
            "kv_blocks_restored": self._n_restored,
            "host_tier_bytes": self._host_tier.bytes_used
            if self._host_tier is not None else 0,
            "host_tier_capacity_bytes": self._host_tier.capacity
            if self._host_tier is not None else 0,
            "preempt_swap_resumes": self._n_swap_resumes,
            "preempt_recompute_resumes": self._n_recompute_resumes,
            "prefill_rows_per_s_est": round(self._prefill_rows_s, 3),
            "host_xfer_bytes_per_s_est": round(self._xfer_bytes_s, 1),
            "requests_shed": self._n_shed,
            "requests_timed_out": self._n_timeout,
            "requests_cancelled": self._n_cancelled,
            # the multi-LoRA keys, present (False / 0) without it
            "lora_enabled": self._lora is not None,
            "lora_adapters_resident": self._lora.n_resident
            if self._lora is not None else 0,
            "lora_adapter_swaps": self._lora.swaps
            if self._lora is not None else 0,
            "lora_host_tier_bytes": self._lora.host_tier_bytes
            if self._lora is not None else 0,
        }
        if self._gamma:
            out.update({
                "spec_tokens_proposed": self._n_spec_proposed,
                "spec_tokens_accepted": self._n_spec_accepted,
                "spec_acceptance_rate":
                    self._n_spec_accepted / self._n_spec_proposed
                    if self._n_spec_proposed else 0.0,
                "spec_mean_accepted_len":
                    self._n_spec_emitted / self._n_spec_verifies
                    if self._n_spec_verifies else 0.0,
            })
        return out

    def shutdown(self, check_leaks: bool = True) -> bool:
        """Drop queued requests and sweep the allocator's invariants
        (every block free, cached or owned by a live slot, the hash index
        bijective). Requests still queued leave with a ``shutdown``
        queue-wait observation."""
        self._flush_pipe()
        while self._queue:
            self._queue_exit(self._queue.popleft(), "shutdown")
        self._sync_cache_metrics()
        if check_leaks:
            live = [b for s in self._slots if s is not None
                    for b in s.blocks]
            self._alloc.check_leaks(live)
        return True

    # -- telemetry -----------------------------------------------------

    def health(self) -> Optional[dict]:
        """Health snapshot: score, firing alerts, burn rates, per-alert
        state and the recent transition journal. None with the health
        engine off (``health=False`` or ``PADDLE_TPU_HEALTH=0``)."""
        if self._health is None:
            return None
        return self._health.snapshot()

    def watchdog_stuck(self) -> bool:
        """The stuck-tick watchdog's probe: True when the last tick that
        captured no graph outran ``max(floor, mult x`` its layout's time
        EMA``)``. False with the health engine off."""
        if self._health is None:
            return False
        return self._health.watchdog_check(
            self._step_time.get(self._last_exec, 0.0))

    @property
    def tracer(self):
        """This engine's span tracer, or None when tracing is disabled
        (``PADDLE_TPU_TRACE=0``)."""
        return self._trace

    def dump_trace(self, path: str):
        """Write this engine's request-lifecycle trace as Chrome
        trace-event JSON (load it at https://ui.perfetto.dev or
        chrome://tracing). Returns the path written, or None when
        tracing is disabled."""
        if self._trace is None:
            return None
        return self._trace.dump_chrome_trace(path)

    def kernel_census(self) -> dict:
        """``{layout name: census}`` of every tick layout run so far
        (:func:`~paddle_tpu_torch.monitor.accounting.kernel_census`): on
        CUDA the node census of its captured graph (``graph_nodes`` by
        type, ``kernel_nodes``, ``kernel_names``) beside the launches
        counted in its warm-up (``launch_proxy``, ``launch_by_op``; the
        hand-written kernels by counter name in ``kernels``, each also
        what one replay adds to ``launch_counts``). Raises for a graphed
        engine whose PyTorch cannot keep a captured graph to read
        (``CUDAGraph(keep_graph=True)``) rather than report a count it
        did not read."""
        steps = [(lay.name(self._gamma), gr.step)
                 for lay, gr in self._graphs.items()]
        steps += [(name, st.graph) for name, st in self._pw.items()
                  if st.graph is not None]
        for name, step in steps:
            if step.census is None:
                raise RuntimeError(
                    f"no node census of layout {name}: "
                    "this PyTorch cannot "
                    "keep a captured CUDA graph (CUDAGraph(keep_graph=True))"
                    " to read its nodes")
        return {k: dict(v) for k, v in self._kcensus.items()}

    def profile(self, n_ticks: int, path: Optional[str] = None):
        """Arm a ``torch.profiler`` capture around the next ``n_ticks``
        ticks (:class:`~paddle_tpu_torch.monitor.tracing.ProfilerWindow`:
        one Chrome trace under ``path``, default
        ``$PADDLE_TPU_PROFILE_DIR``; on CUDA the kernels the graphs
        replay appear by name). Returns the capture dir, or None under
        ``PADDLE_TPU_TRACE=0``; raises while a window is armed."""
        return self._prof.arm(n_ticks, path)

    # -- one tick ------------------------------------------------------

    def step(self) -> List[tuple]:
        """One engine tick: admit what fits, run ONE ragged batch over
        every decoding slot's row (its verify window when speculating)
        and this tick's prefill rows, commit tokens and retire finished
        requests. Returns the ``[(request_id, token), ...]`` committed in
        this call; under ``async_depth=1`` a pure decode tick's tokens
        come with the next call (or with the flush that ``run()``,
        ``stats()`` and ``shutdown()`` begin with). An armed profiling
        window brackets the tick; the health engine takes its signals
        after it."""
        prof = self._prof
        if self._health is None:
            if not prof.pending:
                return self._step_once()
            with prof.tick():
                return self._step_once()
        t0 = time.monotonic()
        c0 = self._n_exec_compiled
        if not prof.pending:
            out = self._step_once()
        else:
            with prof.tick():
                out = self._step_once()
        self._health_tick(t0, time.monotonic(), c0)
        return out

    def _step_once(self) -> List[tuple]:
        if not self._ragged:
            return self._step_per_width()
        if self._async_on:
            return self._step_async()
        emitted: List[tuple] = []
        pipe = self._dispatch(emitted)
        if pipe is not None:
            emitted.extend(self._commit(pipe))
        return emitted

    def _health_tick(self, t0, t1, c0):
        """Feed one tick's signals to the health monitor (host only): a
        tick that captured a graph is the reference's compiling tick."""
        h = self._health
        nf = self._nf_last
        self._nf_last = False
        if nf:
            self._nonfinite_ticks += 1
        h.on_tick(
            tick_s=t1 - t0,
            queued=len(self._queue),
            step_ema_s=self._step_time.get(self._last_exec, 0.0),
            fallbacks=0,
            compiles=self._n_exec_compiled,
            spec_emitted=self._n_spec_emitted,
            spec_verifies=self._n_spec_verifies,
            preemptions=self._n_preempt,
            completed=self._n_completed,
            nonfinite=nf,
            compiled=self._n_exec_compiled > c0)
        self._m_health.set(h.score())
        self._m_burn.set(h._last_burn.get("fast", 0.0))
        self._m_alerts.set(float(len(h.firing())))

    def _dispatch(self, emitted) -> Optional[_Pipe]:
        """Dispatch half of one tick: admit (a bucketed prefill emits its
        first tokens into ``emitted`` here), pack the tick's rows into one
        int64 vector (:class:`_Layout`), upload it and launch the forward
        and its sampling. Returns the in-flight tick, or None when no slot
        has work."""
        t_tick = time.monotonic()
        self._admit(emitted)
        cfg = self.config
        g = self._gamma
        n_slots = cfg.num_slots
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.pend_pos is None]
        pending = [i for i, s in enumerate(self._slots)
                   if s is not None and s.pend_pos is not None]
        if not active and not pending:
            return None
        if active:
            # room for this tick's writes; growth in an overcommitted pool
            # may preempt, so only the survivors decode
            active = self._ensure_blocks(active, horizon=g + 1)
        # a growth preemption may have taken a pending slot
        pending = [i for i in pending if self._slots[i] is not None]
        if not active and not pending:
            return None
        if self._preempt_on and len(pending) > 1:
            # the prefill budget goes to the highest class first, FIFO
            # within a class
            pending.sort(key=lambda i: (-self._slots[i].priority,
                                        self._slots[i].admit_t, i))

        # -- pack the tick's work into per-slot row counts --------------
        q_lens = np.zeros(n_slots, np.int64)
        base = np.zeros(n_slots, np.int64)
        given = {}              # slot -> prefill rows granted this tick
        cap = min(self._chunk, self._prefill_rows)
        budget = self._prefill_rows
        for i in active:
            q_lens[i] = g + 1
            base[i] = self._slots[i].cache_len
        for i in pending:
            if budget <= 0:
                break
            slot = self._slots[i]
            # ONE chunk-width slot per tick; later pending slots trickle
            # at the decode width (gamma + 1), so nothing starves
            cap_i = cap if not given else g + 1
            k = min(int(slot.prompt.size) - slot.pend_pos, cap_i, budget)
            if k <= 0:
                continue
            q_lens[i] = k
            base[i] = slot.pend_pos
            given[i] = k
            budget -= k
        total = int(q_lens.sum())
        if not total:
            return None
        # a tick with prefill rows packs to the static width (pad rows at
        # the overflow position); a pure tick packs its live rows
        mixed = bool(given)
        r = self._rows if mixed else total
        row_slot, row_pos, row_starts, last_rows = _pc.ragged_row_meta(
            q_lens, base, r, self._overflow)
        ids = np.full(r, self._pad, np.int32)
        for i, k in given.items():
            s0 = int(row_starts[i])
            slot = self._slots[i]
            ids[s0:s0 + k] = slot.prompt[slot.pend_pos:slot.pend_pos + k]
        for i in active:
            ids[row_starts[i]] = self._slots[i].last_token
        n_act = len(active) if g else 0     # slots verifying a window
        carry = self._async_on and not g and not mixed
        srows = [base, q_lens, row_starts, last_rows]
        if n_act and self._tree is not None:
            flags = np.zeros(n_slots, np.int64)
            flags[active] = 1           # prefill rows keep the linear bound
            srows.append(flags)
        if self._lora is not None:
            srows.append(self._slot_adapter)
        if mixed and self._draft is not None:
            # the draft model's prime lengths: the prefill rows only
            prime = np.zeros(n_slots, np.int64)
            for i, k in given.items():
                prime[i] = k
            srows.append(prime)
        if carry:
            # each slot's token budget left: the carry's done mask
            bud = np.zeros(n_slots, np.int64)
            for i in active:
                bud[i] = self._slots[i].max_new - self._slots[i].n_emitted
            srows.append(bud)
        lay = _Layout(rows=r, w_max=self._wmax if mixed
                      else int(q_lens.max()), srows=len(srows),
                      active=n_act, pure=not mixed, carry=carry)
        self._sync_uploads()
        spec = self._spec_pack(active, ids, row_starts) if n_act else []
        pack = np.concatenate([np.asarray(p, np.int64).reshape(-1) for p
                               in [ids, row_slot, row_pos] + srows + spec])
        with torch.no_grad():
            pipe = self._run(lay, pack=pack)
        pipe.active, pipe.given = active, given
        # names at dispatch: a slot re-seated before the commit drops the
        # stale token
        pipe.rid_of = {i: self._slots[i].rid for i in active + list(given)}
        pipe.t_tick, pipe.q_lens, pipe.n_pending = t_tick, q_lens, \
            len(pending)
        if self._trace is not None:
            pipe.pend_pos0 = {i: int(self._slots[i].pend_pos)
                              for i in given}
        self._n_ticks += 1
        self._n_rows += total
        self._m_steps.inc()
        self._m_util.observe(len(active) / n_slots)
        # packed row t of slot s attends base[s] + t + 1 positions
        self._note_kv_read(int((q_lens * base).sum())
                           + int((q_lens * (q_lens + 1) // 2).sum()))
        return pipe

    def _spec_pack(self, active, ids, row_starts) -> list:
        """The verifying slots' part of a tick's vector: the slots, then
        their windows ``[last token, gamma drafts]`` (host drafters: the
        n-gram or tree drafts, also written into the window rows of
        ``ids``), or, for the draft model, whose loop runs on the device,
        the last tokens and the window rows its drafts go to."""
        g = self._gamma
        act = np.asarray(active, np.int64)
        cur = np.asarray([self._slots[i].last_token for i in active],
                         np.int64)
        if self._draft is not None:
            widx = (row_starts[act].astype(np.int64)[:, None]
                    + np.arange(1, g + 1)[None, :]).reshape(-1)
            return [act, cur, widx]
        toks = np.empty((len(active), g + 1), np.int64)
        toks[:, 0] = cur
        for k, i in enumerate(active):
            hist = self._slots[i].history
            toks[k, 1:] = self._tree_draft(i) if self._tree is not None \
                else _spec.ngram_propose(hist, g, self._ngram_max)
            s0 = int(row_starts[i])
            ids[s0 + 1:s0 + g + 1] = toks[k, 1:]
        return [act, toks]

    def _run(self, lay, pack=None, carry=None) -> _Pipe:
        """Launch one tick of layout ``lay`` from the host's ``pack`` or,
        pipelined, from the ``carry`` vector the in-flight tick wrote. On
        CUDA the tick replays its layout's graph (the layout's first tick
        runs eagerly and captures it); on the CPU, or with ``cuda_graphs``
        off, it runs its body eagerly. An async pure decode tick's
        read-back is enqueued here."""
        t = time.monotonic()
        if self._last_dispatch_t is not None:
            self._d_host_gap.observe(1000.0 * (t - self._last_dispatch_t))
        self._last_dispatch_t = t
        self._n_pure += lay.pure
        timed = True
        if self._graphs_ok and self.cuda_graphs:
            gr = self._graphs.get(lay)
            if gr is None:
                inp, outs = self._capture(lay, pack)
                timed = False
            else:
                if pack is not None:
                    gr.inp.write(pack)
                gr.step.replay()
                inp, outs = gr.inp.dev, gr.outs
        else:
            inp = carry if pack is None \
                else torch.from_numpy(pack).to(self.device)
            if lay in self._lay_names:
                outs = self._tick_body(inp, lay)
            else:
                # a layout's first eager tick: count its work
                self._lay_names[lay] = lay.name(self._gamma)
                _, _, outs = self._build(self._lay_names[lay],
                                         lambda: self._tick_body(inp, lay))
                timed = False
        if self._moe and _moe.MOE_STATS["grouped_mm_kernel"] == "fused_gmm":
            self._moe_fused = True
        self.last_logits = outs.logits
        pipe = _Pipe(outs=outs, layout=lay, carry=inp if lay.carry else None,
                     t0=t, timed=timed)
        if lay.carry and outs.flat.is_cuda:
            # the one read-back, without blocking; the next replay of the
            # graph writes the same flat, after this copy
            pipe.host = torch.empty(outs.flat.shape, dtype=outs.flat.dtype,
                                    pin_memory=True)
            pipe.host.copy_(outs.flat, non_blocking=True)
            pipe.event = torch.cuda.Event()
            pipe.event.record()
        return pipe

    def _capture(self, lay, pack):
        """The first tick of a layout on CUDA: upload its vector into the
        graph's input (kept for the graph's life) and build the tick over
        it (:meth:`_build`); later ticks of ``lay`` replay the graph.
        Returns the warm-up's ``(input, outputs)``."""
        inp = _Upload(pack.shape, torch.int64, self.device)
        inp.write(pack)
        self._lay_names[lay] = lay.name(self._gamma)
        step, static, outs = self._build(
            self._lay_names[lay], lambda: self._tick_body(inp.dev, lay))
        self._graphs[lay] = _TickGraph(step, inp, static)
        self._n_decode_compiles += 1
        self._n_exec_compiled += 1
        self._m_decode_compiles.inc()
        return inp.dev, outs

    def _build(self, name, body):
        """Build step ``name`` (a tick layout or a per-width step) from
        ``body()``. On CUDA with graphs on, ``body`` runs eagerly on the
        capture stream (the warm-up: kernels set their attributes,
        per-stream scratch grows), counted by
        :class:`~paddle_tpu_torch.monitor.accounting.CostRecorder`, then
        the same body is captured into the engine's one memory pool
        (:func:`~paddle_tpu_torch.ops.cuda_graphs.capture`: the host
        counts the capture bumped become what each replay adds); a
        capture that fails raises. Otherwise the counted eager run is all.
        The warm-up's data-dependent counts are read back here, once a
        step, outside any graph, into its census. Returns ``(graph or
        None, the graph's outputs or None, the warm-up's outputs)``."""
        if not (self._graphs_ok and self.cuda_graphs):
            with _acct.CostRecorder() as rec:
                outs = body()
            self._note_census(name, rec.result(), None)
            return None, None, outs
        dev = self.device
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        cs = capture_stream(dev)
        cs.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(cs), _acct.CostRecorder() as rec:
            outs = body()
        step, static = _capture_graph(body, cs, self._graph_pool,
                                      self._gen if self._do_sample else None)
        torch.cuda.current_stream(dev).wait_stream(cs)
        self._note_census(name, rec.result(), step.census)
        return step, static, outs

    def _note_census(self, name, record, graph):
        """A layout's or a per-width step's kernel census and cost, from
        its warm-up's record and (on CUDA) its captured graph's nodes."""
        self._kcensus[name] = _acct.kernel_census(record, graph)
        self._exec_cost[name] = _acct.executable_cost(record)
        if graph is not None:
            self._m_kernels.set(graph["kernel_nodes"])

    def _tick_body(self, inp, lay) -> _TickOut:
        """The device half of a tick, from its packed vector ``inp``: the
        draft model's prime over the prefill rows and its loop, the ragged
        forward, sampling or acceptance, the heads' next drafts and, for a
        carry layout, the next tick's packs written over ``inp``. It reads
        nothing back, uploads nothing and takes every shape from ``lay``,
        so it is what the layout's graph captures."""
        cfg = self.config
        g = self._gamma
        n_slots = cfg.num_slots
        dev = self.device
        r, a = lay.rows, lay.active
        o = 3 * r + lay.srows * n_slots
        rows = inp[:3 * r].view(3, r).to(torch.int32)
        slots = inp[3 * r:o].view(lay.srows, n_slots).to(torch.int32)
        if not lay.pure and self._draft is not None:
            self._prime_draft(rows, slots, lay)
        act = toks = dq = None
        if a:
            act = inp[o:o + a]
            if self._draft is None:
                toks = inp[o + a:o + a + a * (g + 1)].view(a, g + 1)
            else:
                # the draft model's gamma + 1 steps over the verifying
                # slots; its drafts go into their window rows
                cur = inp[o + a:o + 2 * a]
                with self._draft_scope():
                    props, dq, self._dpools = self._dloop(
                        self._dpools, self._tables_dev[act], slots[0][act],
                        cur, self._samp()[act], self._gen)
                toks = torch.cat([cur[:, None], props.long()], 1)
                rows[0].index_copy_(0, inp[o + 2 * a:o + 2 * a + a * g],
                                    props.reshape(-1).to(rows.dtype))
        tree_on = bool(a) and self._tree is not None
        meta = (slots[1], slots[2], rows[1], rows[2], lay.w_max)
        take = slots[3]
        if a:
            # one LM head over each slot's continuation row and window
            take = torch.cat([slots[3][:, None], slots[2][:, None]
                              + torch.arange(g + 1, device=dev,
                                             dtype=torch.int32)[None, :]],
                             1).reshape(-1).clamp(0, r - 1)
        counts = []                     # each sparse layer's expert counts
        tap = _moe.serving_stats_tap(counts) if self._moe_tap_on \
            else contextlib.nullcontext()
        # pad rows and a pipelined tick's parked rows route but are no
        # traffic
        mask = _moe.serving_rows_mask(rows[2] < self._overflow) \
            if self._moe_tap_on and (lay.carry or not lay.pure) \
            else contextlib.nullcontext()
        # a flagged slot's rows are its window's g + 1
        scope = spec_tree_scope(self._tree, slots[4], g + 1) if tree_on \
            else contextlib.nullcontext()
        if self._moe:
            _moe.MOE_STATS["grouped_mm_kernel"] = None
        heads_on = bool(a) and self._heads is not None
        # each packed row takes its slot's adapter row (pad rows slot 0's)
        lora = contextlib.nullcontext() if self._lora is None else \
            _lora.serving_lora_scope(
                self._lora.operand(), slots[4 + tree_on][rows[1].long()],
                self._lora.scaling)
        with tap, mask, scope, lora:
            logits, self._pools = self.model(
                rows[0], caches=self._pools, block_tables=self._tables_dev,
                cache_lens=slots[0], ragged_meta=meta, last_rows=take,
                fused=cfg.fused_decode,
                **({"return_hidden": True} if heads_on else {}))
        if heads_on:
            logits, hid = logits
        path = None
        if not a:
            tok = self._select(logits).long()
            parts = [tok]
        else:
            lg = logits.reshape(n_slots, g + 2, -1)
            first = self._select(lg[:, 0])
            samp = self._samp()[act] if self._do_sample else None
            f = _filter_logits(
                lg[act, 1:], do_sample=self._do_sample,
                **({} if samp is None else dict(
                    temperature=samp[:, 0], top_k=samp[:, 1],
                    top_p=samp[:, 2])))
            if self._tree is None:
                out, accept, _ = _spec.accept_from_filtered(
                    f, toks, dq, self._gen, gamma=g,
                    do_sample=self._do_sample)
            else:
                out, accept, _, path, n_acc = \
                    _spec.accept_tree_from_filtered(
                        f, toks, self._tree, self._gen,
                        do_sample=self._do_sample)
            parts = [first.long(), out.reshape(-1).long(),
                     accept.reshape(-1).long()]
            if self._tree is not None:
                parts.append(path.reshape(-1))
            if heads_on:
                parts.append(self._head_drafts(
                    hid.reshape(n_slots, g + 2, -1)[act], path,
                    n_acc).reshape(-1))
        if counts:      # one read-back for the tokens and the counts
            parts.append(torch.stack(counts).reshape(-1).long())
        # the health probe, last: any non-finite value in the logits the
        # tick samples from (a carry layout's live slots only: a parked
        # slot's row is a pad row)
        bad = ~torch.isfinite(logits)
        if lay.carry:
            bad = bad & (slots[1] > 0)[:, None]
        parts.append(bad.any().long().reshape(1))
        if lay.carry:
            self._write_carry(inp, rows, slots, tok, lay)
        return _TickOut(torch.cat(parts), logits, path, slots[0], act,
                        (len(counts), counts[0].numel()) if counts else None)

    def _draft_scope(self):
        """The draft loop's context in the ragged tick: the fused decode
        layer on its paged steps (``fused_decode``), as the reference
        traces its ragged draft step inside its fused scope. The tick body
        enters it, so it is armed while the tick's graph is captured."""
        return _df.paged_fused_scope() if self.config.fused_decode \
            else contextlib.nullcontext()

    def _prime_draft(self, rows, slots, lay):
        """Write the draft model's cache over a tick's prefill rows by its
        ragged forward at the tick's static width, as the reference's
        fused draft executable does: the verify rows park at the overflow
        position with the pad rows (their K/V come from the draft's
        loop), so only the prime lengths (the last per-slot row) own
        rows, each holding its prompt token."""
        plen = slots[lay.srows - 1]
        own = plen[rows[1].long()] > 0
        ids = torch.where(own, rows[0], self._pad)
        pos = torch.where(own, rows[2], self._overflow)
        _, self._dpools = self._draft(
            ids, caches=self._dpools, block_tables=self._tables_dev,
            cache_lens=slots[0],
            ragged_meta=(plen, slots[2], rows[1], pos, lay.w_max),
            last_rows=slots[2][:1], fused=self.config.fused_decode)

    def _write_carry(self, inp, rows, slots, tok, lay):
        """The next tick's packs over this decode tick's (the reference's
        in-executable carry): each live slot's token at its length + 1,
        its budget less one; a slot done by EOS or by its budget parks its
        row at the overflow position, so a pipelined tick's K/V write for
        it goes to the null block and its token is dropped at commit. The
        other per-slot rows (a LoRA engine's stack rows among them) carry
        over unchanged."""
        r, n_slots = lay.rows, self.config.num_slots
        base, q_lens, budget = (slots[0].long(), slots[1].long(),
                                slots[-1].long())
        live = q_lens > 0
        done = live & ((tok == self._eos) | (budget <= 1))
        nxt = torch.where(live, base + 1, base)
        rs = rows[1].long()
        park = done[rs]
        o = 3 * r
        inp[:r] = torch.where(park, self._pad, tok[rs])
        inp[2 * r:o] = torch.where(park, self._overflow, nxt[rs])
        inp[o:o + n_slots] = nxt
        inp[o + (lay.srows - 1) * n_slots:o + lay.srows * n_slots] = \
            torch.where(live, budget - 1, budget)

    def _commit(self, pipe) -> List[tuple]:
        """Commit half of one tick: read its vector back (an async tick's
        pinned copy once its event fired), observe the MoE routing and
        the health probe, move a tree's accepted paths onto the linear
        tail, then commit the decode or verify rows and the prefill
        progress, and record the tick's time and spans. A slot no longer
        seated with the request it had at dispatch (the pipeline ran a
        tick past its retirement) drops its token."""
        outs = pipe.outs
        if pipe.event is not None:
            pipe.event.synchronize()
            flat = pipe.host.numpy()
        else:
            flat = outs.flat.cpu().numpy()
        t_sync = time.monotonic()
        g = self._gamma
        n_slots = self.config.num_slots
        dev = self.device
        emitted: List[tuple] = []
        tok = flat[:n_slots]
        if self._health is not None:    # the probe rides every tick
            self._nf_last = bool(flat[-1])
        if outs.moe_counts:
            n = outs.moe_counts[0] * outs.moe_counts[1]
            self._observe_moe(
                flat[flat.size - 1 - n:flat.size - 1].reshape(
                    outs.moe_counts))
        committed = [i for i in pipe.active if self._slots[i] is not None
                     and self._slots[i].rid == pipe.rid_of[i]]
        a = pipe.layout.active
        acc_lens = {}
        if not a:
            for i in committed:
                self._commit_token(i, int(tok[i]), emitted)
        else:
            o = n_slots
            out = flat[o:o + a * (g + 1)].reshape(a, g + 1)
            o += a * (g + 1)
            accept = flat[o:o + a * g].reshape(a, g).astype(bool)
            o += a * g
            if self._tree is not None:
                # the accepted root path onto the linear tail of every
                # layer, its addresses worked out once; a path along the
                # spine (node j at depth j, a chain's always) is in place
                path_h = flat[o:o + a * (g + 1)].reshape(a, g + 1)
                o += a * (g + 1)
                n_keep = accept.sum(1) + 1
                off = [k for k in range(a) if np.any(
                    path_h[k, :n_keep[k]] != np.arange(n_keep[k]))]
                if off:
                    sel = outs.act[torch.as_tensor(off, device=dev)]
                    moves = _pc.window_moves(
                        self._bs, self._tables_dev[sel], outs.base[sel],
                        outs.path[off], torch.as_tensor(n_keep[off],
                                                        device=dev))
                    for kp, vp in self._pools:
                        _pc.move_rows(kp, vp, moves)
            props = flat[o:o + a * g].reshape(a, g) \
                if self._heads is not None else None
            for k, i in enumerate(pipe.active):
                if i not in committed:
                    continue
                acc_lens[i] = self._commit_verify_window(
                    i, out[k], accept[k], emitted)
                if props is not None and self._slots[i] is not None:
                    # the heads' tree for the slot's next tick
                    self._slot_props[i] = props[k]
            if self._n_spec_proposed:
                self._m_spec_rate.set(
                    self._n_spec_accepted / self._n_spec_proposed)
        # -- the tick's time (the roofline's measured half) ---------------
        name = self._lay_names[pipe.layout]
        self._last_exec = name
        if pipe.timed:
            self._note_step_time(name, t_sync - pipe.t0)
        # -- commit prefill progress -------------------------------------
        if pipe.given:
            # the resume cost model's prefill rate: the tick's rows over
            # its dispatch-to-read-back time
            self._note_prefill_rate(sum(pipe.given.values()),
                                    t_sync - pipe.t0)
        for i, k in pipe.given.items():
            slot = self._slots[i]
            slot.pend_pos += k
            slot.cache_len = slot.pend_pos
            self._n_prefill_chunks += 1
            if slot.pend_pos >= int(slot.prompt.size):
                # the chunk's last row is the final prompt row: its logits
                # give the request's first token
                self._finish_prefill(i, int(tok[i]), emitted)
        tr = self._trace
        if tr is not None:
            # under async_depth=1 the spans run from dispatch to this
            # commit; a dropped (stale-slot) row emits none
            q_lens = pipe.q_lens
            kind = "verify tick" if g else "decode tick"
            for i in committed:
                args_i = {"rid": pipe.rid_of[i], "rows": int(q_lens[i])}
                if g:
                    args_i["accepted_len"] = acc_lens[i]
                tr.emit(kind, tid=1 + i, t0=pipe.t0, t1=t_sync,
                        args=args_i)
            for i, k in pipe.given.items():
                tr.emit("prefill chunk", tid=1 + i, t0=pipe.t0, t1=t_sync,
                        args={"rid": pipe.rid_of[i], "rows": int(k),
                              "pos": pipe.pend_pos0[i]})
            n_act = len(pipe.active)
            tr.emit("tick", tid=0, t0=pipe.t_tick, args={
                "exec": name, "path": "ragged", "queued": len(self._queue),
                "kernel_fallbacks": 0, "rows": int(q_lens.sum()),
                "active": n_act, "pending": pipe.n_pending,
                "occupancy": round((n_act + pipe.n_pending) / n_slots,
                                   3)})
        return emitted

    def _note_step_time(self, name, dt):
        """The roofline's measured half: one launch -> read-back time of
        layout ``name`` (a per-width chunk's: host time, see
        :meth:`_roofline`) into its EMA; refreshes ``serving_step_mfu`` and
        ``serving_hbm_bw_util``."""
        if dt <= 0.0:
            return
        ema = self._step_time.get(name)
        self._step_time[name] = dt if ema is None else 0.7 * ema + 0.3 * dt
        self._step_ticks[name] = self._step_ticks.get(name, 0) + 1
        cost = self._exec_cost.get(name)
        # the gauges follow the tick (the per-width engine's decode or
        # verify step, not its chunks)
        if cost and (self._ragged or name in ("decode", "verify")):
            if cost.get("flops"):
                self._m_mfu.set(cost["flops"] / dt / self._peak_flops)
            if cost.get("bytes_accessed"):
                self._m_bw_util.set(cost["bytes_accessed"] / dt
                                    / self._peak_hbm_bw)

    def _roofline(self) -> dict:
        """``stats()['roofline']``: each layout's counted FLOPs and bytes
        (one run, from its warm-up) over its measured tick time (EMA,
        launch to read-back, capture ticks left out) as MFU and
        device-memory bandwidth utilization, each classified against the
        card's ridge point (peak FLOPs over peak bytes/s); ``step_*`` are
        the last tick's layout's. The per-width ``chunk`` entry is host
        time instead: a chunk step reads back only on a prompt's last
        chunk, so its time is launch to launch return, or to that
        read-back. On the CPU the peaks are nominal (``cpu_proxy``): read
        the numbers as structure."""
        per = {}
        for name, cost in self._exec_cost.items():
            f = float(cost.get("flops", 0.0) or 0.0)
            b = float(cost.get("bytes_accessed", 0.0) or 0.0)
            ai = (f / b) if b else 0.0
            dt = self._step_time.get(name)
            per[name] = {
                "flops": f, "bytes_accessed": b,
                "arithmetic_intensity": round(ai, 4),
                "bound": "compute" if ai >= self._ridge else "bandwidth",
                "ticks": self._step_ticks.get(name, 0),
                "step_time_ms": round(1000.0 * dt, 4)
                if dt is not None else None,
                "mfu": round(f / dt / self._peak_flops, 6)
                if dt and f else 0.0,
                "hbm_bw_util": round(b / dt / self._peak_hbm_bw, 6)
                if dt and b else 0.0,
            }
        t = per.get(self._last_exec, {})
        # a verify tick emits accepted + 1 tokens a window: the divisor
        # from per-tick to per-token cost
        acc = (self._n_spec_emitted / self._n_spec_verifies
               if self._n_spec_verifies else 0.0)
        return {"cpu_proxy": self._cpu_proxy,
                "tick_executable": self._last_exec,
                "step_mfu": t.get("mfu", 0.0),
                "step_hbm_bw_util": t.get("hbm_bw_util", 0.0),
                "verify_tokens_credited_per_tick": round(acc, 4),
                "verify_node_budget": (self._gamma + 1)
                if self._gamma else 1,
                "peak_flops_per_s": self._peak_flops,
                "peak_hbm_bytes_per_s": self._peak_hbm_bw,
                "ridge_flops_per_byte": round(self._ridge, 4),
                "per_executable": per}

    # -- the async pipeline ----------------------------------------------

    def _step_async(self) -> List[tuple]:
        """One tick with depth-1 dispatch-ahead: while the composition
        holds, dispatch tick N + 1 from tick N's carry and then commit N,
        so the host's bookkeeping overlaps the device's work; otherwise
        commit the in-flight tick first (a flush) and dispatch as the
        synchronous engine does."""
        prev = self._pipe
        if prev is not None and self._pipe_ready(prev):
            self._pipe = self._dispatch_pipelined(prev)
            return self._commit(prev)
        emitted = self._flush_pipe()
        pipe = self._dispatch(emitted)
        if pipe is None:
            return emitted
        if pipe.carry is not None:
            self._pipe = pipe           # its commit lags one call
        else:
            emitted.extend(self._commit(pipe))
        return emitted

    def _pipe_ready(self, pipe) -> bool:
        """May the next tick run from the in-flight tick's carry? Only
        while the synchronous engine would dispatch the same rows: a pure
        decode tick, every slot still seated with its request and none on
        its last budgeted token (it retires at the in-flight commit), no
        prompt pending, and a queue that waits only when nothing can seat
        it at that commit: no free slot, no EOS configured and, with
        preemption on, no queued request above a seated slot's class.
        Then grow the blocks the pipelined tick writes into
        (:meth:`_pipe_grow`). Stricter than the reference's rule, which
        also pipelines over a slot on its last token (parked by the
        carry): its ticks run at the static width, while a pure tick here
        packs its live rows, so the parked row would change the tick's
        shapes, and its bf16 bits, against the synchronous engine's."""
        if pipe.carry is None:
            return False
        for i in pipe.active:
            s = self._slots[i]
            if s is None or s.rid != pipe.rid_of[i] \
                    or s.max_new - s.n_emitted <= 1:
                return False
        if self._queue:
            if self._eos >= 0 or None in self._slots:
                return False
            floor = min(self._slots[i].priority for i in pipe.active)
            if self._preempt_on and any(q.priority > floor
                                        for q in self._queue):
                # it must reach the slot-pressure preemption now
                return False
        if any(s is not None and s.pend_pos is not None
               for s in self._slots):
            return False
        return self._pipe_grow(pipe)

    def _pipe_grow(self, pipe) -> bool:
        """Grow blocks for the pipelined tick: the in-flight tick writes
        position ``cache_len`` and the pipelined one ``cache_len + 1``,
        both uncommitted here. No preemption (a victim taken mid-pipeline
        would spill a stale state): a dry pool, possible only when
        admission overcommitted it, returns False, and the caller flushes
        so the synchronous path grows with preemption."""
        for i in pipe.active:
            slot = self._slots[i]
            need = _pc.blocks_for(slot.cache_len + 2, self._bs)
            while len(slot.blocks) < need:
                if self._alloc.free_blocks < 1:
                    return False
                self._append_block(i, *self._alloc.alloc(1))
        return True

    def _dispatch_pipelined(self, prev) -> _Pipe:
        """Dispatch the next tick from the in-flight tick's carry: no
        packing and no token upload (a bare replay on CUDA); the block
        table is uploaded again only when growth changed it."""
        t_tick = time.monotonic()
        self._sync_uploads()
        with torch.no_grad():
            pipe = self._run(prev.layout, carry=prev.carry)
        n_slots = self.config.num_slots
        pipe.active, pipe.given, pipe.rid_of = prev.active, {}, prev.rid_of
        pipe.t_tick, pipe.n_pending = t_tick, 0
        if self._trace is not None:
            pipe.q_lens = np.zeros(n_slots, np.int64)
            pipe.q_lens[prev.active] = 1
        self._n_pipelined += 1
        self._n_ticks += 1
        self._n_rows += prev.layout.rows
        self._m_steps.inc()
        self._m_util.observe(len(prev.active) / n_slots)
        # the committed lengths lag the device by a tick: a pipelined row
        # attends cache_len + 2 positions
        self._note_kv_read(sum(self._slots[i].cache_len + 2
                               for i in prev.active))
        if self._trace is not None:
            self._trace.instant("pipelined dispatch", tid=0,
                                args={"active": len(prev.active)})
        return pipe

    def _flush_pipe(self) -> List[tuple]:
        """Commit the in-flight tick now; a no-op without one."""
        pipe, self._pipe = self._pipe, None
        if pipe is None:
            return []
        self._n_pipe_flushes += 1
        return self._commit(pipe)

    # -- the per-width engine ---------------------------------------------

    def _step_per_width(self) -> List[tuple]:
        """One tick of the per-width engine (``ragged_batch=False``), the
        reference's: admit (prefilling at once unless interleaved),
        advance the interleaved prefills' chunk budget, then ONE
        fixed-width step over every slot: the decode step (each decoding
        slot's token at its length; K2d), or with speculation the draft
        (n-gram on the host, or the draft model's loop) and the fixed-gamma
        verify step (K2v at T = gamma + 1); commit tokens and retire.
        Idle and pending slots ride the step as null rows (length 0, the
        pad token, a null table row)."""
        t_tick = time.monotonic()
        emitted: List[tuple] = []
        self._admit(emitted)
        self._advance_prefills(emitted)
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.pend_pos is None]
        if not active:
            if self._kv_read_pend:      # a prefill-only tick: the chunk
                self._note_kv_read(0)   # reads are its traffic
            return emitted
        g = self._gamma
        # room for the step's writes: positions cache_len .. + gamma
        active = self._ensure_blocks(active, horizon=g + 1)
        if not active:                  # every slot preempted for blocks
            return emitted
        n = self.config.num_slots
        lens = np.zeros(n, np.int64)
        toks = np.full((n, g + 1), self._pad, np.int64)
        for i in active:
            lens[i] = self._slots[i].cache_len
            toks[i, 0] = self._slots[i].last_token
        if g and self._draft is None:
            for i in active:
                toks[i, 1:] = _spec.ngram_propose(
                    self._slots[i].history, g, self._ngram_max)
        name = "verify" if g else "decode"
        t_l0 = time.monotonic()
        with torch.no_grad():
            inp = self._pw_input("window", np.concatenate(
                [lens, toks.reshape(-1)]))
            built = False
            if self._draft is not None:
                # its drafts go into the window's rows of the shared input
                built = self._pw_call("draft", self._pw_draft_body,
                                      inp)[1]
            (flat, logits, moe), b = self._pw_call(
                name, self._pw_verify_body if g else self._pw_decode_body,
                inp, kind="decode")
            built = built or b
            host = flat.cpu().numpy()
        t_sync = time.monotonic()
        if logits is not None:
            self.last_logits = logits
        self._pw_observe_moe(host, moe)
        self._m_steps.inc()
        self._n_ticks += 1
        self._n_rows += len(active) * (g + 1)
        self._last_exec = name
        if not built:
            self._note_step_time(name, t_sync - t_l0)
        self._m_util.observe(len(active) / n)
        # window row t attends lens + t + 1 positions
        self._note_kv_read((g + 1) * int(lens.sum())
                           + len(active) * (g + 1) * (g + 2) // 2)
        tr = self._trace
        rid_of = {i: self._slots[i].rid for i in active}
        acc_lens = {}
        if not g:
            for i in active:
                self._commit_token(i, int(host[i]), emitted)
        else:
            out = host[:n * (g + 1)].reshape(n, g + 1)
            accept = host[n * (g + 1):n * (2 * g + 1)].reshape(
                n, g).astype(bool)
            for i in active:
                acc_lens[i] = self._commit_verify_window(
                    i, out[i], accept[i], emitted)
            if self._n_spec_proposed:
                self._m_spec_rate.set(
                    self._n_spec_accepted / self._n_spec_proposed)
        if tr is not None:
            for i in active:
                args = {"rid": rid_of[i], "rows": g + 1}
                if g:
                    args["accepted_len"] = acc_lens[i]
                tr.emit(f"{name} tick", tid=1 + i, t0=t_l0, t1=t_sync,
                        args=args)
            tr.emit("tick", tid=0, t0=t_tick, args={
                "exec": name, "path": "legacy", "queued": len(self._queue),
                "kernel_fallbacks": 0, "active": len(active),
                "occupancy": round(len(active) / n, 3)})
        return emitted

    def _advance_prefill(self, i, budget=None) -> Optional[int]:
        """Run up to ``budget`` chunk steps (None: to the end) of slot
        ``i``'s pending prompt through the per-width chunk step: ``[1, C]``
        rows at positions ``pend_pos + t`` (the paged path's K2v at ``T =
        prefill_chunk``, each row attending the cached positions and its
        chunk's causal prefix; a short last chunk's pad rows write past
        the prompt and are never read), the draft model's chunk step over
        the same rows. Returns the first token when the prefill completes
        (the last real row's), else None."""
        slot = self._slots[i]
        c = self._chunk
        n_real = int(slot.prompt.size)
        # the slot's blocks: its global row may be null while it is pending
        row = np.zeros((1, self._mb), np.int32)
        row[0, :len(slot.blocks)] = slot.blocks
        self._row_up.write(row)
        while budget is None or budget > 0:
            p0 = slot.pend_pos
            part = slot.prompt[p0:p0 + c]
            k = int(part.size)
            # chunk row t attends p0 + t + 1 positions
            self._kv_read_pend += k * p0 + k * (k + 1) // 2
            pack = np.full(c + 3, self._pad, np.int64)
            pack[:k] = part
            pack[c:] = (p0, k - 1, i)
            t_c0 = time.monotonic()
            with torch.no_grad():
                inp = self._pw_input("chunk", pack)
                (flat, _, moe), built = self._pw_call(
                    "chunk", self._pw_chunk_body, inp, kind="prefill",
                    label=f"chunk{c}")
                if self._draft is not None:
                    _, b = self._pw_call(
                        "draft_chunk", self._pw_draft_chunk_body, inp,
                        kind="prefill", label=f"draft-chunk{c}")
                    built = built or b
            done = p0 + k >= n_real
            host = flat.cpu().numpy() if done or moe else None
            self._pw_observe_moe(host, moe)
            if not built:
                # host time: launch to launch return, or to the read-back
                # on a prompt's last chunk (and under the MoE telemetry)
                self._note_step_time("chunk", time.monotonic() - t_c0)
            if self._trace is not None:
                self._trace.emit(f"prefill chunk[{p0 // c}]", tid=1 + i,
                                 t0=t_c0, args={"rid": slot.rid,
                                                "pos": int(p0), "rows": k})
            self._n_prefill_chunks += 1
            self._n_rows += k
            slot.pend_pos = p0 + k
            slot.cache_len = slot.pend_pos
            if budget is not None:
                budget -= 1
            if done:
                slot.pend_pos = None
                return int(host[0])
        return None

    def _advance_prefills(self, emitted):
        """The interleaved prefill (``max_prefill_chunks_per_step > 0``):
        spend the tick's chunk budget across the pending slots, lowest
        slot index first, finishing the prefills whose last chunk lands."""
        if self._chunk_budget <= 0:
            return
        budget = self._chunk_budget
        for i, s in enumerate(self._slots):
            if budget <= 0:
                break
            if s is None or s.pend_pos is None:
                continue
            n0 = self._n_prefill_chunks
            tok = self._advance_prefill(i, budget)
            budget -= self._n_prefill_chunks - n0
            if tok is not None:
                self._finish_prefill(i, tok, emitted)

    def _bucket(self, n) -> int:
        return _prompt_bucket(n, self.config.min_prefill_bucket)

    def _prefill_bucketed(self, i, req, n_real) -> int:
        """The bucketed prefill (``chunked_prefill=False``): one dense
        cached forward over the right-padded prompt at its power-of-two
        bucket (eager ``cached_attention``, as the reference's is XLA's),
        its K/V scattered into slot ``i``'s blocks (``write_prefill``,
        the tail past the prompt to the null block), the first token
        taken at the prompt's last row; the draft model's twin primes its
        pools. One step a bucket. Returns the first token."""
        bucket = self._bucket(n_real)
        pack = np.full(bucket + 2, self._pad, np.int64)
        pack[:n_real] = req.prompt
        pack[bucket:] = (n_real, i)
        self._row_up.write(self._tables[i:i + 1])
        t_p0 = time.monotonic()
        with torch.no_grad():
            inp = self._pw_input(f"bucket{bucket}", pack)
            (flat, _, moe), _ = self._pw_call(
                f"prefill{bucket}",
                lambda x: self._pw_prefill_body(x, bucket, False), inp,
                kind="prefill", label=str(bucket))
            if self._draft is not None:
                self._pw_call(
                    f"draft_prefill{bucket}",
                    lambda x: self._pw_prefill_body(x, bucket, True), inp,
                    kind="prefill", label=f"draft-{bucket}")
            host = flat.cpu().numpy()
        self._pw_observe_moe(host, moe)
        if self._trace is not None:
            self._trace.emit(f"prefill bucket{bucket}", tid=1 + i, t0=t_p0,
                             args={"rid": req.request_id, "rows": n_real})
        return int(host[0])

    def _pw_input(self, key, pack) -> torch.Tensor:
        """Write ``pack`` into the per-width input ``key`` (one int64
        device vector a shape of steps, kept for the engine's life: the
        steps' graphs read it) and return it."""
        up = self._pw_inputs.get(key)
        if up is None:
            up = self._pw_inputs[key] = _Upload(pack.shape, torch.int64,
                                                self.device)
        up.write(np.ascontiguousarray(pack, np.int64))
        return up.dev

    def _pw_call(self, name, body, inp, kind=None, label=None):
        """Run per-width step ``name`` (``body(inp)``). Its first call
        builds it (:meth:`_build`), as the reference compiles its
        executable; the build counts in ``executables_compiled`` and, by
        ``kind``, in ``decode_compiles`` or in ``prefill_compiles`` under
        ``label``. Later calls replay the graph (or run the body). Returns
        ``(the body's outputs, built)``."""
        self._sync_uploads()
        st = self._pw.get(name)
        if st is not None:
            if st.graph is None:
                return body(inp), False
            st.graph.replay()
            return st.outs, False
        st = self._pw[name] = _PwStep()
        st.graph, st.outs, outs = self._build(name, lambda: body(inp))
        self._n_exec_compiled += 1
        if kind == "decode":
            self._n_decode_compiles += 1
            self._m_decode_compiles.inc()
        elif kind == "prefill":
            self._n_prefill_compiles += 1
            self._m_prefill_compiles.labels(bucket=label).inc()
        return outs, True

    def _pw_scope(self, counts=None, live=None):
        """The per-width steps' context: the fused decode layer on the
        paged path (``fused_decode``; :func:`~paddle_tpu_torch.ops.
        kernels.decode_fused.paged_fused_scope`), and for the target
        model with the MoE telemetry on (``counts`` given) the routing tap
        into ``counts`` over the ``live`` rows."""
        stack = contextlib.ExitStack()
        if self.config.fused_decode:
            stack.enter_context(_df.paged_fused_scope())
        if self._moe_tap_on and counts is not None:
            stack.enter_context(_moe.serving_stats_tap(counts))
            stack.enter_context(_moe.serving_rows_mask(live))
        if self._moe:
            _moe.MOE_STATS["grouped_mm_kernel"] = None
        return stack

    def _pw_out(self, parts, counts, logits=None):
        """A step's outputs: the one vector the host reads back (its
        tokens, then each sparse layer's expert counts), the logits kept
        as ``last_logits``, and the counts' shape."""
        if self._moe and _moe.MOE_STATS["grouped_mm_kernel"] == "fused_gmm":
            self._moe_fused = True
        if counts:
            parts = parts + [torch.stack(counts).reshape(-1).long()]
        return (torch.cat(parts), logits,
                (len(counts), counts[0].numel()) if counts else None)

    def _pw_observe_moe(self, host, moe):
        if moe and host is not None:
            k = moe[0] * moe[1]
            self._observe_moe(host[host.size - k:].reshape(moe))

    def _pw_select(self, logits, si):
        """The token of one slot's row ``logits [1, V]`` by slot ``si``'s
        sampling knobs (an index tensor: a graph's operand)."""
        if not self._do_sample:
            return _select_token(logits, do_sample=False)[0]
        samp = self._samp().index_select(0, si.reshape(1))
        return _select_token(logits, self._gen, do_sample=True,
                             temperature=samp[:, 0], top_k=samp[:, 1],
                             top_p=samp[:, 2])[0]

    def _pw_decode_body(self, inp):
        """The fixed-width decode step: every slot's token at its length
        (idle and pending slots at length 0 in their null rows)."""
        n = self.config.num_slots
        lens = inp[:n].to(torch.int32)
        counts = []
        with self._pw_scope(counts, lens > 0):
            logits, self._pools = self.model(
                inp[n:2 * n].view(n, 1), caches=self._pools,
                block_tables=self._tables_dev, cache_lens=lens,
                fused=self.config.fused_decode)
        lg = logits[:, -1]
        return self._pw_out([self._select(lg).long()], counts, lg)

    def _pw_verify_body(self, inp):
        """The fixed-gamma verify step over every slot's window (the
        port's ``build_verify_step`` with the per-slot knobs)."""
        n, g = self.config.num_slots, self._gamma
        lens = inp[:n].to(torch.int32)
        toks = inp[n:n + n * (g + 1)].view(n, g + 1)
        dq = self._pw_dq if self._draft is not None and self._do_sample \
            else None
        counts = []
        with self._pw_scope(counts, (lens > 0).repeat_interleave(g + 1)):
            out, accept, _, self._pools = self._pw_verify(
                self._pools, self._tables_dev, lens, toks, self._samp(),
                dq, self._gen)
        return self._pw_out([out.reshape(-1).long(),
                             accept.reshape(-1).long()], counts)

    def _pw_draft_body(self, inp):
        """The draft model's gamma + 1 decode steps over every slot (K2d),
        its drafts written into the window rows of the shared input and
        its distributions into a buffer the verify step reads."""
        n, g = self.config.num_slots, self._gamma
        lens = inp[:n].to(torch.int32)
        win = inp[n:n + n * (g + 1)].view(n, g + 1)
        with self._pw_scope():
            props, dq, self._dpools = self._dloop(
                self._dpools, self._tables_dev, lens, win[:, 0],
                self._samp(), self._gen)
        win[:, 1:] = props.long()
        if dq is not None:
            if self._pw_dq is None:     # the warm-up's; held for the graph
                self._pw_dq = torch.empty_like(dq)
            self._pw_dq.copy_(dq)

    def _pw_chunk_body(self, inp):
        """The chunk step: ``[1, C]`` prompt rows at ``pos + t`` through
        the slot's table row, the token of the last real row."""
        c = self._chunk
        pos = inp[c:c + 1].to(torch.int32)
        last = inp[c + 1:c + 2]
        counts = []
        live = torch.arange(c, device=inp.device) <= last
        with self._pw_scope(counts, live):
            logits, self._pools = self.model(
                inp[:c].view(1, c), caches=self._pools,
                block_tables=self._row_up.dev, cache_lens=pos,
                fused=self.config.fused_decode)
        tok = self._pw_select(logits[0].index_select(0, last), inp[c + 2])
        return self._pw_out([tok.long()], counts)

    def _pw_draft_chunk_body(self, inp):
        """The draft model's twin of the chunk step (its K/V only)."""
        c = self._chunk
        with self._pw_scope():
            _, self._dpools = self._draft(
                inp[:c].view(1, c), caches=self._dpools,
                block_tables=self._row_up.dev,
                cache_lens=inp[c:c + 1].to(torch.int32),
                fused=self.config.fused_decode)

    def _pw_prefill_body(self, inp, bucket, draft):
        """The bucketed prefill at ``bucket`` rows: the dense cached
        forward into fresh dense caches, ``write_prefill`` into the slot's
        blocks (rows past ``n_real`` to the null block), and for the
        target the token of row ``n_real - 1``."""
        model = self._draft if draft else self.model
        n_real = inp[bucket:bucket + 1]
        dense = model.init_caches(1, bucket)
        counts = []
        live = torch.arange(bucket, device=inp.device) < n_real
        with contextlib.ExitStack() if draft else \
                self._pw_scope(counts, live):
            logits, dense = model(inp[:bucket].view(1, bucket),
                                  caches=dense, offset=0,
                                  fused=self.config.fused_decode)
        pools = self._dpools if draft else self._pools
        for (kp, vp), (dk, dv) in zip(pools, dense):
            _pc.write_prefill(kp, vp, self._row_up.dev, dk, dv,
                              n_real=n_real)
        if draft:
            return None
        tok = self._pw_select(logits[0].index_select(0, n_real - 1),
                              inp[bucket + 1])
        return self._pw_out([tok.long()], counts)

    def _head_drafts(self, hid, path, n_acc):
        """The draft heads' tree for each verifying slot's next tick,
        from the final hidden row of its accepted path (the row whose
        logits gave the bonus token; ``hid [A, gamma + 2, hidden]``, the
        continuation row first): head ``d - 1`` predicts the token at
        depth ``d``, node ``k + 1`` taking the top entry of its sibling
        rank. The projection runs in float32, as the reference's."""
        fin = torch.gather(path, 1, n_acc[:, None])[:, 0]
        h_fin = hid[torch.arange(hid.shape[0], device=hid.device),
                    1 + fin].float()
        head_lg = torch.einsum("sh,dhv->dsv", h_fin, self._heads)
        tidx = torch.topk(head_lg, self._tree_kmax, dim=-1).indices
        return torch.stack([tidx[self._tree_depth[k + 1] - 1, :,
                                 self._tree_sib[k]]
                            for k in range(self._gamma)], 1)

    # -- internals -----------------------------------------------------

    def _observe_moe(self, counts):
        """Routing of the tick's sparse layers, from their ``[layers, e]``
        expert counts: per-expert load fractions, their entropy over
        ``log(e)`` (1 = uniform) and the largest load; ``stats()`` keeps
        the last layer's."""
        for c in np.asarray(counts, np.float64):
            load = c / max(c.sum(), 1.0)
            nz = load[load > 0]
            ent = float(-(nz * np.log(nz)).sum())
            self._m_moe_load.observe_many(load)
            self._moe_ent_last = ent / float(np.log(max(load.size, 2)))
            self._m_moe_entropy.set(self._moe_ent_last)
            self._moe_load_max_last = float(load.max())
            self._n_moe_dispatches += 1

    def _note_kv_read(self, positions):
        """The tick's KV bytes: attended positions x bytes a position."""
        b = int(positions * self._kv_pos_bytes)
        self._kv_step_bytes_last = b
        self._m_kv_step.set(b)

    def _sync_cache_metrics(self):
        """Mirror the allocator's evictions into the registry, and the
        digests into their quantile gauges."""
        d = self._alloc.evictions - self._n_evictions_seen
        if d:
            self._m_evict.inc(d)
            self._n_evictions_seen = self._alloc.evictions
        for key, dig in (("ttft", self._d_ttft), ("itl", self._d_itl),
                         ("queue_wait", self._d_queue),
                         ("e2e", self._d_e2e)):
            g = self._m_lat[key]
            for q, v in dig.quantiles().items():
                g.labels(q=q).set(round(v, 3))
        for q, v in self._d_accept.quantiles().items():
            self._m_accept.labels(q=q).set(round(v, 3))
        for q, v in self._d_host_gap.quantiles().items():
            self._m_host_gap.labels(q=q).set(round(v, 3))

    def _sync_lora_metrics(self):
        pool = self._lora
        if pool is None:
            return
        self._m_lora_resident.set(pool.n_resident)
        self._m_lora_host.set(pool.host_tier_bytes)
        d = pool.swaps - self._lora_swaps_seen
        if d > 0:
            self._m_lora_swaps.inc(d)
            self._lora_swaps_seen = pool.swaps

    def _worst_for(self, n_real, max_new) -> int:
        return _pc.blocks_for(int(n_real) + int(max_new) + self._gamma,
                              self._bs)

    def _samp(self):
        """The per-slot knobs ``[S, 3]`` (temperature, top_k, top_p) on
        the device, one tensor written in place (:meth:`_sync_uploads`)."""
        return self._samp_dev.dev

    def _sync_uploads(self):
        """Upload the block tables and the sampling knobs where the host
        changed them, into the tensors a graph reads them from."""
        if self._tables_dirty:
            self._tables_up.write(self._tables)
            self._tables_dirty = False
        if self._samp_dirty:
            self._samp_dev.write(self._slot_samp)
            self._samp_dirty = False

    def _select(self, logits):
        if not self._do_sample:
            tok, _ = _select_token(logits, do_sample=False)
            return tok
        samp = self._samp()
        tok, _ = _select_token(logits, self._gen, do_sample=True,
                               temperature=samp[:, 0], top_k=samp[:, 1],
                               top_p=samp[:, 2])
        return tok

    def _init_heads(self, model, spec_heads, dev):
        """The draft heads, one float32 ``[hidden, vocab]`` projection a
        tree depth: ``spec_heads`` (arrays or tensors), or the reference's
        seeded weights (:func:`_seeded_heads`)."""
        import inspect
        if "return_hidden" not in inspect.signature(
                type(model).forward).parameters:
            raise NotImplementedError(
                f"{type(model).__name__} does not expose forward("
                "return_hidden=...): draft heads need the target's final "
                "hidden state")
        hdim = int(model.config.hidden_size)
        vocab = int(model.config.vocab_size)
        n_heads = self._tree_max_depth
        sib, cnt = [], {}
        for p in self._tree:
            sib.append(cnt.get(p, 0))
            cnt[p] = sib[-1] + 1
        self._tree_sib = tuple(sib)
        self._tree_kmax = max(sib) + 1
        if spec_heads is None:
            self._heads = _seeded_heads(n_heads, hdim, vocab, dev)
            return
        ws = [w if isinstance(w, torch.Tensor) else
              torch.from_numpy(np.asarray(w, np.float32))
              for w in spec_heads]
        if len(ws) != n_heads or any(
                tuple(w.shape) != (hdim, vocab) for w in ws):
            raise ValueError(
                f"spec_heads must be {n_heads} arrays of shape ({hdim}, "
                f"{vocab}) (one per tree depth)")
        heads = torch.empty((n_heads, hdim, vocab), dtype=torch.float32,
                            device=dev)
        for d, w in enumerate(ws):
            heads[d] = w.to(dev, torch.float32)
        self._heads = heads

    def _tree_draft(self, i) -> np.ndarray:
        """Slot ``i``'s gamma tree nodes for this tick: the heads'
        proposal cached from its last verify, else (no cached proposal:
        a fresh prefill; or drafter 'ngram') the top-k n-gram chains
        filling the tree."""
        if self._heads is not None:
            props = self._slot_props.get(i)
            if props is not None:
                return props
        chains = _spec.ngram_propose_topk(
            self._slots[i].history, self._tree_max_depth,
            self._tree_chains, self._ngram_max)
        return np.asarray(_spec.tree_fill_from_chains(self._tree, chains),
                          np.int64)

    def _commit_token(self, i, t, emitted):
        """Commit decoding slot ``i``'s token ``t``: advance its length,
        emit, and retire it on EOS or at its token budget."""
        slot = self._slots[i]
        slot.cache_len += 1
        slot.last_token = t
        slot.n_emitted += 1
        slot.history.append(t)
        self._emit(slot.rid, t)
        emitted.append((slot.rid, t))
        if t == self._eos or slot.n_emitted >= slot.max_new:
            self._retire(i)

    def _commit_verify_window(self, i, out_row, accept_row, emitted):
        """Commit slot ``i``'s verified window: emit the kept prefix (cut
        at an EOS and at ``max_new_tokens``), count the drafts used,
        retire the slot when it is done, else advance its length over the
        accepted prefix (the rejected tail rolls back by not advancing)
        and trim the blocks past the next window's reach. Returns the
        tokens emitted (the verify span's ``accepted_len``)."""
        g = self._gamma
        slot = self._slots[i]
        kept, n_acc = _spec.commit_window(
            out_row, accept_row, slot.max_new - slot.n_emitted, self._eos)
        slot.n_emitted += len(kept)
        slot.history.extend(kept)
        for t in kept:
            self._emit(slot.rid, t)
            emitted.append((slot.rid, t))
        # the drafts actually used: an EOS or the token budget can cut
        # the emission below n_acc + 1
        n_used = min(n_acc, len(kept))
        self._n_spec_proposed += g
        self._n_spec_accepted += n_used
        self._n_spec_verifies += 1
        self._n_spec_emitted += len(kept)
        self._d_accept.observe(float(len(kept)))
        self._m_spec_len.observe(len(kept))
        self._m_spec_proposed.inc(g)
        self._m_spec_accepted.inc(n_used)
        if kept[-1] == self._eos or slot.n_emitted >= slot.max_new:
            self._retire(i)
        else:
            slot.cache_len += n_acc + 1
            slot.last_token = kept[-1]
            self._trim_blocks(i)
        return len(kept)

    def _set_slot_samp(self, i, req=None):
        row = self._samp_default.copy()
        if req is not None:
            if req.temperature is not None:
                row[0] = req.temperature
            if req.top_k is not None:
                row[1] = req.top_k
            if req.top_p is not None:
                row[2] = req.top_p
        if not np.array_equal(self._slot_samp[i], row):
            self._slot_samp[i] = row
            self._samp_dirty = True

    def _emit(self, rid, tok):
        """Single exit point for generated tokens: the token counters and
        the TTFT / inter-token digests (and the SLO verdicts of the
        health engine) agree with what clients receive."""
        now = time.monotonic()
        prev = self._last_emit.get(rid)
        if prev is None:                # the request's first token
            t0 = self._submit_t.get(rid)
            if t0 is not None:
                ttft_ms = 1000.0 * (now - t0)
                self._d_ttft.observe(ttft_ms)
                if self._health is not None:
                    self._slo_ok[rid] = ttft_ms <= self._h_slo_ttft
        else:
            itl_ms = 1000.0 * (now - prev)
            self._d_itl.observe(itl_ms)
            if self._health is not None and itl_ms > self._h_slo_itl:
                self._slo_ok[rid] = False
        self._last_emit[rid] = now
        self._results[rid].append(tok)
        self._m_tokens.inc()
        self._n_tokens += 1
        if self._stream is not None:
            self._stream(rid, tok)

    def _admit(self, emitted):
        """Admission: expire queue-wait budgets, then seat the next
        request (highest class first, FIFO within a class) while a slot
        and its blocks can be had, preempting strictly lower classes for
        them when preemption is on. A fresh request maps its longest
        published prefix and prefills the rest: in the ragged tick's rows,
        by the per-width chunk steps (at once, or interleaved between
        decode steps: :meth:`_advance_prefills`), or whole by its bucket
        (chunked prefill off); a prefill completed here emits its first
        token into ``emitted``. A preempted request resumes
        (:meth:`_seat_resume`). A request under a LoRA adapter pins its
        stack row first, and waits queued while every row is pinned by
        other adapters."""
        self._expire_queue()
        seated = False
        while self._queue:
            req = self._queue[self._pick_next_idx()]
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                # slot pressure: a strictly lower class yields its slot
                if not self._preempt_on:
                    break
                v = self._pick_victim(below=req.priority)
                if v is None:
                    break
                self._preempt(v)
                free = [v]
            if not self._admission_fits(req):
                break
            lrow = 0
            if self._lora is not None and req.adapter_id is not None:
                lrow = self._lora.acquire(req.adapter_id)
                if lrow is None:
                    break
                self._sync_lora_metrics()
            # by identity: a preemption above put its victim at the front
            self._queue.remove(req)
            seated = True
            i = free[0]
            self._slot_adapter[i] = lrow
            seed = self._prefix_seed(req.adapter_id)
            if req.resume is not None:
                self._seat_resume(i, req, seed, emitted)
                continue
            n_real = int(req.prompt.size)
            worst = self._worst_for(n_real, req.max_new_tokens)
            blocks, cached = self._map_prefix(req.prompt, n_real, seed)
            # observed before the prefill: the queue wait, not the work
            self._queue_exit(req, "admitted")
            self._reserved += worst - len(blocks)
            self._seat_row(i, blocks)
            self._results[req.request_id] = []
            self._slots[i] = _Slot(req.request_id, blocks, worst,
                                   req.max_new_tokens, req.prompt,
                                   cache_len=cached, priority=req.priority,
                                   adapter_id=req.adapter_id, seed=seed)
            self._set_slot_samp(i, req)
            self._m_occupancy.set(self.num_active)
            if self._trace is not None:
                self._trace.instant(
                    "admit", tid=1 + i,
                    args={"rid": req.request_id, "prefix_hit": cached > 0,
                          "cached_tokens": int(cached),
                          "prompt_tokens": n_real})
            if not self._chunked:
                self._finish_prefill(
                    i, self._prefill_bucketed(i, req, n_real), emitted)
                continue
            # a full-prompt hit recomputes the last prompt row into a
            # shared block: copy it first
            bidx = cached // self._bs
            if self._alloc.is_shared(blocks[bidx]):
                self._cow(i, bidx)
            if not self._ragged and self._chunk_budget <= 0:
                self._finish_prefill(i, self._advance_prefill(i), emitted)
        if seated:
            self._sync_cache_metrics()

    def _seat_row(self, i, blocks):
        """Slot ``i``'s table row at seating: its blocks, except on the
        per-width engine's interleaved prefill, which keeps the row null
        until the prefill completes (:meth:`_finish_prefill`), so the
        decode steps that run meanwhile write and read slot ``i`` in the
        null block, as an idle slot's; the chunk steps take the slot's
        blocks directly."""
        self._tables[i, :] = 0
        if self._ragged or not (self._chunked and self._chunk_budget > 0):
            self._tables[i, :len(blocks)] = blocks
        self._tables_dirty = True

    # -- preemptive scheduling and the host KV tier -----------------------

    def _pick_next_idx(self) -> int:
        """The queue position to admit next: the leftmost of the highest
        class (a preempted request re-enters at the front, so it leads
        its class); the head without preemption."""
        if not self._preempt_on or len(self._queue) < 2:
            return 0
        best, bp = 0, self._queue[0].priority
        for k in range(1, len(self._queue)):
            p = self._queue[k].priority
            if p > bp:
                best, bp = k, p
        return best

    def _expire_queue(self):
        """Requests queued past their ``max_queue_wait_ms`` end with an
        empty result; preempted ones are exempt (they already
        streamed)."""
        if not any(r.max_queue_wait_ms is not None for r in self._queue):
            return
        now = time.monotonic()
        kept = deque()
        for r in self._queue:
            w = r.max_queue_wait_ms
            if w is not None and r.resume is None \
                    and 1000.0 * (now - r.submit_time) > float(w):
                self._n_timeout += 1
                self._queue_exit(r, "timeout")
                self._finish_unserved(r, record_empty=True)
            else:
                kept.append(r)
        self._queue = kept

    def _admission_fits(self, req) -> bool:
        """The block policy of admission: the worst-case reservation
        first (the whole policy without preemption); failing that, the
        watermark: the prompt's blocks plus ``admission_watermark_blocks``
        of headroom, preempting strictly lower classes to reach it. A
        resume needs only its blocks back."""
        if req.resume is not None:
            need, target = int(req.resume["n_blocks"]), 0
        else:
            n_real = int(req.prompt.size)
            worst = self._worst_for(n_real, req.max_new_tokens)
            if self._alloc.free_blocks - self._reserved >= worst:
                return True
            if not self._preempt_on:
                return False
            need = _pc.blocks_for(n_real, self._bs)
            target = self._watermark
        while self._alloc.free_blocks - need < target:
            v = self._pick_victim(below=req.priority)
            if v is None:
                break
            self._preempt(v)
        return self._alloc.free_blocks - need >= target

    def _pick_victim(self, below=None, exclude=()):
        """The slot to preempt: the lowest class, within it a slot still
        prefilling (it streamed nothing) before a decoding one, then the
        latest admitted. ``below``: strictly lower classes only;
        ``exclude``: slots that may not lose."""
        cands = [i for i, s in enumerate(self._slots)
                 if s is not None and i not in exclude
                 and (below is None or s.priority < below)]
        if not cands:
            return None
        return min(cands, key=lambda i: (
            self._slots[i].priority,
            0 if self._slots[i].pend_pos is not None else 1,
            -self._slots[i].admit_t))

    def _alloc_with_preempt(self, n, exclude=(), below=None):
        """Allocate ``n`` blocks, preempting victims while the pool is
        short (preemption on); raises as ``alloc`` when even that cannot
        cover them."""
        if self._preempt_on:
            while self._alloc.free_blocks < n:
                v = self._pick_victim(below=below, exclude=exclude)
                if v is None:
                    break
                self._preempt(v)
        return self._alloc.alloc(n)

    def _preempt(self, i):
        """Preempt slot ``i``: return the blocks past its valid positions,
        publish its full blocks (the recompute resume's warm start), copy
        a decoding slot's blocks into the host tier (the swap resume's
        payload), free the slot, and queue its request at the front of
        its class with its continuation (a slot still on its first
        prefill goes back fresh: it streamed nothing)."""
        self._flush_pipe()
        slot = self._slots[i]
        samp_row = self._slot_samp[i].copy()
        # a resumed slot re-prefilling its context keeps its continuation
        pending = slot.pend_pos is not None and slot.resume is None
        # blocks past the valid positions: not spilled, not published
        self._trim_blocks(i, max(_pc.blocks_for(slot.cache_len, self._bs),
                                 1))
        self._publish(slot)
        key = None
        nbytes = 0
        if slot.pend_pos is None and self._host_tier is not None \
                and slot.blocks and len(slot.blocks) <= self._mb_xfer:
            payload = self._export_payload(slot.blocks)
            nbytes = _pc.payload_nbytes(payload)
            key = ("victim", slot.rid)
            if self._host_tier.put(key, payload, nbytes):
                self._n_spilled += len(slot.blocks)
                self._m_spill.inc(len(slot.blocks))
            else:
                key = None      # larger than the tier: recompute resume
            self._m_host_bytes.set(self._host_tier.bytes_used)
        n_spilled_blocks = len(slot.blocks) if key is not None else 0
        self._vacate(i)
        self._m_occupancy.set(self.num_active)
        resume = None
        if not pending:
            if slot.resume is not None:
                # preempted again mid-re-prefill: the first continuation
                last_token, n_emitted = slot.resume
            else:
                last_token, n_emitted = slot.last_token, slot.n_emitted
            n_ctx = len(slot.history) - 1
            resume = {"cache_len": int(n_ctx),
                      "last_token": int(last_token),
                      "n_emitted": int(n_emitted),
                      "history": list(slot.history),
                      "worst_blocks": int(slot.worst_blocks),
                      "n_blocks": _pc.blocks_for(n_ctx, self._bs),
                      "nbytes": int(nbytes), "key": key}
        knob = self._do_sample
        req = ServingRequest(
            slot.rid, np.asarray(slot.prompt, np.int32), slot.max_new,
            self._submit_t.get(slot.rid, time.monotonic()),
            temperature=float(samp_row[0]) if knob else None,
            top_k=int(samp_row[1]) if knob else None,
            top_p=float(samp_row[2]) if knob else None,
            priority=int(slot.priority), resume=resume,
            adapter_id=slot.adapter_id)
        self._queue.appendleft(req)
        self._n_preempt += 1
        self._m_preempt.inc()
        if self._trace is not None:
            self._trace.instant(
                "preempt", tid=1 + i,
                args={"rid": slot.rid, "priority": int(slot.priority),
                      "cache_len": int(slot.cache_len),
                      "blocks_spilled": n_spilled_blocks})

    def _seat_resume(self, i, req, seed, emitted):
        """Seat a preempted request in slot ``i`` where it stopped. Swap:
        import its spilled bytes into fresh blocks and decode at once.
        Recompute: map its published prefix (under the prefix ``seed``)
        and re-prefill the rest of its context (the per-width engine's
        chunk steps run at once unless interleaved);
        :meth:`_finish_prefill` then restores the continuation instead of
        emitting."""
        r = req.resume
        rid = req.request_id
        n_ctx = int(r["cache_len"])
        ctx = np.asarray(r["history"][:n_ctx], np.int32)
        payload = None
        if self._host_tier is not None and r["key"] is not None:
            payload = self._host_tier.get(r["key"])
        mode = self._resume_mode(r, payload)
        self._queue_exit(req, "resumed")
        self._results.setdefault(rid, [])
        if mode == "swap":
            n_blocks = int(r["n_blocks"])
            blocks = self._alloc.alloc(n_blocks)
            self._import_payload(blocks, payload)
            self._host_tier.pop(r["key"])
            self._n_restored += n_blocks
            self._m_restore.inc(n_blocks)
            self._m_host_bytes.set(self._host_tier.bytes_used)
            self._n_swap_resumes += 1
            slot = _Slot(rid, blocks, int(r["worst_blocks"]),
                         int(req.max_new_tokens), ctx, cache_len=n_ctx,
                         history=r["history"], priority=req.priority,
                         adapter_id=req.adapter_id, seed=seed)
            slot.pend_pos = None
            slot.last_token = int(r["last_token"])
            slot.n_emitted = int(r["n_emitted"])
        else:
            if self._host_tier is not None and r["key"] is not None:
                # a payload that will never be imported
                self._host_tier.pop(r["key"], restore=False)
                self._m_host_bytes.set(self._host_tier.bytes_used)
            self._n_recompute_resumes += 1
            blocks, cached = self._map_prefix(ctx, n_ctx, seed)
            slot = _Slot(rid, blocks, int(r["worst_blocks"]),
                         int(req.max_new_tokens), ctx, cache_len=cached,
                         history=r["history"], priority=req.priority,
                         adapter_id=req.adapter_id, seed=seed)
            slot.resume = (int(r["last_token"]), int(r["n_emitted"]))
        self._reserved += int(r["worst_blocks"]) - len(blocks)
        if mode == "swap":
            self._tables[i, :] = 0
            self._tables[i, :len(blocks)] = blocks
            self._tables_dirty = True
        else:
            self._seat_row(i, blocks)
        self._slots[i] = slot
        self._set_slot_samp(i, req)
        self._m_occupancy.set(self.num_active)
        if self._trace is not None:
            self._trace.instant(
                "resume", tid=1 + i,
                args={"rid": rid, "mode": mode, "cache_len": n_ctx})
        if mode != "swap":
            bidx = cached // self._bs
            if self._alloc.is_shared(blocks[bidx]):
                self._cow(i, bidx)
            if not self._ragged and self._chunk_budget <= 0:
                self._finish_prefill(i, self._advance_prefill(i), emitted)

    def _resume_mode(self, r, payload) -> str:
        """Swap or recompute, a victim at a time: without a payload,
        recompute; else the config's choice, or for ``"auto"`` the cheaper
        by the measured rates (payload bytes over the transfer rate
        against cached tokens over the prefill rate), swap while either
        is unmeasured."""
        if payload is None:
            return "recompute"
        if self._resume_policy in ("swap", "recompute"):
            return self._resume_policy
        if self._prefill_rows_s > 0 and self._xfer_bytes_s > 0:
            t_swap = float(r["nbytes"]) / self._xfer_bytes_s
            t_rec = float(r["cache_len"]) / self._prefill_rows_s
            return "swap" if t_swap <= t_rec else "recompute"
        return "swap"

    def _export_payload(self, blocks):
        """Copy ``blocks``' bytes out of the target model's pools into
        host memory, timed for the transfer rate."""
        t0 = time.monotonic()
        host = _pc.payload_to_host(_pc.export_blocks(self._pools, blocks))
        self._note_xfer(_pc.payload_nbytes(host), time.monotonic() - t0)
        return host

    def _import_payload(self, blocks, payload):
        """Write a host payload into the target model's pools at
        ``blocks``, in place, on the stream the ticks replay on. The draft
        model's pools are not moved, as in the reference: after a swap or
        a restore it drafts from stale K/V there, and verification keeps
        the tokens exact."""
        _pc.import_blocks(self._pools, blocks, payload)

    def _spill_evicted(self, b, h):
        """The allocator's eviction hook: copy an evicted published
        block's bytes into the host tier under its hash, before the block
        is written again, so a later prefix hit restores it."""
        payload = self._export_payload([b])
        if self._host_tier.put(("pub", h), payload,
                               _pc.payload_nbytes(payload)):
            self._n_spilled += 1
            self._m_spill.inc()
        self._m_host_bytes.set(self._host_tier.bytes_used)

    def _restore_published(self, h):
        """A prefix hash that misses the index but hits the host tier:
        allocate a block (never preempting for it), import the bytes and
        publish it again. Returns the block id (one reference, the
        caller's) or None."""
        if self._host_tier is None:
            return None
        payload = self._host_tier.get(("pub", h))
        if payload is None or self._alloc.free_blocks < 1:
            return None
        (b,) = self._alloc.alloc(1)
        self._import_payload([b], payload)
        self._host_tier.pop(("pub", h))
        self._alloc.publish(b, h)
        self._n_restored += 1
        self._m_restore.inc()
        self._m_host_bytes.set(self._host_tier.bytes_used)
        return b

    def _note_xfer(self, nbytes, dt):
        """The host-transfer rate (EMA): the swap side of the cost
        model."""
        if dt <= 0.0 or nbytes <= 0:
            return
        bps = nbytes / dt
        self._xfer_bytes_s = bps if not self._xfer_bytes_s \
            else 0.7 * self._xfer_bytes_s + 0.3 * bps

    def _note_prefill_rate(self, rows, dt):
        """The prefill rate (EMA, rows a second, the whole tick charged
        to its prefill rows): the recompute side of the cost model."""
        if dt <= 0.0 or rows <= 0:
            return
        rps = rows / dt
        self._prefill_rows_s = rps if not self._prefill_rows_s \
            else 0.7 * self._prefill_rows_s + 0.3 * rps

    def _prefix_seed(self, adapter_id):
        """The prefix cache's hash seed of a request: the model's
        fingerprint for a base request, as the reference's; under a LoRA
        adapter one that also names the adapter and the generation of its
        weights (:func:`~paddle_tpu_torch.ops.lora.prefix_seed`), so no
        block is reused across adapters or across a hot reload. The
        reference seeds every request by the model alone (a fault: its
        adapters' K/V differ)."""
        if adapter_id is None:
            return self._fp
        return _lora.prefix_seed(self._fp, adapter_id,
                                 self._lora.generation(adapter_id))

    def _map_prefix(self, prompt, n_real, seed):
        """Map the longest published prefix of ``prompt`` (its leading
        full blocks whose chain hashes from ``seed`` hit the index, or the
        host tier) into a block list, then allocate fresh blocks for the
        rest.
        Returns ``(blocks, cached_tokens)``; on a full-prompt hit the last
        prompt token is recomputed (its logits give the next token), so
        ``cached_tokens`` is ``n_real - 1``."""
        init = _pc.blocks_for(n_real, self._bs)
        matched = []
        if self._prefix_on:
            for h in _pc.prompt_block_hashes(seed, prompt, self._bs):
                b = self._alloc.lookup(h)
                if b is not None:
                    matched.append(self._alloc.ref(b))
                    continue
                rb = self._restore_published(h)
                if rb is None:
                    break
                matched.append(rb)
        cached = len(matched) * self._bs
        if cached >= n_real:
            cached = n_real - 1
        if matched:
            self._n_prefix_blocks += len(matched)
            self._n_prefix_tokens += cached
            self._m_prefix_blocks.inc(len(matched))
            self._m_prefix_tokens.inc(cached)
        self._n_prompt_tokens += n_real
        if self._prefix_on:
            self._m_hit_rate.set(
                self._n_prefix_tokens / self._n_prompt_tokens)
        fresh = self._alloc.alloc(init - len(matched)) \
            if init > len(matched) else []
        return matched + fresh, cached

    def _cow(self, i, bidx):
        """Copy-on-write: copy the shared block at table position
        ``bidx`` of slot ``i`` into a fresh block, in both the target's
        and the draft model's pools (they share block ids), swap it into
        the table and drop the slot's reference on the original."""
        slot = self._slots[i]
        old = slot.blocks[bidx]
        (new,) = self._alloc_with_preempt(1, exclude=(i,),
                                          below=slot.priority + 1)
        _pc.copy_blocks(self._pools, old, new)
        if self._dpools is not None:
            _pc.copy_blocks(self._dpools, old, new)
        self._alloc.free([old])
        slot.blocks[bidx] = new
        if self._tables[i, bidx] == old:    # a pending row may be null
            self._tables[i, bidx] = new
            self._tables_dirty = True
        self._n_cow += 1
        self._m_cow.inc()

    def _publish(self, slot):
        """Publish ``slot``'s full blocks under the chain hashes of the
        tokens its cache holds (position p holds ``history[p]`` for p <
        ``cache_len``), from the seed it was admitted with."""
        if not self._prefix_on or slot.cache_len < self._bs:
            return
        n_full = min(len(slot.blocks), slot.cache_len // self._bs)
        for b, h in zip(slot.blocks[:n_full], _pc.chain_hashes(
                slot.seed, slot.history[:n_full * self._bs], self._bs)):
            self._alloc.publish(b, h)

    def _ensure_blocks(self, active, horizon=1):
        """Grow any slot whose next ``horizon`` write positions (a verify
        window's gamma + 1) cross into unallocated blocks. Returns the
        slots still seated: in an overcommitted pool growth preempts the
        lowest same-or-lower class, or, with no other victim, the growing
        slot itself (queued again, it skips this tick)."""
        out = []
        for i in active:
            slot = self._slots[i]
            if slot is None:        # an earlier slot's victim
                continue
            need = _pc.blocks_for(slot.cache_len + horizon, self._bs)
            grown = True
            while len(slot.blocks) < need:
                try:
                    (blk,) = self._alloc_with_preempt(
                        1, exclude=(i,), below=slot.priority + 1)
                except RuntimeError:
                    if not self._preempt_on:
                        raise
                    self._preempt(i)    # out of victims: itself
                    grown = False
                    break
                self._append_block(i, blk)
            if grown:
                out.append(i)
        # a later slot's growth may have taken an earlier survivor
        return [i for i in out if self._slots[i] is not None]

    def _append_block(self, i, blk):
        """Grow slot ``i`` by block ``blk`` (drawn on its reservation)."""
        slot = self._slots[i]
        self._tables[i, len(slot.blocks)] = blk
        slot.blocks.append(blk)
        self._tables_dirty = True
        self._reserved -= 1

    def _trim_blocks(self, i, need=None):
        """Return slot ``i``'s blocks past its first ``need`` (back under
        its reservation). Default: those only a rejected window tail
        reached; the ones within the next window's reach stay, or the
        next tick would allocate them again."""
        slot = self._slots[i]
        if need is None:
            need = _pc.blocks_for(slot.cache_len + self._gamma + 1,
                                  self._bs)
        while len(slot.blocks) > need:
            self._alloc.free([slot.blocks.pop()])
            self._tables[i, len(slot.blocks)] = 0
            self._reserved += 1
            self._tables_dirty = True

    def _finish_prefill(self, i, tok, emitted):
        """Record and emit the first token; retire at once on EOS or
        ``max_new_tokens == 1``. A recompute resume's re-prefill instead
        restores its continuation (the client holds these tokens): the
        token its last row sampled is dropped."""
        slot = self._slots[i]
        slot.cache_len = int(slot.prompt.size)
        slot.pend_pos = None
        if self._tables[i, 0] == 0:     # interleaved: publish the row now
            self._tables[i, :len(slot.blocks)] = slot.blocks
            self._tables_dirty = True
        if slot.resume is not None:
            slot.last_token, slot.n_emitted = slot.resume
            slot.resume = None
            if self._trace is not None:
                self._trace.instant("resumed", tid=1 + i,
                                    args={"rid": slot.rid})
            return
        slot.last_token = tok
        slot.history.append(tok)
        self._emit(slot.rid, tok)
        emitted.append((slot.rid, tok))
        if tok == self._eos or slot.max_new <= 1:
            self._retire(i)

    def _vacate(self, i):
        """Empty slot ``i`` (retire, cancel, preemption): its blocks back
        to the allocator (published ones park in the LRU cache), its
        reservation, table row, sampling knobs and head drafts cleared,
        its LoRA adapter unpinned (it stays resident, an eviction
        candidate). Returns the slot."""
        slot = self._slots[i]
        self._slot_props.pop(i, None)
        self._slot_adapter[i] = 0
        if slot.adapter_id is not None:
            self._lora.release(slot.adapter_id)
            self._sync_lora_metrics()
        self._alloc.free(slot.blocks)
        self._reserved -= slot.worst_blocks - len(slot.blocks)
        self._tables[i, :] = 0
        self._tables_dirty = True
        self._slots[i] = None
        self._set_slot_samp(i)
        return slot

    def _retire(self, i):
        """Retire slot ``i``: observe its end (the e2e digest, its SLO
        verdict, its request span), publish its full blocks (the prefix
        cache), free them, and hold its tokens for ``run()``
        (``retain_results``)."""
        slot = self._slots[i]
        now = time.monotonic()
        t0 = self._submit_t.pop(slot.rid, None)
        if t0 is not None:
            self._d_e2e.observe(1000.0 * (now - t0))
        if self._health is not None:
            # a request retired before its first token has no verdict:
            # it met its SLO
            self._health.on_request(self._slo_ok.pop(slot.rid, True))
        else:
            self._slo_ok.pop(slot.rid, None)
        self._last_emit.pop(slot.rid, None)
        if self._trace is not None:
            # the request's residency on the slot, admission to
            # retirement: its tick spans nest inside
            self._trace.emit(
                f"req{slot.rid}", tid=1 + i, t0=slot.admit_t, t1=now,
                args={"tokens": slot.n_emitted,
                      "cache_len": slot.cache_len})
            self._trace.instant("retired", tid=1 + i,
                                args={"rid": slot.rid})
        self._publish(slot)
        self._vacate(i)
        toks = self._results.pop(slot.rid)
        if self.config.retain_results:
            self._done[slot.rid] = np.asarray(toks, np.int64)
        self._m_completed.inc()
        self._n_completed += 1
        self._m_occupancy.set(self.num_active)
