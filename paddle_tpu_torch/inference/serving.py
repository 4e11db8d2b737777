"""Continuous-batching serving engine, core slice (counterpart of
``paddle_tpu/inference/serving.py``'s ragged engine).

One engine tick packs every live query row into ONE ragged batch: each
decoding slot gives one row; pending prompts share the tick's prefill
row budget, with one slot at the chunk width and the others trickling at
one row, exactly as the reference schedules them. The model runs the
packed rows once; each slot's continuation row is sampled; the host then
commits tokens, prefill progress and retirements. Admission is FIFO
with a worst-case block reservation (prompt + max_new_tokens), so a
running request never waits for blocks.

PyTorch runs eagerly, so the port packs exactly the live rows each tick
(the reference pads to a static width for its one compiled executable).

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

Later slices bring the prefix cache, preemption and the host tier, the
async tick, multi-LoRA, tensor parallelism, health monitoring, the
cluster and the telemetry digests; a config field, argument or
``stats()`` key asking for one of them raises ``NotImplementedError``
naming that slice.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..distributed import moe as _moe
from ..framework.place import resolve_device
from ..framework.random import generator
from ..generation import _filter_logits, _select_token
from ..generation import speculative as _spec
from ..ops import paged_cache as _pc
from ..ops.kernels import launch_counts
from ..ops.kernels.paged_attention import spec_tree_scope

__all__ = ["ServingConfig", "ServingEngine"]


# later-slice fields: accepted only at their "off" value
_LATER = {
    "enable_prefix_cache": (False, "the prefix cache"),
    "chunked_prefill": (True, "bucketed (unchunked) prefill"),
    "ragged_batch": (True, "the per-width executable path"),
    "enable_preemption": (False, "preemption and the host KV tier"),
    "async_depth": (None, "the async tick pipeline"),
    "lora_rank": (0, "multi-LoRA serving"),
    "tp_degree": (1, "tensor-parallel serving"),
    "health": (False, "the health engine"),
    "role": ("both", "disaggregated cluster serving"),
}


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
    prefill_chunk: int = 128            # widest prefill rows of one slot
    ragged_prefill_rows: Optional[int] = None   # per-tick prefill budget
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
    # -- later slices: accepted only at their off value ------------------
    enable_prefix_cache: bool = False
    chunked_prefill: bool = True
    ragged_batch: bool = True
    enable_preemption: bool = False
    async_depth: Optional[int] = None
    lora_rank: int = 0
    tp_degree: int = 1
    health: bool = False
    role: str = "both"

    def __post_init__(self):
        for name, (off, what) in _LATER.items():
            v = getattr(self, name)
            if v != off and not (name == "async_depth" and v == 0):
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


class _Slot:
    __slots__ = ("rid", "blocks", "worst_blocks", "cache_len",
                 "last_token", "n_emitted", "max_new", "prompt", "pend_pos",
                 "history")

    def __init__(self, rid, blocks, worst_blocks, max_new, prompt):
        self.rid = rid
        self.blocks = blocks            # allocated block ids (ordered)
        self.worst_blocks = worst_blocks
        self.cache_len = 0              # valid cache positions
        self.last_token = None
        self.n_emitted = 1              # counts the first token once out
        self.max_new = max_new
        self.prompt = prompt            # int32 prompt
        self.pend_pos = 0               # next prefill row; None = decoding
        # prompt + emitted tokens: the n-gram drafter's lookup corpus
        self.history = [int(t) for t in prompt]


class _Stats(dict):
    """``stats()``'s dict: a key that a later slice brings raises
    ``NotImplementedError`` naming it (any other missing key: KeyError)."""

    _LATER = {"spec_accept_len": "the P-squared digest of tokens a verify "
                                 "(the telemetry digests of monitor/digest.py)"}

    def __missing__(self, key):
        if key in self._LATER:
            raise NotImplementedError(
                f"stats()[{key!r}] is {self._LATER[key]}, which comes with "
                "a later slice of the PyTorch port")
        raise KeyError(key)


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
    ``drafter="heads"``.
    """

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
        self.model = model.eval()
        self.config = cfg
        self.device = dev
        self._stream = stream_callback
        self._do_sample = cfg.decode_strategy == "sampling"
        self._samp_default = np.asarray(
            [float(cfg.temperature), float(cfg.top_k), float(cfg.top_p)],
            np.float32)
        self._slot_samp = np.tile(self._samp_default, (cfg.num_slots, 1))
        self._samp_dev = None
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
        self._n_spec_proposed = 0
        self._n_spec_accepted = 0
        self._n_spec_verifies = 0       # slot verify windows
        self._n_spec_emitted = 0

        self._bs = int(cfg.block_size)
        self._mb = _pc.blocks_for(cfg.max_model_len + gamma, self._bs)
        nb = (1 + cfg.num_slots * self._mb) if cfg.num_blocks is None \
            else int(cfg.num_blocks)
        self._alloc = _pc.BlockAllocator(nb)
        self._chunk = max(1, min(int(cfg.prefill_chunk),
                                 int(cfg.max_model_len)))
        want = cfg.ragged_prefill_rows
        self._prefill_rows = max(1, min(
            int(self._chunk if want is None else want),
            int(cfg.max_model_len)))
        # pad rows (none today: the port packs live rows only) would park
        # past every table's reach, where writes null-route
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
        self._tables_dev = None
        self._slots: List[Optional[_Slot]] = [None] * cfg.num_slots
        self._reserved = 0              # blocks promised to active slots
        self._queue: deque = deque()
        self._results: Dict[int, list] = {}
        self._done: Dict[int, np.ndarray] = {}
        self._next_rid = 0
        self._eos = -1 if cfg.eos_token_id is None else int(cfg.eos_token_id)
        self._pad = int(cfg.pad_token_id)
        self._submit_t: Dict[int, float] = {}
        self._first_t: Dict[int, float] = {}
        self._ttft_ms: List[float] = []
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

    # -- front door ----------------------------------------------------

    def submit(self, prompt, max_new_tokens=None, temperature=None,
               top_k=None, top_p=None, priority=0, max_queue_wait_ms=None,
               adapter_id=None) -> int:
        """Queue one request; returns its request id. ``temperature`` /
        ``top_k`` / ``top_p`` override the config for this request
        (sampling engines only)."""
        if priority != 0 or max_queue_wait_ms is not None:
            raise NotImplementedError(
                "priorities and queue-wait budgets come with the "
                "preemptive-scheduling slice of the PyTorch port")
        if adapter_id is not None:
            raise NotImplementedError(
                "adapter_id comes with the multi-LoRA slice of the "
                "PyTorch port")
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
        rid = self._next_rid
        self._next_rid += 1
        req = ServingRequest(
            rid, ids, max_new, time.monotonic(),
            temperature=None if temperature is None else float(temperature),
            top_k=None if top_k is None else int(top_k),
            top_p=None if top_p is None else float(top_p))
        self._queue.append(req)
        self._submit_t[rid] = req.submit_time
        return rid

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
        done, self._done = self._done, {}
        return done

    def serve(self, prompts, max_new_tokens=None) -> List[np.ndarray]:
        """Submit all, run to completion, return token arrays in
        submission order."""
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        done = self.run()
        return [done[r] for r in rids]

    def stats(self) -> dict:
        ttft = np.asarray(self._ttft_ms, np.float64)
        out = _Stats({
            "active": self.num_active,
            "queued": self.num_queued,
            "free_blocks": self._alloc.free_blocks,
            "reserved_blocks": self._reserved,
            "ticks": self._n_ticks,
            "rows_total": self._n_rows,
            "tokens_total": self._n_tokens,
            "requests_completed": self._n_completed,
            "prefill_chunks": self._n_prefill_chunks,
            "fused_decode": bool(self.config.fused_decode),
            "device": str(self.device),
            "kernel_launches": dict(launch_counts),
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
            "ttft_ms": {
                "count": int(ttft.size),
                "mean": float(ttft.mean()) if ttft.size else 0.0,
                "p50": float(np.percentile(ttft, 50)) if ttft.size else 0.0,
                "max": float(ttft.max()) if ttft.size else 0.0,
            },
            # always present (0 on linear and non-speculative engines)
            "spec_tree_nodes": len(self._tree) + 1 if self._tree else 0,
        })
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
        (every block free or owned by a live slot)."""
        self._queue.clear()
        if check_leaks:
            live = [b for s in self._slots if s is not None
                    for b in s.blocks]
            self._alloc.check_leaks(live)
        return True

    # -- one tick ------------------------------------------------------

    def step(self) -> List[tuple]:
        """One engine tick: admit what fits, run ONE ragged batch over
        every decoding slot's row (its verify window when speculating)
        and this tick's prefill rows, commit tokens and retire finished
        requests. Returns this tick's ``[(request_id, token), ...]``."""
        self._admit()
        emitted: List[tuple] = []
        cfg = self.config
        g = self._gamma
        n_slots = cfg.num_slots
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.pend_pos is None]
        pending = [i for i, s in enumerate(self._slots)
                   if s is not None and s.pend_pos is not None]
        if not active and not pending:
            return emitted
        self._ensure_blocks(active, horizon=g + 1)

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
            return emitted
        row_slot, row_pos, row_starts, last_rows = _pc.ragged_row_meta(
            q_lens, base, total, self._overflow)
        ids = np.full(total, self._pad, np.int32)
        for i, k in given.items():
            s0 = int(row_starts[i])
            slot = self._slots[i]
            ids[s0:s0 + k] = slot.prompt[slot.pend_pos:slot.pend_pos + k]
        dev = self.device
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self._tables).to(dev)
        with torch.no_grad():
            if self._draft is not None and given:
                self._prime_draft(given, q_lens, base, ids, row_starts)
            for i in active:
                ids[row_starts[i]] = self._slots[i].last_token
            spec = self._draft_tick(active, base, ids, row_starts) \
                if g and active else None
            tok, spec = self._forward(active, q_lens, base, ids, row_slot,
                                      row_pos, row_starts, last_rows, spec)
        self._n_ticks += 1
        self._n_rows += total
        # packed row t of slot s attends base[s] + t + 1 positions
        self._kv_step_bytes_last = int(
            (int((q_lens * base).sum())
             + int((q_lens * (q_lens + 1) // 2).sum())) * self._kv_pos_bytes)

        # -- commit decode / verify rows ---------------------------------
        if spec is None:
            for i in active:
                slot = self._slots[i]
                t = int(tok[i])
                slot.cache_len += 1
                slot.last_token = t
                slot.n_emitted += 1
                slot.history.append(t)
                self._emit(slot.rid, t)
                emitted.append((slot.rid, t))
                if t == self._eos or slot.n_emitted >= slot.max_new:
                    self._retire(i)
        else:
            out, accept, props = spec
            for k, i in enumerate(active):
                self._commit_verify_window(i, out[k], accept[k], emitted)
                if props is not None and self._slots[i] is not None:
                    # the heads' tree for the slot's next tick
                    self._slot_props[i] = props[k]
        # -- commit prefill progress -------------------------------------
        for i, k in given.items():
            slot = self._slots[i]
            slot.pend_pos += k
            slot.cache_len = slot.pend_pos
            self._n_prefill_chunks += 1
            if slot.pend_pos >= int(slot.prompt.size):
                # the chunk's last row is the final prompt row: its logits
                # give the request's first token
                self._finish_prefill(i, int(tok[i]), emitted)
        return emitted

    def _prime_draft(self, given, q_lens, base, ids, row_starts):
        """Write the draft model's cache over the tick's prefill rows
        (``given``: slot -> rows) by its ragged forward; the verify
        windows' K/V come from its scan."""
        dev = self.device
        pq = np.zeros_like(q_lens)
        for i, k in given.items():
            pq[i] = k
        p_slot, p_pos, p_starts, _ = _pc.ragged_row_meta(
            pq, base, int(pq.sum()), self._overflow)
        p_ids = np.concatenate([ids[int(row_starts[i]):int(row_starts[i]) + k]
                                for i, k in given.items()])
        prow = torch.from_numpy(np.stack([p_ids, p_slot, p_pos])).to(dev)
        pslots = torch.from_numpy(np.stack(
            [base, pq, p_starts]).astype(np.int32)).to(dev)
        _, self._dpools = self._draft(
            prow[0], caches=self._dpools, block_tables=self._tables_dev,
            cache_lens=pslots[0],
            ragged_meta=(pslots[1], pslots[2], prow[1], prow[2],
                         int(pq.max())),
            last_rows=pslots[2][:1], fused=self.config.fused_decode)

    def _draft_tick(self, active, base, ids, row_starts):
        """This tick's drafts for the verifying slots ``active``: their
        windows ``[last token, gamma drafts]`` go into ``ids`` (host
        drafters) or stay on the device (the draft model, whose scan is
        never read back before the verify). Returns ``(toks [A, gamma +
        1] on the device, the draft's filtered distributions [A, gamma,
        V] or None, the window rows' drafts still to place in the packed
        ids: (row indices, tokens) or None)``."""
        g = self._gamma
        dev = self.device
        cur = np.asarray([self._slots[i].last_token for i in active],
                         np.int64)
        if self._draft is None:
            toks = np.empty((len(active), g + 1), np.int64)
            toks[:, 0] = cur
            for k, i in enumerate(active):
                hist = self._slots[i].history
                toks[k, 1:] = self._tree_draft(i) if self._tree is not None \
                    else _spec.ngram_propose(hist, g, self._ngram_max)
                s0 = int(row_starts[i])
                ids[s0 + 1:s0 + g + 1] = toks[k, 1:]
            return torch.from_numpy(toks).to(dev), None, None
        # the draft model: its gamma + 1 steps over the verifying slots
        act = np.asarray(active, np.int64)
        widx = (row_starts[act].astype(np.int64)[:, None]
                + np.arange(1, g + 1)[None, :]).reshape(-1)
        up = torch.from_numpy(np.concatenate(
            [act, base[act], cur, widx])).to(dev)
        n = len(active)
        act_d, lens_d, cur_d, widx_d = (up[:n], up[n:2 * n],
                                        up[2 * n:3 * n], up[3 * n:])
        props, dq, self._dpools = self._dloop(
            self._dpools, self._tables_dev[act_d], lens_d.int(), cur_d,
            self._samp()[act_d], self._gen)
        toks = torch.cat([cur_d[:, None], props.long()], 1)
        return toks, dq, (widx_d, props.reshape(-1))

    def _forward(self, active, q_lens, base, ids, row_slot, row_pos,
                 row_starts, last_rows, spec):
        """The tick's one ragged forward over the packed rows and its
        sampling. Without speculation: ``(tokens [S] on the host,
        None)``. With it: ``(first tokens [S], (out [A, gamma + 1], accept
        [A, gamma], the heads' next drafts [A, gamma] or None))`` on the
        host, the verify windows accepted (and, with a tree, the accepted
        paths that leave the spine moved onto the linear tail of every
        layer's pools)."""
        cfg = self.config
        g = self._gamma
        n_slots = cfg.num_slots
        dev = self.device
        tree_on = spec is not None and self._tree is not None
        srows = [base, q_lens, row_starts, last_rows]
        if tree_on:
            flags = np.zeros(n_slots, np.int64)
            flags[active] = 1           # prefill rows keep the linear bound
            srows.append(flags)
        # two uploads carry the tick's layout: the per-row triple and the
        # per-slot rows
        rows = torch.from_numpy(np.stack([ids, row_slot, row_pos])).to(dev)
        slots = torch.from_numpy(np.stack(srows).astype(np.int32)).to(dev)
        if spec is not None and spec[2] is not None:
            widx, props = spec[2]       # the draft model's, on the device
            rows[0].index_copy_(0, widx, props.to(rows.dtype))
        meta = (slots[1], slots[2], rows[1], rows[2], int(q_lens.max()))
        take = slots[3]
        if spec is not None:
            # one LM head over each slot's continuation row and window
            take = torch.cat([slots[3][:, None], slots[2][:, None]
                              + torch.arange(g + 1, device=dev,
                                             dtype=torch.int32)[None, :]],
                             1).reshape(-1).clamp(0, int(q_lens.sum()) - 1)
        counts = []                     # each sparse layer's expert counts
        tap = _moe.serving_stats_tap(counts) if self._moe_tap_on \
            else contextlib.nullcontext()
        # a flagged slot's rows are its window's g + 1
        scope = spec_tree_scope(self._tree, slots[4], g + 1) if tree_on \
            else contextlib.nullcontext()
        if self._moe:
            _moe.MOE_STATS["grouped_mm_kernel"] = None
        heads_on = spec is not None and self._heads is not None
        with tap, scope:
            logits, self._pools = self.model(
                rows[0], caches=self._pools, block_tables=self._tables_dev,
                cache_lens=slots[0], ragged_meta=meta, last_rows=take,
                fused=cfg.fused_decode,
                **({"return_hidden": True} if heads_on else {}))
        if heads_on:
            logits, hid = logits
        self.last_logits = logits
        if spec is None:
            parts = [self._select(logits).long()]
        else:
            lg = logits.reshape(n_slots, g + 2, -1)
            first = self._select(lg[:, 0])
            act = torch.as_tensor(active, device=dev)
            toks, dq = spec[0], spec[1]
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
        flat = torch.cat(parts).cpu().numpy()
        tok = flat[:n_slots]
        if counts:
            self._observe_moe(flat[flat.size - len(counts) * counts[0]
                                   .numel():].reshape(len(counts), -1))
        if self._moe and _moe.MOE_STATS["grouped_mm_kernel"] == "fused_gmm":
            self._moe_fused = True
        if spec is None:
            return tok, None
        a = len(active)
        o = n_slots
        out = flat[o:o + a * (g + 1)].reshape(a, g + 1)
        o += a * (g + 1)
        accept = flat[o:o + a * g].reshape(a, g).astype(bool)
        o += a * g
        if self._tree is not None:
            # the accepted root path onto the linear tail of every layer,
            # its addresses worked out once; a path along the spine (node
            # j at depth j, a chain's always) is in place already
            path_h = flat[o:o + a * (g + 1)].reshape(a, g + 1)
            o += a * (g + 1)
            n_keep = accept.sum(1) + 1
            off = [k for k in range(a) if np.any(
                path_h[k, :n_keep[k]] != np.arange(n_keep[k]))]
            if off:
                sel = act[torch.as_tensor(off, device=dev)]
                moves = _pc.window_moves(
                    self._bs, self._tables_dev[sel], slots[0][sel],
                    path[off], torch.as_tensor(n_keep[off], device=dev))
                for kp, vp in self._pools:
                    _pc.move_rows(kp, vp, moves)
        props = flat[o:o + a * g].reshape(a, g) if heads_on else None
        return tok, (out, accept, props)

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
            self._moe_ent_last = ent / float(np.log(max(load.size, 2)))
            self._moe_load_max_last = float(load.max())
            self._n_moe_dispatches += 1

    def _worst_for(self, n_real, max_new) -> int:
        return _pc.blocks_for(int(n_real) + int(max_new) + self._gamma,
                              self._bs)

    def _samp(self):
        """The per-slot knobs ``[S, 3]`` (temperature, top_k, top_p) on
        the device, uploaded again only after a slot's row changed."""
        if self._samp_dev is None:
            self._samp_dev = torch.from_numpy(self._slot_samp).to(
                self.device)
        return self._samp_dev

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

    def _commit_verify_window(self, i, out_row, accept_row, emitted):
        """Commit slot ``i``'s verified window: emit the kept prefix (cut
        at an EOS and at ``max_new_tokens``), count the drafts used,
        retire the slot when it is done, else advance its length over the
        accepted prefix (the rejected tail rolls back by not advancing)
        and trim the blocks past the next window's reach."""
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
        self._n_spec_proposed += g
        self._n_spec_accepted += min(n_acc, len(kept))
        self._n_spec_verifies += 1
        self._n_spec_emitted += len(kept)
        if kept[-1] == self._eos or slot.n_emitted >= slot.max_new:
            self._retire(i)
        else:
            slot.cache_len += n_acc + 1
            slot.last_token = kept[-1]
            self._trim_blocks(i)

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
            self._samp_dev = None

    def _emit(self, rid, tok):
        """Single exit point for generated tokens."""
        if rid not in self._first_t:
            now = time.monotonic()
            self._first_t[rid] = now
            self._ttft_ms.append(1000.0 * (now - self._submit_t[rid]))
        self._results[rid].append(tok)
        self._n_tokens += 1
        if self._stream is not None:
            self._stream(rid, tok)

    def _admit(self):
        """FIFO admission with the worst-case block reservation: the head
        of the queue takes a free slot when the pool can cover its prompt
        plus ``max_new_tokens`` on top of every active reservation."""
        while self._queue:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                break
            req = self._queue[0]
            n_real = int(req.prompt.size)
            worst = self._worst_for(n_real, req.max_new_tokens)
            if self._alloc.free_blocks - self._reserved < worst:
                break
            self._queue.popleft()
            i = free[0]
            blocks = self._alloc.alloc(_pc.blocks_for(n_real, self._bs))
            self._reserved += worst - len(blocks)
            self._tables[i, :] = 0
            self._tables[i, :len(blocks)] = blocks
            self._tables_dev = None
            self._results[req.request_id] = []
            self._slots[i] = _Slot(req.request_id, blocks, worst,
                                   req.max_new_tokens, req.prompt)
            self._set_slot_samp(i, req)

    def _ensure_blocks(self, active, horizon=1):
        """Grow any slot whose next ``horizon`` write positions (a verify
        window's gamma + 1) cross into unallocated blocks (covered by its
        admission reservation)."""
        for i in active:
            slot = self._slots[i]
            need = _pc.blocks_for(slot.cache_len + horizon, self._bs)
            while len(slot.blocks) < need:
                (blk,) = self._alloc.alloc(1)
                self._tables[i, len(slot.blocks)] = blk
                slot.blocks.append(blk)
                self._tables_dev = None
                self._reserved -= 1

    def _trim_blocks(self, i):
        """Return the blocks only a rejected window tail reached (back
        under the slot's reservation); those within the next window's
        reach stay, or the next tick would allocate them again."""
        slot = self._slots[i]
        need = _pc.blocks_for(slot.cache_len + self._gamma + 1, self._bs)
        while len(slot.blocks) > need:
            self._alloc.free([slot.blocks.pop()])
            self._tables[i, len(slot.blocks)] = 0
            self._reserved += 1
            self._tables_dev = None

    def _finish_prefill(self, i, tok, emitted):
        """Record and emit the first token; retire at once on EOS or
        ``max_new_tokens == 1``."""
        slot = self._slots[i]
        slot.cache_len = int(slot.prompt.size)
        slot.pend_pos = None
        slot.last_token = tok
        slot.history.append(tok)
        self._emit(slot.rid, tok)
        emitted.append((slot.rid, tok))
        if tok == self._eos or slot.max_new <= 1:
            self._retire(i)

    def _retire(self, i):
        slot = self._slots[i]
        self._slot_props.pop(i, None)
        self._alloc.free(slot.blocks)
        self._reserved -= slot.worst_blocks - len(slot.blocks)
        self._tables[i, :] = 0
        self._tables_dev = None
        self._slots[i] = None
        self._set_slot_samp(i)
        self._submit_t.pop(slot.rid, None)
        self._first_t.pop(slot.rid, None)
        self._done[slot.rid] = np.asarray(self._results.pop(slot.rid),
                                          np.int64)
        self._n_completed += 1
