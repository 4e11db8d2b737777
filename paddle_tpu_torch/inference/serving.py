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

Later slices bring speculation, the prefix cache, preemption and the
host tier, the async tick, multi-LoRA, tensor parallelism,
health monitoring and the cluster; a config field or argument asking
for one of them raises ``NotImplementedError`` naming that slice.
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
from ..generation import _select_token
from ..ops import paged_cache as _pc
from ..ops.kernels import launch_counts

__all__ = ["ServingConfig", "ServingEngine"]


# later-slice fields: accepted only at their "off" value
_LATER = {
    "num_speculative_tokens": (0, "speculative decoding"),
    "spec_tree": (None, "tree speculation"),
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
    # -- later slices: accepted only at their off value ------------------
    num_speculative_tokens: int = 0
    spec_tree: Optional[tuple] = None
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
                 "last_token", "n_emitted", "max_new", "prompt", "pend_pos")

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
    which must be the model's device.
    """

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 stream_callback: Optional[Callable] = None, device=None,
                 draft_model=None, spec_heads=None):
        if draft_model is not None or spec_heads is not None:
            raise NotImplementedError(
                "draft models and draft heads come with the speculative "
                "decoding slice of the PyTorch port")
        if not hasattr(model, "init_paged_caches"):
            raise TypeError(f"{type(model).__name__} does not implement "
                            "init_paged_caches (paged-KV serving)")
        cfg = config or ServingConfig()
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"model is on {model.device}, engine on {dev}: "
                             "build the model on the engine's device")
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
        max_pos = getattr(model.config, "max_position_embeddings", None)
        if max_pos is not None and cfg.max_model_len > max_pos:
            raise ValueError(f"max_model_len ({cfg.max_model_len}) exceeds "
                             f"the model's max_position_embeddings "
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

        self._bs = int(cfg.block_size)
        self._mb = _pc.blocks_for(cfg.max_model_len, self._bs)
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
        return {
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
        }

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
        every decoding slot's row and this tick's prefill rows, commit
        tokens and retire finished requests. Returns this tick's
        ``[(request_id, token), ...]``."""
        self._admit()
        emitted: List[tuple] = []
        cfg = self.config
        n_slots = cfg.num_slots
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.pend_pos is None]
        pending = [i for i, s in enumerate(self._slots)
                   if s is not None and s.pend_pos is not None]
        if not active and not pending:
            return emitted
        self._ensure_blocks(active)

        # -- pack the tick's work into per-slot row counts --------------
        q_lens = np.zeros(n_slots, np.int64)
        base = np.zeros(n_slots, np.int64)
        given = {}              # slot -> prefill rows granted this tick
        cap = min(self._chunk, self._prefill_rows)
        budget = self._prefill_rows
        for i in active:
            q_lens[i] = 1
            base[i] = self._slots[i].cache_len
        for i in pending:
            if budget <= 0:
                break
            slot = self._slots[i]
            # ONE chunk-width slot per tick; later pending slots trickle
            # at one row, so nothing starves
            cap_i = cap if not given else 1
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
        for i in active:
            ids[row_starts[i]] = self._slots[i].last_token
        for i, k in given.items():
            s0 = int(row_starts[i])
            slot = self._slots[i]
            ids[s0:s0 + k] = slot.prompt[slot.pend_pos:slot.pend_pos + k]

        # two uploads carry the tick's layout: the per-row triple and the
        # per-slot quad
        dev = self.device
        rows = torch.from_numpy(np.stack([ids, row_slot, row_pos])).to(dev)
        slots = torch.from_numpy(np.stack(
            [base, q_lens, row_starts, last_rows]).astype(np.int32)).to(dev)
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self._tables).to(dev)
        meta = (slots[1], slots[2], rows[1], rows[2], int(q_lens.max()))
        counts = []                     # each sparse layer's expert counts
        tap = _moe.serving_stats_tap(counts) if self._moe_tap_on \
            else contextlib.nullcontext()
        if self._moe:
            _moe.MOE_STATS["grouped_mm_kernel"] = None
        with torch.no_grad(), tap:
            logits, self._pools = self.model(
                rows[0], caches=self._pools, block_tables=self._tables_dev,
                cache_lens=slots[0], ragged_meta=meta, last_rows=slots[3],
                fused=cfg.fused_decode)
        self.last_logits = logits
        tok = self._select(logits)
        if counts:      # one read-back for the tokens and the counts
            flat = torch.cat([tok.long(), torch.stack(counts).reshape(-1)
                              .long()]).cpu().numpy()
            tok = flat[:n_slots]
            self._observe_moe(flat[n_slots:].reshape(len(counts), -1))
        else:
            tok = tok.cpu().numpy()
        if self._moe and _moe.MOE_STATS["grouped_mm_kernel"] == "fused_gmm":
            self._moe_fused = True
        self._n_ticks += 1
        self._n_rows += total
        # packed row t of slot s attends base[s] + t + 1 positions
        self._kv_step_bytes_last = int(
            (int((q_lens * base).sum())
             + int((q_lens * (q_lens + 1) // 2).sum())) * self._kv_pos_bytes)

        # -- commit decode rows ------------------------------------------
        for i in active:
            slot = self._slots[i]
            t = int(tok[i])
            slot.cache_len += 1
            slot.last_token = t
            slot.n_emitted += 1
            self._emit(slot.rid, t)
            emitted.append((slot.rid, t))
            if t == self._eos or slot.n_emitted >= slot.max_new:
                self._retire(i)
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
        return _pc.blocks_for(int(n_real) + int(max_new), self._bs)

    def _select(self, logits):
        if not self._do_sample:
            tok, _ = _select_token(logits, do_sample=False)
            return tok
        if self._samp_dev is None:
            self._samp_dev = torch.from_numpy(self._slot_samp).to(
                logits.device)
        samp = self._samp_dev
        tok, _ = _select_token(logits, self._gen, do_sample=True,
                               temperature=samp[:, 0], top_k=samp[:, 1],
                               top_p=samp[:, 2])
        return tok

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

    def _ensure_blocks(self, active):
        """Grow any slot whose next write position crosses into an
        unallocated block (covered by its admission reservation)."""
        for i in active:
            slot = self._slots[i]
            need = _pc.blocks_for(slot.cache_len + 1, self._bs)
            while len(slot.blocks) < need:
                (blk,) = self._alloc.alloc(1)
                self._tables[i, len(slot.blocks)] = blk
                slot.blocks.append(blk)
                self._tables_dev = None
                self._reserved -= 1

    def _finish_prefill(self, i, tok, emitted):
        """Record and emit the first token; retire at once on EOS or
        ``max_new_tokens == 1``."""
        slot = self._slots[i]
        slot.cache_len = int(slot.prompt.size)
        slot.pend_pos = None
        slot.last_token = tok
        self._emit(slot.rid, tok)
        emitted.append((slot.rid, tok))
        if tok == self._eos or slot.max_new <= 1:
            self._retire(i)

    def _retire(self, i):
        slot = self._slots[i]
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
