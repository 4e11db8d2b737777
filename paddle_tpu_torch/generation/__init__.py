"""LLM generation (counterpart of ``paddle_tpu/generation/__init__.py``):
``GenerationMixin.generate`` over the KV cache, and the token selection
the serving engine shares with it.

``generate()`` prefills the prompt into the cache, then decodes one
token per step in a host loop (the reference's jitted
``lax.while_loop``), stopping early once every row has emitted EOS (a
flag read one step late, so the device is never waited on a step). On
CUDA the paged decode step and the speculative verify step (with a draft
model's loop) are captured once a run into a CUDA graph and replayed;
the dense path's step, whose cache offset is a new host int every step,
and every step on the CPU run eagerly. Three cache paths, as in the
reference: the dense ``[B, S, H_kv, D]`` cache (``cached_attention``),
the paged block pool (K2d each step), and speculative decoding over the
pool (``generation/speculative.py``, K2v verify windows): a linear chain
of drafts, or with ``spec_tree`` (a parent tuple of gamma nodes) a token
tree that the n-gram drafter fills and one K2v window in tree mode
verifies. Prompts on the dense path are left-padded to a power-of-two
bucket with a pad mask and per-row rope positions, as the reference
does, so the two packages decode the same numbers.

Token selection: the knobs may be python numbers (one value for the
batch) or tensors of per-row values (the serving engine's per-slot
sampling rows); a disabled filter (``top_k == 0``, ``top_p == 1``)
masks nothing, so uniform per-row knobs give the same logits as the
scalar path. Sampling draws from an explicit ``torch.Generator``
(``generate()`` seeds one with ``seed``): the same seed gives the same
tokens on the same device, but not the reference's JAX draws.

``kv_cache_dtype="int8"`` keeps the paged cache (and both models' pools
under speculation) in int8 with a float32 scale a position and kv head;
it selects the paged cache, and refuses an explicit dense one.

Beam and group-beam search (``decode_strategy="beam_search"`` /
``"group_beam_search"``) run on the dense cache (``generation/beam.py``),
with the reference's refusals: no left-padded prompts, no sampling knobs,
no paged cache, no speculation. ``export_generation`` writes a
deployable artifact with the decoding configuration baked in, and
:func:`load_generation` runs it. The reference's env switches are not
carried over; the port follows their defaults.
"""
from __future__ import annotations

import inspect
import json
import os
from dataclasses import asdict, dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..distributed.moe import capacity_routed
from ..framework.random import generator as make_generator
from ..ops import paged_cache as _pc
from ..ops.cuda_graphs import GraphedStep, graphs_usable

__all__ = ["GenerationConfig", "GenerationMixin", "LoadedGeneration",
           "load_generation", "_filter_logits", "_select_token",
           "categorical"]


@dataclass
class GenerationConfig:
    max_new_tokens: int = 20
    # greedy_search | sampling | beam_search | group_beam_search
    decode_strategy: str = "greedy_search"
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    num_beams: int = 1
    num_beam_groups: int = 1
    diversity_rate: float = 0.0
    length_penalty: float = 0.0
    early_stopping: bool = False
    eos_token_id: Optional[int] = None
    pad_token_id: Optional[int] = None
    seed: Optional[int] = None
    # dense | paged (the serving block pool, K2d each decode step)
    cache_impl: str = "dense"
    kv_block_size: int = 16
    # None / "auto": pools in the model dtype; "int8": int8 pools (paged)
    kv_cache_dtype: Optional[str] = None
    # left-pad dense-path prompts up to power-of-two length buckets
    pad_prompt_to_bucket: bool = True
    # speculative decoding: gamma drafted tokens verified per step (0 off)
    num_speculative_tokens: int = 0
    # longest suffix n-gram the prompt-lookup drafter matches
    spec_ngram_max: int = 3


def _prompt_bucket(n: int, minimum: int = 8) -> int:
    """Smallest power-of-two bucket >= n (floor ``minimum``)."""
    b = int(minimum)
    while b < n:
        b *= 2
    return b


def _per_row(v, logits):
    """A knob as a float32 tensor broadcastable over ``logits``' leading
    dims (trailing axes appended)."""
    t = torch.as_tensor(v, dtype=torch.float32, device=logits.device)
    if t.dim():
        t = t.reshape(tuple(t.shape) + (1,) * (logits.dim() - 1 - t.dim()))
    return t


def _filter_logits(logits, *, do_sample, temperature=1.0, top_k=0,
                   top_p=1.0):
    """Temperature / top-k / top-p over ``[..., V]`` logits; returns
    float32 logits with filtered entries at ``-inf``."""
    logits = logits.float()
    if not do_sample:
        return logits
    v_dim = logits.shape[-1]
    t = _per_row(temperature, logits)
    logits = logits / torch.clamp(t, min=1e-6)[..., None]
    k = _per_row(top_k, logits).long()
    p = _per_row(top_p, logits)
    # each filter is the identity on rows that ask for none, so under a
    # CUDA graph capture (which cannot read a device value back) both run
    capturing = logits.is_cuda and torch.cuda.is_current_stream_capturing()
    if capturing or bool((k > 0).any()):
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        idx = torch.clamp(k - 1, 0, v_dim - 1)[..., None]
        kth = torch.gather(sorted_desc, -1,
                           idx.expand(logits.shape[:-1] + (1,)))
        logits = torch.where((k[..., None] > 0) & (logits < kth),
                             torch.full_like(logits, float("-inf")), logits)
    if capturing or bool((p < 1.0).any()):
        sorted2 = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted2, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until the cumulative probability of the tokens kept
        # before them exceeds top_p (the first is always kept); rows with
        # p == 1 mask nothing
        drop = (cum - probs > p[..., None]) & (p[..., None] < 1.0)
        kept = torch.where(drop, torch.full_like(sorted2, float("inf")),
                           sorted2)
        thresh = torch.min(kept, dim=-1, keepdim=True).values
        logits = torch.where(logits < thresh,
                             torch.full_like(logits, float("-inf")), logits)
    return logits


def categorical(probs, generator=None):
    """One draw a row of ``probs [B, V]`` (int64 ``[B]``):
    ``torch.multinomial(probs, 1, generator=generator)[:, 0]``'s own
    one-sample path written out (the argmax of ``probs`` over Exp(1)
    draws on ``generator``), so it draws the same tokens from the same
    generator state, without multinomial's host-side check of the
    probabilities, a read-back that a CUDA graph cannot capture."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)


def _select_token(logits, generator=None, *, do_sample,
                  temperature=1.0, top_k=0, top_p=1.0):
    """``(token [B] int64, logprob of token [B])`` for ``[B, V]``
    logits: argmax when greedy, else a draw from the filtered
    distribution on ``generator``."""
    lg = _filter_logits(logits, do_sample=do_sample,
                        temperature=temperature, top_k=top_k, top_p=top_p)
    logp = torch.log_softmax(lg, dim=-1)
    if do_sample:
        tok = categorical(torch.softmax(lg, dim=-1), generator)
    else:
        tok = torch.argmax(lg, dim=-1)
    return tok, torch.gather(logp, -1, tok[:, None])[:, 0]


def _paged_prefill(model, ids, mb, block_size, kv_cache_dtype=None):
    """Contiguous static block tables ``[B, mb]`` (``generate()`` owns
    the whole pool; block 0 stays null) and fresh pools holding the
    prompt's K/V (int8 pools with ``kv_cache_dtype="int8"``): the prompt
    prefills through the dense cached path and its K/V scatter into the
    blocks. Returns ``(logits, tables, pools)``."""
    b = ids.shape[0]
    tables = (1 + torch.arange(b * mb, dtype=torch.int32,
                               device=ids.device)).reshape(b, mb)
    kw = {"kv_cache_dtype": kv_cache_dtype} if kv_cache_dtype else {}
    pools = model.init_paged_caches(1 + b * mb, block_size, **kw)
    logits, dense = model(ids, caches=model.init_caches(*ids.shape),
                          offset=0)
    for (kp, vp), (dk, dv) in zip(pools, dense):
        _pc.write_prefill(kp, vp, tables, dk, dv)
    return logits, tables, pools


class _LateFlag:
    """``done.all()`` read one step late: :meth:`push` after a step
    copies it without blocking (into pinned memory on CUDA, with an
    event), :meth:`late` reads the flag pushed before the last one, whose
    step the device has long finished."""

    def __init__(self, done):
        self.done, self.cuda = done, done.is_cuda
        self.host = [torch.zeros((), dtype=torch.bool, pin_memory=self.cuda)
                     for _ in range(2)]
        self.events = [torch.cuda.Event() for _ in range(2)] \
            if self.cuda else None
        self.n = 0

    def push(self):
        k = self.n % 2
        self.host[k].copy_(self.done.all(), non_blocking=self.cuda)
        if self.cuda:
            self.events[k].record()
        self.n += 1

    def late(self) -> bool:
        if self.n < 2:
            return False
        k = self.n % 2
        if self.cuda:
            self.events[k].synchronize()
        return bool(self.host[k].item())


def _decode_loop(step, first, caches, max_new, select, eos, pad,
                 graphed=False, generator=None):
    """The decode loop of both cache paths, from the prefill's ``first =
    (token [B], logprob [B])``: ``step(i, tok, caches) -> (logits,
    caches)`` feeds the previous token at step ``i``. A step's device
    work (the forward, ``select``, the done and score updates, the token
    written at its column) updates tensors that keep their address, so
    with ``graphed`` (the paged path on CUDA) step 1 runs eagerly, step 2
    captures it into a CUDA graph (``generator`` registered) and later
    steps replay it: ``step`` must then take its position from device
    state (the paged step's length counter), not from ``i``.

    With an EOS (``eos >= 0``) the loop ends once every row has emitted
    it, read one step late (:class:`_LateFlag`): the loop may run one
    forward past the step on which the last row emitted EOS, a step that
    writes pads and adds no score, so the tokens and scores are those of
    an immediate exit (the reference's in-loop test). Without an EOS
    nothing is read. Returns ``(out [B, max_new] int64, pad-filled after
    EOS, scores [B])``."""
    tok, logp = first
    done = tok == eos
    out = torch.full((tok.shape[0], max_new), pad, dtype=torch.int64,
                     device=tok.device)
    out[:, 0] = torch.where(done, torch.full_like(tok, eos), tok)
    tok, score = tok.clone(), logp.clone()
    col = torch.ones((tok.shape[0], 1), dtype=torch.int64, device=tok.device)
    state = {"i": 1, "caches": caches}

    def body():
        logits, state["caches"] = step(state["i"], tok, state["caches"])
        ntok, lp = select(logits[:, -1, :])
        ntok = torch.where(done, torch.full_like(ntok, pad), ntok)
        score.add_(torch.where(done, torch.zeros_like(lp), lp))
        out.scatter_(1, col, ntok[:, None])
        col.add_(1)
        done.logical_or_(ntok == eos)
        tok.copy_(ntok)

    run = GraphedStep(body, tok.device, graphed, generator)
    flag = _LateFlag(done) if eos >= 0 else None
    if flag is not None:
        flag.push()
    while state["i"] < max_new:
        if flag is not None and flag.late():
            break
        run()
        if flag is not None:
            flag.push()
        state["i"] += 1
    return out, score


class GenerationMixin:
    """Adds ``generate()`` to a causal LM module with the cache
    protocol of :class:`paddle_tpu_torch.models.llama.LlamaForCausalLM`:
    ``init_caches(batch, max_len)``, ``init_paged_caches(num_blocks,
    block_size)``, ``forward(ids, caches=..., offset=...)`` (dense) and
    ``forward(ids, caches=..., block_tables=..., cache_lens=...)``
    (paged), each returning ``(logits, caches)``. ``cuda_graphs`` (True)
    replays the paged decode and speculative steps from CUDA graphs on
    CUDA; set it False on an instance or the class to run them eagerly
    (kernels patched to plain versions that read values back cannot be
    captured)."""

    cuda_graphs = True

    def _check_lengths(self, prompt_len, max_new):
        max_pos = getattr(getattr(self, "config", None),
                          "max_position_embeddings", None)
        if max_pos is not None and prompt_len + max_new > max_pos:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new}) "
                f"exceeds max_position_embeddings ({max_pos})")

    def _takes_pad_mask(self):
        """Whether the model's forward takes ``attention_mask`` and
        ``position_ids`` (GPT's, as the reference's, takes neither)."""
        sig = inspect.signature(type(self).forward).parameters
        return "attention_mask" in sig and "position_ids" in sig

    def _bucket_eligible(self):
        """Prompt bucketing rides the left-padded (mask + per-row rope)
        path, so the model's forward must accept it; capacity-routed MoE
        is excluded because pad tokens would compete for expert capacity
        and perturb the real tokens' outputs."""
        return self._takes_pad_mask() and not capacity_routed(
            getattr(self, "config", None))

    @staticmethod
    def _resolve_strategy(strategy):
        if strategy not in ("greedy_search", "sampling", "beam_search",
                            "group_beam_search"):
            raise NotImplementedError(
                f"decode_strategy {strategy!r}; supported: greedy_search, "
                "sampling, beam_search, group_beam_search")
        return strategy == "sampling"

    def _run_dense(self, ids, mask, max_new, select, eos, pad):
        """Prefill into the dense cache at offset 0, then one token per
        step at ``prompt_len - 1 + i``. With ``mask`` (``[B, prompt]``,
        left-padded) the pad cache slots are masked and each row's rope
        positions start at its first real token."""
        b, prompt_len = ids.shape
        full_mask = pos0 = n_real = None
        if mask is not None:
            full_mask = torch.cat([mask, torch.ones(
                (b, max_new), dtype=mask.dtype, device=mask.device)], 1)
            n_real = mask.sum(1)
            pos0 = torch.clamp(torch.cumsum(mask, 1) - 1, min=0)
        caches = self.init_caches(b, prompt_len + max_new)
        # the pad mask and positions go only to a forward that takes them
        # (GPT's takes neither)
        def pad_kw(pos):
            return {} if mask is None else dict(attention_mask=full_mask,
                                                position_ids=pos)

        logits, caches = self(ids, caches=caches, offset=0, **pad_kw(pos0))

        def step(i, tok, caches):
            return self(tok[:, None], caches=caches,
                        offset=prompt_len - 1 + i,
                        **pad_kw(None if mask is None
                                 else (n_real + i - 1)[:, None]))

        return _decode_loop(step, select(logits[:, -1, :]), caches, max_new,
                            select, eos, pad)

    def _run_paged(self, ids, max_new, select, eos, pad, block_size,
                   kv_cache_dtype=None, generator=None):
        """The paged twin of :meth:`_run_dense`: the prompt's K/V go into
        a block pool (:func:`_paged_prefill`) and each decode step writes
        and attends through the pool (K2d); its cache lengths are a
        device counter the step advances, so on CUDA the step replays one
        CUDA graph a run (:func:`_decode_loop`; ``generator``: a sampling
        run's, registered with it)."""
        b, prompt_len = ids.shape
        logits, tables, pools = _paged_prefill(
            self, ids, _pc.blocks_for(prompt_len + max_new, block_size),
            block_size, kv_cache_dtype)
        lens = torch.full((b,), prompt_len - 1, dtype=torch.int32,
                          device=ids.device)

        def step(i, tok, pools):
            lens.add_(1)            # step i writes position prompt + i - 1
            return self(tok[:, None], caches=pools, block_tables=tables,
                        cache_lens=lens)

        graphed = self.cuda_graphs and graphs_usable(ids.device,
                                                     generator is not None)
        return _decode_loop(step, select(logits[:, -1, :]), pools, max_new,
                            select, eos, pad, graphed, generator)

    @torch.no_grad()
    def generate(self, input_ids, generation_config: GenerationConfig = None,
                 max_new_tokens=None, max_length=None,
                 decode_strategy=None, temperature=None, top_k=None,
                 top_p=None, num_beams=None, num_beam_groups=None,
                 diversity_rate=None, length_penalty=None,
                 early_stopping=None, eos_token_id=None,
                 pad_token_id=None, seed=None, attention_mask=None,
                 cache_impl=None, pad_prompt_to_bucket=None,
                 num_speculative_tokens=None, draft_model=None,
                 spec_ngram_max=None, spec_tree=None,
                 kv_cache_dtype=None, **kwargs):
        """Returns ``(ids, scores)`` on the model's device: generated
        token ids ``[B, max_new_tokens]`` int64 (pad-filled after EOS)
        and the summed log-probability of the chosen tokens per row
        (float32 ``[B]``). ``input_ids`` is ``[B, L]`` or ``[L]`` (a
        tensor, array or list)."""
        if kwargs:
            raise TypeError(
                f"generate() got unsupported options {sorted(kwargs)}; "
                "supported: max_new_tokens/max_length, decode_strategy "
                "(greedy_search|sampling|beam_search|group_beam_search), "
                "temperature, top_k, top_p, num_beams, num_beam_groups, "
                "diversity_rate, length_penalty, early_stopping, "
                "eos_token_id, pad_token_id, seed, cache_impl "
                "(dense|paged), pad_prompt_to_bucket, "
                "num_speculative_tokens, draft_model, spec_ngram_max, "
                "spec_tree, kv_cache_dtype")
        cfg = generation_config or GenerationConfig()
        if max_length is not None and max_new_tokens is None:
            max_new_tokens = max_length  # PaddleNLP: length of generation
        max_new = int(max_new_tokens or cfg.max_new_tokens)
        strategy = decode_strategy or cfg.decode_strategy
        do_sample = self._resolve_strategy(strategy)
        temperature = cfg.temperature if temperature is None \
            else float(temperature)
        top_k = cfg.top_k if top_k is None else int(top_k)
        top_p = cfg.top_p if top_p is None else float(top_p)
        num_beams = cfg.num_beams if num_beams is None else int(num_beams)
        num_beam_groups = cfg.num_beam_groups if num_beam_groups is None \
            else int(num_beam_groups)
        diversity_rate = cfg.diversity_rate if diversity_rate is None \
            else float(diversity_rate)
        length_penalty = cfg.length_penalty if length_penalty is None \
            else float(length_penalty)
        early_stopping = cfg.early_stopping if early_stopping is None \
            else bool(early_stopping)
        eos = eos_token_id if eos_token_id is not None else cfg.eos_token_id
        pad = pad_token_id if pad_token_id is not None else cfg.pad_token_id
        eos = -1 if eos is None else int(eos)   # -1 never matches
        pad = (eos if eos >= 0 else 0) if pad is None else int(pad)
        seed = cfg.seed if seed is None else seed
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        explicit_cache_impl = cache_impl
        cache_impl = cache_impl or cfg.cache_impl
        if cache_impl not in ("dense", "paged"):
            raise ValueError(
                f"cache_impl {cache_impl!r}; supported: dense, paged")
        kv_req = kv_cache_dtype if kv_cache_dtype is not None \
            else cfg.kv_cache_dtype
        # an int8 pool needs the paged cache: an explicit request rides it,
        # and an explicit dense cache with it is refused
        kv_dtype = _pc.resolve_kv_cache_dtype(kv_req)
        if kv_dtype is not None:
            if explicit_cache_impl == "dense":
                raise ValueError(
                    "kv_cache_dtype requires the paged cache; it cannot "
                    "run with an explicit cache_impl='dense'")
            cache_impl = "paged"
        if pad_prompt_to_bucket is None:
            pad_prompt_to_bucket = cfg.pad_prompt_to_bucket

        dev = self.device
        ids = torch.as_tensor(np.asarray(
            input_ids.cpu() if torch.is_tensor(input_ids) else input_ids),
            dtype=torch.int64)
        if ids.dim() == 1:
            ids = ids[None]
        ids = ids.to(dev)
        b, prompt_len = ids.shape
        self._check_lengths(prompt_len, max_new)

        is_beam = strategy in ("beam_search", "group_beam_search")
        mask_np = None
        if attention_mask is not None:
            if is_beam:
                raise NotImplementedError(
                    "beam search with left-padded prompts "
                    "(attention_mask) — pad to equal length instead")
            if not self._takes_pad_mask():
                raise NotImplementedError(
                    f"{type(self).__name__} does not support left-padded "
                    "generation (its forward lacks attention_mask/"
                    "position_ids kwargs)")
            mask_np = np.asarray(attention_mask.cpu()
                                 if torch.is_tensor(attention_mask)
                                 else attention_mask)
            if mask_np.ndim == 1:
                mask_np = mask_np[None]
            if tuple(mask_np.shape) != (b, prompt_len):
                raise ValueError(
                    f"attention_mask shape {tuple(mask_np.shape)} must "
                    f"match input_ids shape {(b, prompt_len)}")
            if (np.diff(mask_np, axis=1) < 0).any() or \
                    (mask_np[:, -1] != 1).any():
                raise ValueError(
                    "attention_mask must be LEFT-padded (each row: 0s "
                    "then 1s, last column 1)")
        if is_beam and (temperature != 1.0 or top_k or top_p != 1.0):
            raise ValueError(
                f"{strategy} is deterministic; temperature/top_k/top_p "
                "do not apply (use decode_strategy='sampling')")
        if strategy == "beam_search" and (num_beam_groups > 1
                                          or diversity_rate):
            raise ValueError(
                "num_beam_groups/diversity_rate require "
                "decode_strategy='group_beam_search'")
        if not is_beam and num_beams > 1:
            raise ValueError(
                f"num_beams={num_beams} requires decode_strategy="
                "'beam_search' or 'group_beam_search' "
                f"(got {strategy!r})")
        if cache_impl == "paged":
            if is_beam:
                raise NotImplementedError(
                    "cache_impl='paged' does not support beam search — "
                    "use the dense cache")
            if attention_mask is not None:
                raise NotImplementedError(
                    "cache_impl='paged' with left-padded prompts "
                    "(attention_mask) — use the dense cache, or the "
                    "serving engine, which prefills each prompt at its own "
                    "length")
            if not hasattr(self, "init_paged_caches"):
                raise NotImplementedError(
                    f"{type(self).__name__} does not implement "
                    "init_paged_caches (paged-KV decode)")

        gen = make_generator(seed, dev) if do_sample else None
        if do_sample:
            # the knobs as device scalars, made once: a step captured into
            # a CUDA graph cannot upload them
            temperature, top_k, top_p = (
                torch.tensor(float(v), dtype=torch.float32, device=dev)
                for v in (temperature, top_k, top_p))

        def select(logits):
            return _select_token(logits, gen, do_sample=do_sample,
                                 temperature=temperature, top_k=top_k,
                                 top_p=top_p)

        block_size = int(cfg.kv_block_size)
        gamma = int(cfg.num_speculative_tokens
                    if num_speculative_tokens is None
                    else num_speculative_tokens)
        if gamma < 0:
            raise ValueError(
                f"num_speculative_tokens must be >= 0, got {gamma}")
        if draft_model is not None and gamma == 0:
            raise ValueError(
                "draft_model requires num_speculative_tokens > 0")
        if spec_tree is not None:
            spec_tree = tuple(int(p) for p in spec_tree)
            if gamma == 0:
                raise ValueError(
                    "spec_tree requires num_speculative_tokens > 0")
            if len(spec_tree) != gamma:
                raise ValueError(
                    f"spec_tree has {len(spec_tree)} nodes; must equal "
                    f"num_speculative_tokens={gamma}")
        if gamma:
            from .speculative import (SpecGenerator, draft_exclusion_reason,
                                      spec_exclusion_reason)
            if is_beam:
                raise NotImplementedError(
                    "speculative decoding does not support beam search")
            if attention_mask is not None:
                raise NotImplementedError(
                    "speculative decoding with left-padded prompts "
                    "(attention_mask) — pad to equal length, or use "
                    "the serving engine")
            if explicit_cache_impl == "dense":
                raise ValueError(
                    "num_speculative_tokens requires the paged cache; "
                    "it cannot run with an explicit cache_impl='dense'")
            reason = spec_exclusion_reason(self)
            if reason is None and draft_model is not None:
                reason = draft_exclusion_reason(self, draft_model)
            if reason is not None:
                raise NotImplementedError(
                    f"speculative decoding unavailable: {reason}")
            # speculated positions may overhang the final token by up to
            # gamma: they need room in the position tables too (rope, or
            # GPT's learned positions)
            self._check_lengths(prompt_len, max_new + gamma)
            runner = SpecGenerator(
                self, b, prompt_len, max_new, gamma, do_sample=do_sample,
                temperature=temperature, top_k=top_k, top_p=top_p, eos=eos,
                pad=pad, block_size=block_size, draft_model=draft_model,
                ngram_max=int(cfg.spec_ngram_max if spec_ngram_max is None
                              else spec_ngram_max),
                kv_cache_dtype=kv_dtype, spec_tree=spec_tree)
            out, score = runner.run(ids, gen)
            return (torch.from_numpy(out).to(dev),
                    torch.from_numpy(score).to(dev))
        if cache_impl == "paged":
            return self._run_paged(ids, max_new, select, eos, pad,
                                   block_size, kv_dtype, gen)
        if is_beam:
            return self._run_beam(
                ids, max_new, num_beams=num_beams,
                num_beam_groups=num_beam_groups
                if strategy == "group_beam_search" else 1,
                diversity_rate=diversity_rate, length_penalty=length_penalty,
                early_stopping=early_stopping, eos=eos, pad=pad)
        # power-of-two prompt bucketing: left-pad the prompt (masked,
        # per-row rope rebase), as the reference does so that every
        # length in a bucket reuses one compiled loop
        if pad_prompt_to_bucket and self._bucket_eligible():
            pb = _prompt_bucket(prompt_len)
            if pb != prompt_len:
                padc = pb - prompt_len
                ids = torch.cat([torch.full((b, padc), pad, dtype=ids.dtype,
                                            device=dev), ids], 1)
                base = mask_np if mask_np is not None \
                    else np.ones((b, prompt_len), np.int64)
                mask_np = np.concatenate(
                    [np.zeros((b, padc), base.dtype), base], axis=1)
        mask = None if mask_np is None else \
            torch.from_numpy(mask_np.astype(np.int64)).to(dev)
        return self._run_dense(ids, mask, max_new, select, eos, pad)

    def _run_beam(self, ids, max_new, **kw):
        """Beam or group-beam search over the dense cache
        (:func:`~paddle_tpu_torch.generation.beam.beam_search`)."""
        from .beam import beam_search
        prompt_len = ids.shape[1]
        return beam_search(
            lambda tok, caches, off: self(tok, caches=caches, offset=off),
            lambda bb: self.init_caches(bb, prompt_len + max_new), ids,
            max_new, **kw)

    def export_generation(self, path, batch_size, prompt_len,
                          max_new_tokens, generation_config=None):
        """Write a deployable generation artifact for ``[batch_size,
        prompt_len]`` prompts and ``max_new_tokens`` new tokens, with
        ``generation_config``'s decoding (greedy, sampling, beam or
        group-beam) baked in: ``path.json`` (the reference's keys
        ``batch``, ``prompt_len``, ``max_new_tokens``, ``n_params``,
        ``seed_dtype``, plus the model's class, its config and the
        generation config) and ``path.params.npz`` (every weight by its
        ``state_dict`` name; bfloat16 stored as its uint16 bits). No
        compiled program is stored: the port's kernels are launched
        through ctypes, not traced, so :func:`load_generation` rebuilds
        the model and runs the same loop ``generate()`` runs. Returns
        ``path``."""
        cfg = generation_config or GenerationConfig()
        self._resolve_strategy(cfg.decode_strategy)
        b, prompt, max_new = int(batch_size), int(prompt_len), \
            int(max_new_tokens)
        self._check_lengths(prompt, max_new)
        state = {k: v.detach().cpu() for k, v in self.state_dict().items()}
        arrays, dtypes = {}, {}
        for k, v in state.items():
            dtypes[k] = str(v.dtype).replace("torch.", "")
            arrays[k] = (v.view(torch.uint16) if v.dtype == torch.bfloat16
                         else v).numpy()
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        np.savez(path + ".params.npz", **arrays)
        model_cfg = self.config
        with open(path + ".json", "w") as f:
            json.dump({"batch": b, "prompt_len": prompt,
                       "max_new_tokens": max_new, "n_params": len(arrays),
                       "seed_dtype": "int64",
                       "model_class": type(self).__name__,
                       "config_class": type(model_cfg).__name__,
                       "config": asdict(model_cfg),
                       "generation_config": asdict(cfg),
                       "dtypes": dtypes}, f)
        return path


class LoadedGeneration:
    """A generation artifact written by ``export_generation``:
    ``gen(input_ids [batch, prompt_len], seed=0)`` returns the generated
    ids ``[batch, max_new_tokens]`` as numpy. It holds no compiled
    program (the port's kernels are launched, not traced): it rebuilds
    the model on ``device`` (default cuda) from the stored config and
    weights, and runs the dense or beam loop ``generate()`` runs with the
    baked configuration, on prompts of the artifact's fixed shape (a
    different shape raises, as the reference's fixed-shape executable
    does)."""

    def __init__(self, path, device=None):
        from .. import models
        with open(path + ".json") as f:
            self.meta = json.load(f)
        data = np.load(path + ".params.npz", allow_pickle=False)
        cls = getattr(models, self.meta["model_class"])
        cfg = getattr(models, self.meta["config_class"])(
            **self.meta["config"])
        self.model = cls(cfg, device=device).eval()
        state = {}
        for k, dt in self.meta["dtypes"].items():
            t = torch.from_numpy(data[k])
            state[k] = t.view(torch.bfloat16) if dt == "bfloat16" else t
        self.model.load_state_dict(state)
        # the reference's artifact runs the dense loop on the prompt as
        # given: no bucket padding, no paged cache, no speculation
        self.generation_config = replace(
            GenerationConfig(**self.meta["generation_config"]),
            cache_impl="dense", kv_cache_dtype=None,
            pad_prompt_to_bucket=False, num_speculative_tokens=0)

    def __call__(self, input_ids, seed=0):
        ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                         else input_ids).astype(np.int64)
        want = (self.meta["batch"], self.meta["prompt_len"])
        if ids.shape != want:
            raise ValueError(
                f"input_ids shape {ids.shape}; this artifact was exported "
                f"for {want}")
        cfg = self.generation_config
        out, _ = self.model.generate(
            ids, generation_config=cfg,
            max_new_tokens=self.meta["max_new_tokens"], seed=int(seed))
        return out.cpu().numpy()


def load_generation(path, device=None) -> LoadedGeneration:
    """Load an artifact written by ``export_generation`` (see
    :class:`LoadedGeneration`); ``device`` defaults to cuda."""
    return LoadedGeneration(path, device)
