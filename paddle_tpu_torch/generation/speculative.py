"""Speculative decoding over the paged KV cache, linear chain
(counterpart of ``paddle_tpu/generation/speculative.py``).

A drafter proposes ``gamma`` tokens and the target model verifies the
window ``[cur, d_1..d_gamma]`` in ONE multi-token paged forward (K2v),
emitting 1 to ``gamma + 1`` tokens per step. Two drafters:

- **n-gram / prompt lookup** (:func:`ngram_propose`): the continuation
  of the most recent earlier occurrence of the current suffix n-gram;
- **draft model** (:func:`build_draft_loop`): a smaller paged-KV causal
  LM runs ``gamma + 1`` single-token steps (K2d) over its own pools,
  which share the target's block tables.

Acceptance (:func:`accept_from_filtered`): greedy accepts while the
draft equals the target argmax, so the emitted tokens are the target's
own greedy chain; sampling is standard speculative rejection sampling
against the draft distribution (one-hot for the n-gram drafter), with
both run through the same ``_filter_logits`` pipeline. Rejected tokens
are rolled back by not advancing the slot's length: the next window
overwrites them (``paged_cache.write_tokens``).

Tree speculation (``spec_tree``, ``ngram_propose_topk`` and the tree
verify mask) comes with a later slice.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import _filter_logits, _paged_prefill, _select_token
from ..distributed.moe import capacity_routed
from ..ops import paged_cache as _pc

__all__ = ["spec_exclusion_reason", "draft_exclusion_reason",
           "ngram_propose", "build_draft_loop", "accept_from_filtered",
           "build_verify_step", "leading_accepts", "commit_window",
           "SpecGenerator"]


def spec_exclusion_reason(model) -> Optional[str]:
    """Why speculative decoding cannot run for ``model`` (None = it can).
    Capacity-routed MoE is excluded: the gamma + 1 window tokens would
    compete with each other for expert capacity, so the verify logits
    would differ from sequential decode and acceptance would be
    unsound."""
    if not hasattr(model, "init_paged_caches"):
        return (f"{type(model).__name__} does not implement "
                "init_paged_caches (paged-KV decode)")
    if capacity_routed(getattr(model, "config", None)):
        return ("capacity-routed MoE: window tokens would compete for "
                "expert capacity, changing logits vs sequential decode")
    return None


def draft_exclusion_reason(target, draft) -> Optional[str]:
    """Why ``draft`` cannot draft for ``target`` (None = it can)."""
    reason = spec_exclusion_reason(draft)
    if reason is not None:
        return reason
    dv = getattr(getattr(draft, "config", None), "vocab_size", None)
    tv = getattr(getattr(target, "config", None), "vocab_size", None)
    if dv is not None and tv is not None and dv != tv:
        return f"draft vocab ({dv}) != target vocab ({tv})"
    return None


def ngram_propose(history, gamma: int, max_ngram: int = 3) -> List[int]:
    """Prompt-lookup drafter: find the most recent earlier occurrence of
    the longest suffix n-gram (n <= ``max_ngram``) of ``history`` and
    propose the ``gamma`` tokens that followed it; pad a short
    continuation by repeating its last token, and repeat the last
    history token when nothing matches."""
    n = len(history)
    g = int(gamma)
    for k in range(min(int(max_ngram), n - 1), 0, -1):
        suf = history[n - k:]
        for start in range(n - k - 1, -1, -1):
            if history[start:start + k] == suf:
                out = list(history[start + k: start + k + g])
                while len(out) < g:
                    out.append(out[-1])
                return out
    return [history[-1]] * g


def build_draft_loop(draft_step, *, gamma, do_sample, temperature=1.0,
                     top_k=0, top_p=1.0, want_probs):
    """The draft model's proposal loop: ``gamma + 1`` single-token
    decode steps; the last only writes the last draft token's K/V, so a
    fully accepted window leaves the draft cache without a gap.

    ``draft_step(ids [S, 1], pools, tables, lens) -> (logits, pools)``.
    Returns ``loop(pools, tables, lens, cur, generator) -> (proposals
    [S, gamma], q_probs [S, gamma, V] or None, pools)``; ``q_probs`` are
    the draft distributions after the shared temperature / top-k / top-p
    pipeline (``want_probs``: rejection sampling needs them)."""

    def loop(pools, tables, lens, cur, generator=None):
        tok, l = cur, lens
        props, qs = [], []
        for i in range(gamma + 1):
            logits, pools = draft_step(tok[:, None], pools, tables, l)
            if i == gamma:
                break
            f = _filter_logits(logits[:, -1, :], do_sample=do_sample,
                               temperature=temperature, top_k=top_k,
                               top_p=top_p)
            if do_sample:
                tok = torch.multinomial(torch.softmax(f, -1), 1,
                                        generator=generator)[:, 0]
            else:
                tok = torch.argmax(f, dim=-1)
            props.append(tok)
            if want_probs:
                qs.append(torch.softmax(f, dim=-1))
            l = l + 1
        return (torch.stack(props, 1),
                torch.stack(qs, 1) if want_probs else None, pools)

    return loop


def _categorical(probs, generator):
    """One draw per row of ``probs [..., V]``."""
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator)[:, 0].reshape(
        probs.shape[:-1])


def accept_from_filtered(f, toks, dq, generator, *, gamma, do_sample):
    """Window acceptance on already-filtered target logits ``f [S,
    gamma + 1, V]`` for the window ``toks [S, gamma + 1] = [cur, d_1 ..
    d_gamma]``. Returns ``(out [S, gamma + 1], accept [S, gamma],
    picked_logp [S, gamma + 1])``: ``accept[s, i]`` says ``d_{i+1}`` was
    accepted and ``out[s, t]`` is the token the sequence continues with
    after ``t`` accepted drafts. ``dq`` is the draft's filtered
    distribution ``[S, gamma, V]`` (None: the one-hot n-gram drafter);
    ``generator`` is drawn from only when ``do_sample``."""
    logp = torch.log_softmax(f, dim=-1)
    if not do_sample:
        out = torch.argmax(f, dim=-1)
        accept = out[:, :-1] == toks[:, 1:]
        return out, accept, torch.gather(logp, -1, out[..., None])[..., 0]
    p = torch.softmax(f, dim=-1)                    # [S, G+1, V]
    s = p.shape[0]
    d = toks[:, 1:].long()                          # [S, G]
    pg = p[:, :gamma]
    pd = torch.gather(pg, -1, d[..., None])[..., 0]
    if dq is None:
        # one-hot draft: q(d_i) = 1, the residual is p with d_i removed
        qd = torch.ones_like(pd)
        res = pg.scatter(-1, d[..., None], 0.0)
    else:
        qd = torch.gather(dq, -1, d[..., None])[..., 0]
        res = torch.clamp(pg - dq, min=0.0)
    u = torch.rand((s, gamma), generator=generator, device=f.device)
    accept = u * qd < pd            # u < p / q without dividing by 0
    rs = res.sum(-1, keepdim=True)
    # degenerate residual (q == p exactly): resample from p
    res = torch.where(rs > 0.0, res / torch.clamp(rs, min=1e-37), pg)
    rtok = _categorical(res, generator)
    bonus = _categorical(p[:, gamma], generator)
    out = torch.cat([torch.where(accept, d, rtok), bonus[:, None]], 1)
    return out, accept, torch.gather(logp, -1, out[..., None])[..., 0]


def build_verify_step(model_step, *, gamma, do_sample, temperature=1.0,
                      top_k=0, top_p=1.0):
    """The fixed-gamma verify step: ``verify(pools, tables, lens, toks,
    dq=None, generator=None) -> (out, accept, logp, pools)`` runs ONE
    target forward over the window ``toks [S, gamma + 1]`` (K/V written
    at ``lens + t``, attended through K2v), filters the logits and
    accepts with :func:`accept_from_filtered`. ``model_step(ids, pools,
    tables, lens) -> (logits, pools)``."""

    def verify(pools, tables, lens, toks, dq=None, generator=None):
        logits, pools = model_step(toks, pools, tables, lens)
        f = _filter_logits(logits, do_sample=do_sample,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p)
        out, accept, picked = accept_from_filtered(
            f, toks, dq, generator, gamma=gamma, do_sample=do_sample)
        return out, accept, picked, pools

    return verify


def leading_accepts(accept_row) -> int:
    """Number of leading True in one slot's accept vector (the accepted
    draft count; the step then emits that many + 1 tokens)."""
    n = 0
    for a in accept_row:
        if not a:
            break
        n += 1
    return n


def commit_window(out_row, accept_row, room: int, eos: int):
    """From one slot's verify outputs, the tokens to emit this step and
    the accepted-draft count: ``out_row[:n_acc + 1]`` truncated to
    ``room`` tokens and cut after an EOS anywhere in the window.
    Returns ``(kept, n_acc)``; ``kept`` is non-empty for ``room >= 1``."""
    n_acc = leading_accepts(accept_row)
    kept = []
    for tok in out_row[:n_acc + 1][:room]:
        kept.append(int(tok))
        if int(tok) == eos:
            break
    return kept, n_acc


def _paged_step(model):
    def step(ids, pools, tables, lens):
        return model(ids, caches=pools, block_tables=tables,
                     cache_lens=lens)
    return step


class SpecGenerator:
    """Host acceptance loop behind ``generate(num_speculative_tokens=
    gamma)``: the paged layout of the plain paged loop (generate() owns
    the whole pool, contiguous block tables, prefill through the dense
    cached path scattered into the blocks), then per iteration: draft
    gamma tokens (n-gram on the host, or the draft model's loop), verify
    the window in one target forward, and commit 1..gamma+1 tokens per
    row by advancing its length; the rejected tail is rolled back by not
    advancing over it. The block tables carry ``gamma`` positions of
    headroom: the last window may overhang the final token by that
    much."""

    def __init__(self, model, b, prompt_len, max_new, gamma, *, do_sample,
                 temperature, top_k, top_p, eos, pad, block_size,
                 draft_model=None, ngram_max=3, kv_cache_dtype=None):
        self.model, self.draft_model = model, draft_model
        self.b, self.max_new, self.gamma = b, int(max_new), int(gamma)
        self.prompt_len = int(prompt_len)
        self.eos, self.pad = int(eos), int(pad)
        self.ngram_max = int(ngram_max)
        self.block_size = int(block_size)
        self.kv_cache_dtype = kv_cache_dtype    # both models' pools
        self.mb = _pc.blocks_for(prompt_len + max_new + gamma, block_size)
        knobs = dict(do_sample=do_sample, temperature=temperature,
                     top_k=top_k, top_p=top_p)
        self._select = lambda lg, gen: _select_token(lg, gen, **knobs)
        self._verify = build_verify_step(_paged_step(model), gamma=gamma,
                                         **knobs)
        self._dloop = None if draft_model is None else build_draft_loop(
            _paged_step(draft_model), gamma=gamma, want_probs=do_sample,
            **knobs)
        self.verify_steps = 0           # verify windows of the last run

    @torch.no_grad()
    def run(self, ids, generator=None):
        """``ids [B, prompt]`` on the model's device -> ``(out [B,
        max_new] int64, pad-filled after EOS, scores [B] float32)`` as
        numpy arrays."""
        b, g, eos = self.b, self.gamma, self.eos
        dev = ids.device
        logits, tables, pools = _paged_prefill(self.model, ids, self.mb,
                                               self.block_size,
                                               self.kv_cache_dtype)
        tok0, logp0 = self._select(logits[:, -1, :], generator)
        del logits
        dpools = None
        if self.draft_model is not None:
            _, _, dpools = _paged_prefill(self.draft_model, ids, self.mb,
                                          self.block_size,
                                          self.kv_cache_dtype)
        tok0 = tok0.cpu().numpy()
        emitted = [[int(t)] for t in tok0]
        scores = [float(v) for v in logp0.cpu().numpy()]
        hist = [list(map(int, row)) + [int(t)]
                for row, t in zip(ids.cpu().numpy(), tok0)]
        lens = np.full((b,), self.prompt_len, np.int32)
        cur = tok0.astype(np.int64)
        done = [int(t) == eos or self.max_new <= 1 for t in tok0]
        self.verify_steps = 0

        while not all(done):
            toks = np.empty((b, g + 1), np.int64)
            toks[:, 0] = cur
            lens_t = torch.from_numpy(lens).to(dev)
            dq = None
            if self._dloop is None:
                for r in range(b):
                    toks[r, 1:] = ngram_propose(hist[r], g, self.ngram_max) \
                        if not done[r] else self.pad
            else:
                props, dq, dpools = self._dloop(
                    dpools, tables, lens_t, torch.from_numpy(cur).to(dev),
                    generator)
                toks[:, 1:] = props.cpu().numpy()
            out, accept, logp, pools = self._verify(
                pools, tables, lens_t, torch.from_numpy(toks).to(dev), dq,
                generator)
            self.verify_steps += 1
            out = out.cpu().numpy()
            accept = accept.cpu().numpy()
            logp = logp.cpu().numpy()
            for r in range(b):
                if done[r]:
                    continue
                kept, n_acc = commit_window(
                    out[r], accept[r], self.max_new - len(emitted[r]), eos)
                emitted[r].extend(kept)
                hist[r].extend(kept)
                scores[r] += float(logp[r, :len(kept)].sum())
                if kept[-1] == eos or len(emitted[r]) >= self.max_new:
                    done[r] = True      # rows stay batched but frozen
                else:
                    lens[r] += n_acc + 1
                    cur[r] = kept[-1]

        out_np = np.full((b, self.max_new), self.pad, np.int64)
        for r in range(b):
            out_np[r, :len(emitted[r])] = emitted[r]
        return out_np, np.asarray(scores, np.float32)
