"""Speculative decoding over the paged KV cache, a linear chain or a
token tree (counterpart of ``paddle_tpu/generation/speculative.py``).

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

Tree speculation (``spec_tree``, a parent tuple): the n-gram drafter
proposes several head-distinct continuations (:func:`ngram_propose_topk`)
that fill the tree's chains (:func:`tree_chain_layout`,
:func:`tree_fill_from_chains`); one target forward verifies the whole
tree, K2v masking each row by its ancestor path (``spec_tree_scope``);
:func:`accept_tree_from_filtered` accepts the longest root path (greedy,
or sequential sibling rejection when sampling), and ``permute_window``
moves the accepted nodes' K/V onto the linear tail. A node is roped at
its window position, not its depth, as in the reference, so the cache
is a sequential decode's along a chain only. A chain tree
``tuple(range(gamma))`` is the linear path, token for token.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import _filter_logits, _paged_prefill, _select_token, categorical
from ..distributed.moe import capacity_routed
from ..ops import paged_cache as _pc
from ..ops.cuda_graphs import GraphedStep, Upload, graphs_usable
from ..ops.kernels.paged_attention import spec_tree_scope, tree_ancestor_bits

__all__ = ["spec_exclusion_reason", "draft_exclusion_reason",
           "ngram_propose", "ngram_propose_topk", "tree_ancestor_bits",
           "tree_chain_layout", "tree_fill_from_chains", "build_draft_loop",
           "accept_from_filtered", "accept_tree_from_filtered",
           "build_verify_step", "build_tree_verify_step", "leading_accepts",
           "commit_window", "SpecGenerator"]


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
    return ngram_propose_topk(history, gamma, 1, max_ngram)[0]


def ngram_propose_topk(history, gamma: int, n_chains: int,
                       max_ngram: int = 3) -> List[List[int]]:
    """The top-``n_chains`` continuations of the current suffix, found in
    :func:`ngram_propose`'s order (longest suffix first, most recent
    occurrence first), so ``chains[0]`` is its proposal. Chains are
    deduplicated by their first token (two sharing a head would fill the
    same depth-1 node); missing chains are the repeat-last-token
    fallback."""
    n = len(history)
    g = int(gamma)
    chains: List[List[int]] = []
    seen = set()
    for k in range(min(int(max_ngram), n - 1), 0, -1):
        suf = history[n - k:]
        for start in range(n - k - 1, -1, -1):
            if history[start:start + k] == suf:
                out = list(history[start + k: start + k + g])
                while len(out) < g:
                    out.append(out[-1])
                if out[0] in seen:
                    continue
                seen.add(out[0])
                chains.append(out)
                if len(chains) == int(n_chains):
                    return chains
    fb = [history[-1]] * g
    if not chains:
        chains.append(fb)
    while len(chains) < int(n_chains):
        chains.append(list(fb))
    return chains


def tree_chain_layout(parents):
    """The static layout of a token tree (``parents[k]`` is node ``k +
    1``'s parent, node 0 the root): ``(depth, leaf_of, n_leaves,
    max_depth)``. ``depth[i]`` is node ``i``'s depth; ``leaf_of[i]`` the
    chain (order among leaves, in depth-first first-child order, so the
    root's spine is chain 0) of node ``i``'s first-child-descendant
    leaf, whose tokens fill node ``i``; ``n_leaves`` the chains a drafter
    proposes and ``max_depth`` their length. A chain tree has one leaf:
    the drafter is :func:`ngram_propose`."""
    tree_ancestor_bits(parents)          # validates
    parents = tuple(int(p) for p in parents)
    t = len(parents) + 1
    depth = [0] * t
    children: List[List[int]] = [[] for _ in range(t)]
    for k, p in enumerate(parents):
        depth[k + 1] = depth[p] + 1
        children[p].append(k + 1)
    chain_of = {}
    stack = [0]
    while stack:
        i = stack.pop()
        if not children[i] and i > 0:
            chain_of[i] = len(chain_of)
        stack.extend(reversed(children[i]))

    def first_leaf(i):
        while children[i]:
            i = children[i][0]
        return i

    leaf_of = tuple(chain_of[first_leaf(i)] for i in range(t))
    return tuple(depth), leaf_of, len(chain_of), max(depth)


def tree_fill_from_chains(parents, chains) -> List[int]:
    """The ``gamma`` draft tokens in node order: node ``k + 1`` (depth
    ``d``, chain ``c`` of :func:`tree_chain_layout`) takes
    ``chains[c][d - 1]``."""
    depth, leaf_of, n_leaves, _ = tree_chain_layout(parents)
    if len(chains) < n_leaves:
        raise ValueError(
            f"tree has {n_leaves} chains but only {len(chains)} "
            "candidate lists were drafted")
    return [int(chains[leaf_of[k + 1]][depth[k + 1] - 1])
            for k in range(len(parents))]


def build_draft_loop(draft_step, *, gamma, do_sample, temperature=1.0,
                     top_k=0, top_p=1.0, want_probs, slot_params=False):
    """The draft model's proposal loop: ``gamma + 1`` single-token
    decode steps; the last only writes the last draft token's K/V, so a
    fully accepted window leaves the draft cache without a gap.

    ``draft_step(ids [S, 1], pools, tables, lens) -> (logits, pools)``.
    Returns ``loop(pools, tables, lens, cur, generator) -> (proposals
    [S, gamma], q_probs [S, gamma, V] or None, pools)``; ``q_probs`` are
    the draft distributions after the shared temperature / top-k / top-p
    pipeline (``want_probs``: rejection sampling needs them).
    ``slot_params`` (the serving engine's per-slot knobs): the loop takes
    ``loop(pools, tables, lens, cur, samp, generator)`` with ``samp [S,
    3]`` = (temperature, top_k, top_p) a slot, and the keyword knobs are
    ignored; the engine's verify filters the target's logits with the same
    values, so rejection sampling stays sound."""

    def loop(pools, tables, lens, cur, *rest):
        if slot_params:
            samp, generator = (rest + (None,))[:2]
            t_, k_, p_ = samp[:, 0], samp[:, 1], samp[:, 2]
        else:
            generator = rest[0] if rest else None
            t_, k_, p_ = temperature, top_k, top_p
        tok, l = cur, lens
        props, qs = [], []
        for i in range(gamma + 1):
            logits, pools = draft_step(tok[:, None], pools, tables, l)
            if i == gamma:
                break
            f = _filter_logits(logits[:, -1, :], do_sample=do_sample,
                               temperature=t_, top_k=k_, top_p=p_)
            if do_sample:
                tok = categorical(torch.softmax(f, -1), generator)
            else:
                tok = torch.argmax(f, dim=-1)
            props.append(tok)
            if want_probs:
                qs.append(torch.softmax(f, dim=-1))
            l = l + 1
        return (torch.stack(props, 1),
                torch.stack(qs, 1) if want_probs else None, pools)

    return loop


_PARENTS = {}      # (parent tuple, device) -> its tensor


def _parent_tensor(parents, device):
    """``(-1,) + parents`` as an int64 tensor on ``device``, made once: a
    fresh upload would be a copy that a CUDA graph capture refuses."""
    key = (parents, str(device))
    t = _PARENTS.get(key)
    if t is None:
        t = _PARENTS[key] = torch.tensor((-1,) + parents, device=device)
    return t


def _categorical(probs, generator):
    """One draw per row of ``probs [..., V]``."""
    flat = probs.reshape(-1, probs.shape[-1])
    return categorical(flat, generator).reshape(probs.shape[:-1])


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


def accept_tree_from_filtered(f, toks, parents, generator, *, do_sample):
    """Token-tree acceptance on already-filtered target logits ``f [S,
    T, V]`` (every window node's; node 0 the committed root) for the
    window ``toks [S, T]`` of tree ``parents``: the longest accepted
    root path, walked one depth at a time. Greedy: advance to the child
    whose token is the current node's argmax (ties to the lowest node
    id). Sampled: sequential sibling rejection, visiting the current
    node's children in node order and accepting child ``i`` iff ``u_i *
    (1 - rejected siblings' p) < p(x_i)`` (one uniform a node, each node
    visited at most once; a duplicate of a rejected sibling's token has
    no mass left); when every child is rejected the bonus is drawn from
    ``p`` with the rejected siblings' tokens zeroed, and a path that
    reaches a leaf draws it from the leaf's ``p``. Draws come from
    ``generator``.

    Returns ``(out [S, T], accept [S, T - 1], picked_logp [S, T], path
    [S, T], n_acc [S])``: ``out`` / ``accept`` keep the linear contract
    (``accept`` has ``n_acc`` leading Trues; the host emits ``out[s,
    :n_acc + 1]``), ``path[s, j]`` is the accepted node at depth ``j``
    (``path[s, 0] = 0``), the permutation ``permute_window`` compacts
    the K/V window with."""
    s, t, v = f.shape
    parents = tuple(int(p) for p in parents)
    if len(parents) != t - 1:
        raise ValueError(
            f"spec tree has {len(parents) + 1} nodes but the verify "
            f"window carries {t} rows")
    dev = f.device
    par = _parent_tensor(parents, dev)
    toks = toks.long()
    rows = torch.arange(s, device=dev)
    iota_t = torch.arange(t, device=dev)
    logp = torch.log_softmax(f, dim=-1)
    cur = torch.zeros(s, dtype=torch.int64, device=dev)
    alive = torch.ones(s, dtype=torch.bool, device=dev)
    n_acc = torch.zeros(s, dtype=torch.int64, device=dev)
    path = torch.zeros((s, t), dtype=torch.int64, device=dev)
    if not do_sample:
        gt = torch.argmax(f, dim=-1)                        # [S, T]
        for d in range(1, t):
            m = (par[None, :] == cur[:, None]) \
                & (toks == gt[rows, cur][:, None]) & alive[:, None]
            step = m.any(dim=1)
            cur = torch.where(step, torch.argmax(m.int(), dim=1), cur)
            path[:, d] = cur
            n_acc += step
            alive = step
        bonus = gt[rows, cur]
    else:
        p = torch.softmax(f, dim=-1)                        # [S, T, V]
        u = torch.rand((s, t), generator=generator, device=dev)
        bonus = torch.zeros(s, dtype=torch.int64, device=dev)
        for d in range(1, t):
            p_cur = p[rows, cur]                            # [S, V]
            acc_d = torch.zeros(s, dtype=torch.bool, device=dev)
            chosen = cur
            rej_mass = torch.zeros(s, device=dev)
            rej_nodes = torch.zeros((s, t), dtype=torch.bool, device=dev)
            for i in range(1, t):
                cand = alive & (par[i] == cur) & ~acc_d
                ti = toks[:, i]
                dup = ((toks == ti[:, None]) & rej_nodes).any(dim=1)
                pi = torch.where(dup, 0.0, p_cur[rows, ti])
                acc_i = cand & (u[:, i] * (1.0 - rej_mass) < pi)
                chosen = torch.where(acc_i, i, chosen)
                acc_d = acc_d | acc_i
                newly = cand & ~acc_i
                rej_mass = rej_mass + torch.where(newly, pi, 0.0)
                rej_nodes[:, i] = newly
            # the residual: p with the rejected siblings' tokens zeroed,
            # renormalized (all mass rejected: p itself)
            hit = torch.zeros((s, v), device=dev).scatter_add_(
                1, toks, rej_nodes.float()) > 0
            res = torch.where(hit, 0.0, p_cur)
            rs = res.sum(-1, keepdim=True)
            res = torch.where(rs > 0.0, res / torch.clamp(rs, min=1e-37),
                              p_cur)
            bonus = torch.where(alive & ~acc_d,
                                _categorical(res, generator), bonus)
            cur = torch.where(acc_d, chosen, cur)
            path[:, d] = cur
            n_acc += acc_d
            alive = alive & acc_d
        # a path that never stopped: the bonus from its last node's p
        bonus = torch.where(alive, _categorical(p[rows, cur], generator),
                            bonus)
    # the linear contract: out[s, j] continues the sequence after j
    # accepted drafts (the path's next token, then the bonus)
    nxt = torch.cat([torch.gather(toks, 1, path)[:, 1:], bonus[:, None]], 1)
    out = torch.where(iota_t[None, :] < n_acc[:, None], nxt, bonus[:, None])
    accept = iota_t[None, :t - 1] < n_acc[:, None]
    # out[s, j] was chosen from node path[s, j]'s distribution
    picked = logp[rows[:, None], path, out]
    return out, accept, picked, path, n_acc


def build_verify_step(model_step, *, gamma, do_sample, temperature=1.0,
                      top_k=0, top_p=1.0, slot_params=False):
    """The fixed-gamma verify step: ``verify(pools, tables, lens, toks,
    dq=None, generator=None) -> (out, accept, logp, pools)`` runs ONE
    target forward over the window ``toks [S, gamma + 1]`` (K/V written
    at ``lens + t``, attended through K2v), filters the logits and
    accepts with :func:`accept_from_filtered`. ``model_step(ids, pools,
    tables, lens) -> (logits, pools)``. ``slot_params`` (the serving
    engine's per-slot knobs): ``verify(pools, tables, lens, toks, samp,
    dq=None, generator=None)`` with ``samp [S, 3]`` = (temperature,
    top_k, top_p) a slot; the keyword knobs are then ignored."""

    def verify(pools, tables, lens, toks, *rest):
        if slot_params:
            samp, rest = rest[0], rest[1:]
            t_, k_, p_ = samp[:, 0], samp[:, 1], samp[:, 2]
        else:
            t_, k_, p_ = temperature, top_k, top_p
        dq, generator = (tuple(rest) + (None, None))[:2]
        logits, pools = model_step(toks, pools, tables, lens)
        f = _filter_logits(logits, do_sample=do_sample, temperature=t_,
                           top_k=k_, top_p=p_)
        out, accept, picked = accept_from_filtered(
            f, toks, dq, generator, gamma=gamma, do_sample=do_sample)
        return out, accept, picked, pools

    return verify


def build_tree_verify_step(model_step, *, parents, do_sample,
                           temperature=1.0, top_k=0, top_p=1.0):
    """The tree twin of :func:`build_verify_step`: ``verify(pools,
    tables, lens, toks, dq=None, generator=None) -> (out, accept, logp,
    pools)`` runs ONE target forward over the window ``toks [S, gamma +
    1]`` (nodes in order) inside ``spec_tree_scope(parents)``, so K2v
    masks each row by its ancestor path; filters the logits, accepts
    with :func:`accept_tree_from_filtered`, and moves the accepted
    nodes' K/V onto the linear tail of every layer's pools
    (``permute_window``), where committing ``lens += n_acc + 1`` exposes
    them in order. Tree drafts are one-hot: ``dq`` must be
    None."""
    parents = tuple(int(p) for p in parents)
    tree_ancestor_bits(parents)          # validates

    def verify(pools, tables, lens, toks, dq=None, generator=None):
        if dq is not None:
            raise ValueError("tree drafts are one-hot: no dq")
        with spec_tree_scope(parents):
            logits, pools = model_step(toks, pools, tables, lens)
        f = _filter_logits(logits, do_sample=do_sample,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p)
        out, accept, picked, path, n_acc = accept_tree_from_filtered(
            f, toks, parents, generator, do_sample=do_sample)
        # permute_window on every layer, its addresses worked out once
        moves = _pc.window_moves(pools[0][0].shape[1], tables, lens, path,
                                 n_acc + 1)
        for kp, vp in pools:
            _pc.move_rows(kp, vp, moves)
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
    gamma tokens (n-gram on the host, the draft model's loop, or with
    ``spec_tree`` the n-gram chains filling the tree), verify the window
    in one target forward, and commit 1..gamma+1 tokens per row by
    advancing its length; the rejected tail is rolled back by not
    advancing over it. The block tables carry ``gamma`` positions of
    headroom: the last window may overhang the final token by that
    much.

    The device step (the draft model's loop and the verify, shapes fixed
    for a run) reads the window's tokens (or, drafting by model, the
    last tokens) and the lengths from tensors written through pinned
    staging before each call, so on CUDA it runs eagerly once, is
    captured into a CUDA graph at its second call and replayed after
    (the model's ``cuda_graphs`` off: eagerly), so a sampling run's knobs
    are device scalars there (``generate()`` makes them); host drafting
    and the commit stay on the host."""

    def __init__(self, model, b, prompt_len, max_new, gamma, *, do_sample,
                 temperature, top_k, top_p, eos, pad, block_size,
                 draft_model=None, ngram_max=3, kv_cache_dtype=None,
                 spec_tree=None):
        if spec_tree is not None:
            spec_tree = tuple(int(p) for p in spec_tree)
            if len(spec_tree) != int(gamma):
                raise ValueError(
                    f"spec_tree has {len(spec_tree)} draft nodes but "
                    f"num_speculative_tokens={int(gamma)}")
            if draft_model is not None:
                raise ValueError(
                    "spec_tree drafts via n-gram top-k chains; a separate "
                    "draft_model only produces linear chains — drop one "
                    "of the two")
            (_, _, self._tree_chains,
             self._tree_max_depth) = tree_chain_layout(spec_tree)
        self.spec_tree = spec_tree
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
        self._verify = build_verify_step(
            _paged_step(model), gamma=gamma, **knobs) \
            if spec_tree is None else build_tree_verify_step(
                _paged_step(model), parents=spec_tree, **knobs)
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

        # the step's inputs, written before each call: the lengths, and
        # the window (host drafters) or the last tokens (draft model)
        lens_in = Upload((b,), torch.int32, dev)
        win_in = Upload((b,) if self._dloop is not None else (b, g + 1),
                        torch.int64, dev)
        state = {"pools": pools, "dpools": dpools}

        def body():
            dq = None
            toks = win_in.dev
            if self._dloop is not None:
                props, dq, state["dpools"] = self._dloop(
                    state["dpools"], tables, lens_in.dev, toks, generator)
                toks = torch.cat([toks[:, None], props], 1)
            out, accept, logp, state["pools"] = self._verify(
                state["pools"], tables, lens_in.dev, toks, dq, generator)
            return out, accept, logp

        step = GraphedStep(
            body, dev, getattr(self.model, "cuda_graphs", True)
            and graphs_usable(dev, generator is not None), generator)
        while not all(done):
            toks = np.empty((b, g + 1), np.int64)
            toks[:, 0] = cur
            if self.spec_tree is not None:
                for r in range(b):
                    toks[r, 1:] = self.pad if done[r] else \
                        tree_fill_from_chains(self.spec_tree,
                                              ngram_propose_topk(
                                                  hist[r],
                                                  self._tree_max_depth,
                                                  self._tree_chains,
                                                  self.ngram_max))
            elif self._dloop is None:
                for r in range(b):
                    toks[r, 1:] = ngram_propose(hist[r], g, self.ngram_max) \
                        if not done[r] else self.pad
            lens_in.write(lens)
            win_in.write(cur if self._dloop is not None else toks)
            out, accept, logp = step()
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
