"""Beam search and group (diverse) beam search on the dense KV cache
(counterpart of ``paddle_tpu/generation/beam.py``).

The reference's static-shape algorithm, run as an eager loop on tensors:
the beams ride a flattened ``[B * G * K]`` batch through the same cached
decode step greedy ``generate()`` uses; each step takes the top 2K
candidates of each group (2K guarantees K continuations that do not end
in EOS), moves the EOS-ending candidates into a K-slot finished set under
the length penalty (``score / len ** alpha``), keeps the top K others
live, and gathers every layer's dense cache by the chosen source beams
(``index_select`` along the batch). Group beam search runs the groups in
turn within a step, each later group's log-probabilities lowered by
``diversity_rate`` times the count of each token the earlier groups chose
at this step (Hamming diversity).

The loop ends after ``max_new`` tokens, or earlier by one of two rules:
with ``early_stopping`` once every group holds K finished hypotheses,
else once no live beam can still beat the worst finished one (the best
live score over the penalty at full length, an optimistic bound that
needs a non-decreasing penalty). The exit test reads one bool back a
step. The final pick runs over every group; live beams count only after
a full-length run.

Selection breaks ties as ``jax.lax.top_k`` does, the lower index first:
every dead beam and every EOS candidate masked out of the live set holds
exactly ``NEG`` (``NEG + logp`` rounds back to ``NEG`` in float32), so
the pick among them decides which rows move forward. ``_top`` sorts
stably and slices; ``torch.topk`` promises no order among equals.
"""
from __future__ import annotations

import torch

__all__ = ["NEG", "beam_search"]

NEG = -1.0e9


def _top(x, k):
    """``(values, indices)`` of the ``k`` largest entries along the last
    axis, equal values in index order (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x, idx):
    """``x [B, N, ...]`` rows ``idx [B, M]`` along axis 1."""
    shape = idx.shape + x.shape[2:]
    ix = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, ix)


def beam_search(model_step, init_caches, ids, max_new, *, num_beams,
                num_beam_groups=1, diversity_rate=0.0, length_penalty=0.0,
                early_stopping=False, eos=-1, pad=0):
    """The best hypothesis of each row of ``ids [B, prompt]``:
    ``(tokens [B, max_new] int64, pad-filled, score [B] float32)``.

    ``model_step(tok [N, L], caches, offset) -> (logits [N, L, V],
    caches)`` is the dense cached forward at a host ``offset``;
    ``init_caches(batch)`` makes the per-layer ``(k, v)`` caches."""
    G = int(num_beam_groups)
    if num_beams % G:
        raise ValueError(
            f"num_beams ({num_beams}) must be divisible by "
            f"num_beam_groups ({G})")
    K = int(num_beams) // G
    alpha = float(length_penalty)
    if alpha < 0 and not early_stopping:
        # the exit bound divides the best live score by lp(max_new) as an
        # optimistic ceiling; a decreasing penalty inverts it
        raise ValueError(
            f"length_penalty must be >= 0 (got {alpha}) unless "
            "early_stopping=True: the early-exit bound assumes a "
            "non-decreasing length penalty")
    div = float(diversity_rate)
    b, prompt_len = ids.shape
    dev = ids.device
    f32 = dict(dtype=torch.float32, device=dev)

    def lp(length):
        return torch.tensor(float(length), **f32) ** torch.tensor(alpha,
                                                                  **f32)

    def flat_gather(caches, beam_sel):
        """Every layer's cache rows ``[B*G*K, ...]`` by the (batch,
        group) beam selection ``[B, G, K]`` (values in ``[0, K)``)."""
        base = (torch.arange(b, device=dev)[:, None, None] * (G * K)
                + torch.arange(G, device=dev)[None, :, None] * K)
        idx = (base + beam_sel).reshape(-1)
        return [(k.index_select(0, idx), v.index_select(0, idx))
                for k, v in caches]

    def group_select(logp_g, ls, lo, fs, fo, step_i):
        """One group's 2K-candidate selection at generated length
        ``step_i + 1`` (``logp_g [B, K, V]``): the new live and finished
        state, the chosen tokens and source beams ``[B, K]``."""
        V = logp_g.shape[-1]
        flat = (ls[..., None] + logp_g).reshape(b, K * V)
        scores2, idx2 = _top(flat, min(2 * K, K * V))
        beam2 = idx2 // V
        tok2 = idx2 % V
        is_eos = tok2 == eos
        src_out = _take(lo, beam2).clone()            # [B, 2K, max_new]
        src_out[:, :, step_i] = tok2
        # the finished set: K old and the 2K new EOS candidates merged
        new_fin = torch.where(is_eos, scores2 / lp(step_i + 1),
                              torch.full_like(scores2, NEG))
        fs, fin_idx = _top(torch.cat([fs, new_fin], 1), K)
        fo = _take(torch.cat([fo, src_out], 1), fin_idx)
        # the live set: the top K continuations that do not end in EOS
        live2 = torch.where(is_eos, torch.full_like(scores2, NEG), scores2)
        ls, live_idx = _top(live2, K)
        return (ls, _take(src_out, live_idx), fs, fo,
                torch.gather(tok2, 1, live_idx),
                torch.gather(beam2, 1, live_idx))

    def one_step(logp_bgk, state, step_i):
        """Every group at generated index ``step_i`` from the decode
        log-probabilities ``[B, G, K, V]``: the new state, the chosen
        tokens and source beams ``[B, G, K]``."""
        V = logp_bgk.shape[-1]
        freq = torch.zeros((b, V), **f32)
        parts = [[] for _ in range(6)]
        for g in range(G):              # groups couple through freq
            logp_g = logp_bgk[:, g]
            if div and g > 0:
                logp_g = logp_g - div * freq[:, None, :]
            got = group_select(logp_g, *(s[:, g] for s in state), step_i)
            if div and G > 1:
                freq = freq + torch.nn.functional.one_hot(
                    got[4], V).to(torch.float32).sum(1)
            for p, x in zip(parts, got):
                p.append(x)
        out = [torch.stack(p, 1) for p in parts]
        return tuple(out[:4]), out[4], out[5]

    caches = init_caches(b)
    logits, caches = model_step(ids, caches, 0)
    logp0 = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
    V = logp0.shape[-1]
    # row b's cache to rows [b*G*K, (b+1)*G*K)
    caches = [(k.repeat_interleave(G * K, 0), v.repeat_interleave(G * K, 0))
              for k, v in caches]
    # only beam 0 of each group starts live: every beam holds the same
    # prefix, and K live copies would fill the beam with one continuation
    live_scores = torch.where(torch.arange(K, device=dev) == 0,
                              torch.tensor(0.0, **f32),
                              torch.tensor(NEG, **f32)).expand(b, G, K)
    state = (live_scores,
             torch.full((b, G, K, max_new), pad, dtype=torch.int64,
                        device=dev),
             torch.full((b, G, K), NEG, **f32),
             torch.full((b, G, K, max_new), pad, dtype=torch.int64,
                        device=dev))
    # step 0 reads the prefill's logits, the same for every beam
    state, tok, beam_sel = one_step(
        logp0[:, None, None, :].expand(b, G, K, V), state, 0)
    caches = flat_gather(caches, beam_sel)
    lp_full = lp(max_new)

    def done(state):
        if early_stopping:      # every group holds K finished hypotheses
            return bool((state[2] > NEG / 2).all())
        # no live beam can still beat the worst finished hypothesis
        best_live = state[0].amax(2) / lp_full
        return bool((state[2].amin(2) >= best_live).all())

    i = 1
    while i < max_new and not done(state):
        logits, caches = model_step(tok.reshape(-1, 1), caches,
                                    prompt_len + i - 1)
        logp = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
        state, tok, beam_sel = one_step(logp.reshape(b, G, K, V), state, i)
        caches = flat_gather(caches, beam_sel)
        i += 1
    live_scores, live_out, fin_scores, fin_out = state
    # live beams are hypotheses only after a full-length run: on an early
    # exit they are truncated prefixes that would outrank every finished one
    if i >= max_new:
        live_final = live_scores / lp_full
    else:
        live_final = torch.full_like(live_scores, NEG)
    all_scores = torch.cat([fin_scores, live_final], 2).reshape(b, -1)
    all_out = torch.cat([fin_out, live_out], 2).reshape(b, G * 2 * K,
                                                        max_new)
    best = torch.argmax(all_scores, dim=1)
    out = _take(all_out, best[:, None])[:, 0]
    score = torch.gather(all_scores, 1, best[:, None])[:, 0]
    return out, score
