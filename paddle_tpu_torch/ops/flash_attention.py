"""Flash attention entry points (counterpart of
``paddle_tpu/ops/pallas/flash_attention.py``), in Paddle's flash-attn
layout ``[B, L, H, D]``.

Unbiased attention goes through the hand-written kernels of
``ops/kernels/flash_attention.py`` (K1f forward, K1dq / K1dkv backward),
and ``flashmask_attention`` through those of ``ops/kernels/flashmask.py``
(K6f, K6dq, K6dkv), on a CUDA tensor; on a CPU tensor through their plain
PyTorch versions. There is no eligibility gate that reroutes a CUDA
call: the kernels state their own shapes (head_dim 64 or 128, kv and
mask heads dividing query heads, any length) and raise outside them.

An additive bias or mask is XLA work in the reference, never a kernel's:
given one, ``flash_attention_core`` runs the recipe of
``jax.nn.dot_product_attention`` in eager PyTorch. Attention dropout
drops the attention *output*, as the reference does (upstream Paddle
drops the probabilities), by ``nn.functional.dropout``: imported where
it is called, as the reference does, since ``nn.functional`` re-exports
this module.
"""
from __future__ import annotations

import math

import torch

from .. import amp as _amp
from .kernels.flash_attention import flash_attention as _flash
from .kernels.flashmask import flashmask_attention_core

__all__ = ["flash_attention_core", "scaled_dot_product_attention",
           "flash_attention", "flashmask_attention", "mask_to_bias"]


def _biased_attention(q, k, v, bias, is_causal, scale):
    """``jax.nn.dot_product_attention``'s recipe (the reference's
    ``_xla_attention``): float32 logits times ``scale``, plus ``bias``
    (made 4-D by leading axes; its heads dividing H, head h reading bias
    head h // (H / heads), as the reference repeats it), the causal mask at
    -0.7 * float32 max, softmax in float32, probabilities cast to K's
    dtype, then their product with V. Grouped kv heads are read in place."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    while bias.dim() < 4:
        bias = bias[None]
    if h % bias.shape[1]:
        raise ValueError(f"a bias with {bias.shape[1]} heads: want a count "
                         f"that divides the {h} query heads")
    if bias.shape[1] not in (1, h):
        # a bias per kv-head group: repeat it to the query heads
        bias = bias.repeat_interleave(h // bias.shape[1], dim=1)
    qg = q.reshape(b, lq, hkv, g, d).float()
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    bias = bias.float()
    if bias.shape[1] == h:
        bias = bias.reshape(bias.shape[0], hkv, g, *bias.shape[2:])
    else:
        bias = bias[:, :, None]
    logits = logits + bias
    if is_causal:
        keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, -0.7 * torch.finfo(
            torch.float32).max)
    probs = torch.softmax(logits, dim=-1).to(k.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, lq, h, d)


def flash_attention_core(q, k, v, bias=None, is_causal=False, scale=None):
    """Attention over ``q [B, L, H, D]`` and ``k``/``v`` ``[B, L, Hkv,
    D]`` (``Hkv`` dividing ``H``), differentiable in all three.
    ``scale`` defaults to ``1 / sqrt(D)``. With a ``bias`` (broadcast to
    ``[B, H, Lq, Lk]``) it runs the eager recipe of the reference's XLA
    path; without one, K1."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if bias is not None:
        return _biased_attention(q, k, v, bias, is_causal, scale)
    return _flash(q, k, v, scale, causal=is_causal)


def mask_to_bias(mask, dtype):
    """Bool mask (True = keep) -> additive bias; float masks pass
    through."""
    if mask is None:
        return None
    if mask.dtype == torch.bool:
        return torch.where(mask, 0.0, -1e9).to(dtype)
    return mask


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention with an optional ``attn_mask`` (bool: True keeps; float:
    added to the logits) and dropout ``dropout_p`` on the output while
    ``training``: the reference's op ``flash_attention``, white under AMP
    O1 (q, k and v in the low dtype; the mask's bias in the query's dtype
    as given)."""
    from ..nn.functional.common import dropout
    bias = mask_to_bias(attn_mask, query.dtype)
    query, key, value = _amp.cast_inputs("flash_attention", query, key,
                                         value)
    out = flash_attention_core(query, key, value, bias=bias,
                               is_causal=is_causal)
    if dropout_p > 0.0 and training:
        out = dropout(out, dropout_p, training=True)
    return out


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """``paddle.nn.functional.flash_attention.flash_attention`` parity:
    ``(out, None)``."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, name=None):
    """``paddle.nn.functional.flashmask_attention``: attention under the
    FlashMask mask, ``startend_row_indices [B, Hm, Lk, 1 or 2]`` int
    (key column ``j`` hides query rows ``[start_j, Lq)`` with one bound,
    ``[start_j, end_j)`` with two; ``Hm`` dividing ``H``), plus the
    causal triangle when ``causal``, and dropout ``dropout`` on the
    output. K6 on a CUDA tensor, its plain version on a CPU tensor; the
    bounds are never lowered to a dense bias, so a row that sees nothing
    gives 0, as the reference's kernel. Without bounds it is
    ``scaled_dot_product_attention``."""
    from ..nn.functional.common import dropout as drop
    if startend_row_indices is None:
        return scaled_dot_product_attention(query, key, value, None,
                                            dropout, causal, True)
    out = flashmask_attention_core(query, key, value, startend_row_indices,
                                   causal=causal)
    if dropout > 0.0:
        out = drop(out, dropout, training=True)
    return out
