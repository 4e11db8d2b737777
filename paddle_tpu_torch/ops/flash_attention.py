"""Flash attention entry points (counterpart of
``paddle_tpu/ops/pallas/flash_attention.py``), in Paddle's flash-attn
layout ``[B, L, H, D]``.

Every call goes through the hand-written kernels of
``ops/kernels/flash_attention.py`` (K1f forward, K1dq / K1dkv backward)
on a CUDA tensor, and through their plain PyTorch versions on a CPU
tensor; there is no eligibility gate that reroutes a CUDA call. The
kernels state their own shapes (head_dim 64 or 128, kv heads dividing
query heads, any length) and raise outside them. An additive bias or
mask and attention dropout are XLA work in the reference, not the
kernel's; this slice raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import math

import torch

from .kernels.flash_attention import flash_attention as _flash

__all__ = ["flash_attention_core", "scaled_dot_product_attention",
           "flash_attention", "mask_to_bias"]


def flash_attention_core(q, k, v, bias=None, is_causal=False, scale=None):
    """Attention over ``q [B, L, H, D]`` and ``k``/``v`` ``[B, L, Hkv,
    D]`` (``Hkv`` dividing ``H``), differentiable in all three.
    ``scale`` defaults to ``1 / sqrt(D)``."""
    if bias is not None:
        raise NotImplementedError(
            "flash_attention_core: an additive bias is not ported yet (the "
            "reference runs it through XLA, not the kernel)")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
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
    if attn_mask is not None:
        raise NotImplementedError(
            "scaled_dot_product_attention: attn_mask is not ported yet")
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "scaled_dot_product_attention: attention dropout is not ported "
            "yet")
    return flash_attention_core(query, key, value, is_causal=is_causal)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """``paddle.nn.functional.flash_attention.flash_attention`` parity:
    ``(out, None)``."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None
