"""Fused-op functional helpers of the serving path (counterpart of
``paddle_tpu/incubate/nn/functional`` plus the rope helpers of
``paddle_tpu/models/llama.py``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["swiglu", "rope_tables", "rope_rotate", "apply_rope"]


def swiglu(x, y=None):
    """``silu(x) * y``; with ``y`` None, ``x`` is split in half."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y


def rope_tables(seq_len, head_dim, theta):
    """``(cos, sin)`` float32 numpy tables ``[seq_len, head_dim / 2]``,
    computed exactly as the reference does (float32 throughout)."""
    pos = np.arange(seq_len, dtype=np.float32)
    inv = theta ** (-np.arange(0, head_dim, 2, dtype=np.float32)
                    / head_dim)
    freqs = np.outer(pos, inv)
    return np.cos(freqs), np.sin(freqs)


def rope_rotate(x, c, s):
    """Neox-halves rotation. ``c``/``s`` broadcast against
    ``x[..., :D/2]``; the tables stay float32 and the result is cast back
    to ``x``'s dtype."""
    d = x.shape[-1]
    xf = x.float()
    x1 = xf[..., : d // 2]
    x2 = xf[..., d // 2:]
    c = c.float()
    s = s.float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, cos, sin):
    """Rope over ``x [B, L, H, D]`` with the tables ``cos``/``sin``
    ``[L, D/2]`` shared by every row (the reference's ``_apply_rope``)."""
    return rope_rotate(x, cos[None, :, None, :], sin[None, :, None, :])
