"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``): applied
by an optimizer (``grad_clip=``) to its ``(param, grad)`` pairs before
the update."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """Scale every gradient by ``clip_norm / max(global_norm,
    clip_norm)``; the norm accumulates in float32 and each gradient keeps
    its dtype."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        gn_sq = sum(torch.sum(g.float() ** 2) for g in grads)
        global_norm = torch.sqrt(gn_sq)
        scale = torch.clamp(
            self.clip_norm / torch.clamp(global_norm, min=self.clip_norm),
            max=1.0)
        return [(p, g if g is None else (g * scale).to(g.dtype))
                for p, g in params_grads]
