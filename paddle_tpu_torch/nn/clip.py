"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``): the
``ClipGradBy*`` classes are applied by an optimizer (``grad_clip=``) to
its ``(param, grad)`` pairs before the update; ``clip_grad_norm_`` and
``clip_grad_value_`` clip the ``.grad`` of given parameters in place."""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Every gradient element clamped to ``[min, max]`` (``min`` defaults
    to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip_norm / ||g||, 1)``, its norm in
    float32."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is not None:
                norm = torch.sqrt(torch.sum(g.float() ** 2))
                scale = torch.clamp(
                    self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
                g = (g * scale).to(g.dtype)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``clip_norm / max(global_norm,
    clip_norm)``; the norm accumulates in float32 and each gradient keeps
    its dtype."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

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


def _with_grads(parameters):
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    return [p for p in parameters if p.grad is not None]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients in place by ``min(max_norm / total, 1)``, the
    total their ``norm_type``-norm together (inf: the largest element);
    returns the total."""
    params = _with_grads(parameters)
    if not params:
        return torch.zeros(())
    grads = [p.grad for p in params]
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([(g.abs() ** norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(
            f"gradient norm is non-finite ({float(total)}); set "
            "error_if_nonfinite=False to clip anyway")
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    for p in params:
        p.grad = (p.grad * scale).to(p.grad.dtype)
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp every gradient element to ``[-clip_value, clip_value]`` in
    place."""
    cv = float(clip_value)
    for p in _with_grads(parameters):
        p.grad = torch.clamp(p.grad, -cv, cv)
