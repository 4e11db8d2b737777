"""Common functionals (counterpart of ``paddle_tpu/nn/functional/
common.py``): dropout."""
from __future__ import annotations

import torch

from ...framework.random import default_generator

__all__ = ["dropout"]


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None, name=None):
    """Zero each element of ``x`` with probability ``p``: a Bernoulli keep
    mask with P(keep) = 1 - p, drawn over ``x``'s shape, or over the axes
    in ``axis`` (an int or a list) and broadcast along the others. In
    ``upscale_in_train`` mode the kept values are divided by 1 - p;
    ``downscale_in_infer`` keeps them as they are. ``training=False`` or
    p = 0 returns ``x``. The mask comes from ``generator``, or from the
    default stream of ``x``'s device (``framework.random``)."""
    if not training or p == 0:
        return x
    rate = float(p)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = tuple(x.shape[i] if i in axes else 1 for i in range(x.dim()))
    else:
        shape = tuple(x.shape)
    g = default_generator(x.device) if generator is None else generator
    keep = torch.rand(shape, generator=g, device=x.device) < 1.0 - rate
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - rate), 0.0)
    return torch.where(keep, x, 0.0)
