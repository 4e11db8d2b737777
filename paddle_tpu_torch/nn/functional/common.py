"""Common functionals (counterpart of ``paddle_tpu/nn/functional/
common.py``): ``linear``, ``embedding``, the dropouts, ``one_hot``,
``sequence_mask`` and ``pairwise_distance``. Each runs under the
reference's op name for AMP O1 (:func:`paddle_tpu_torch.amp.cast_inputs`).
The dropouts draw their masks from ``generator``, or from the default
stream of the input's device (``framework.random``)."""
from __future__ import annotations

import torch

from ... import amp as _amp
from ...framework.random import default_generator

__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d",
           "alpha_dropout", "one_hot", "sequence_mask", "pairwise_distance"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)``, ``weight`` in Paddle's ``[in, out]``
    layout."""
    x, weight, bias = _amp.cast_inputs("linear", x, weight, bias)
    y = x @ weight
    if bias is not None:
        y = y + bias
    return y


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x``; a ``padding_idx`` (>= 0) reads
    zeros, so its row gets no gradient."""
    weight, x = _amp.cast_inputs("embedding", weight, x)
    out = weight[x]
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


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
    x, = _amp.cast_inputs("dropout", x)
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


def dropout2d(x, p=0.5, training=True, data_format="NCHW", generator=None,
              name=None):
    """Whole channels of ``[N, C, H, W]`` (or NHWC) dropped together."""
    ch = 1 if data_format == "NCHW" else 3
    return dropout(x, p, axis=[0, ch], training=training,
                   generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", generator=None,
              name=None):
    """Whole channels of ``[N, C, D, H, W]`` (or NDHWC) dropped
    together."""
    ch = 1 if data_format == "NCDHW" else 4
    return dropout(x, p, axis=[0, ch], training=training,
                   generator=generator)


def alpha_dropout(x, p=0.5, training=True, generator=None, name=None):
    """SELU's dropout: a dropped element becomes ``-alpha * scale``, then
    an affine map keeps the mean and variance."""
    if not training or p == 0:
        return x
    g = default_generator(x.device) if generator is None else generator
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - p
    x, = _amp.cast_inputs("alpha_dropout", x)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    q = 1.0 - p
    a = (q + alpha_p ** 2 * q * p) ** -0.5
    b = -a * alpha_p * p
    return a * torch.where(keep, x, alpha_p) + b


def one_hot(x, num_classes, name=None):
    """float32 ``[..., num_classes]``; an id outside ``[0, num_classes)``
    gives a row of zeros."""
    classes = torch.arange(int(num_classes), device=x.device)
    return (x.long()[..., None] == classes).float()


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``[..., maxlen]``: 1 where the position is under the length ``x``
    (``maxlen`` defaults to the largest length)."""
    if maxlen is None:
        maxlen = int(x.max())
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    pos = torch.arange(int(maxlen), device=x.device)
    return (pos < x[..., None]).to(dtype)


def _p_norm_lastdim(d, p, keepdim=False):
    """The p-norm over the last axis, with p = inf (max), -inf (min) and
    0 (the count of nonzeros)."""
    ad = d.abs()
    if p == float("inf"):
        return ad.amax(dim=-1, keepdim=keepdim)
    if p == float("-inf"):
        return ad.amin(dim=-1, keepdim=keepdim)
    if p == 0:
        return (ad != 0).to(d.dtype).sum(dim=-1, keepdim=keepdim)
    return (ad ** p).sum(dim=-1, keepdim=keepdim) ** (1.0 / p)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """The p-norm of ``x - y + epsilon`` over the last axis."""
    x, y = _amp.cast_inputs("pairwise_distance", x, y)
    return _p_norm_lastdim(x - y + epsilon, p, keepdim)
