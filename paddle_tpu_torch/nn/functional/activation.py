"""Activation functions (counterpart of ``paddle_tpu/nn/functional/
activation.py``): every activation the reference exports, each under the
reference's op name for AMP O1 (:func:`paddle_tpu_torch.amp.cast_inputs`).
``rrelu`` (in training) and ``gumbel_softmax`` draw from ``generator``,
or from the default stream of the input's device (``framework.random``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import amp as _amp
from ...framework.random import default_generator

__all__ = [
    "relu", "relu_", "relu6", "gelu", "sigmoid", "silu", "swish", "softmax",
    "softmax_", "log_softmax", "leaky_relu", "elu", "elu_", "selu", "celu",
    "hardtanh", "hardsigmoid", "hardswish", "hardshrink", "softshrink",
    "tanhshrink", "softplus", "softsign", "mish", "glu", "prelu", "rrelu",
    "tanh", "tanh_", "maxout", "thresholded_relu", "log_sigmoid",
    "gumbel_softmax",
]


def _unary(op_name, fn):
    def op(x, name=None):
        x, = _amp.cast_inputs(op_name, x)
        return fn(x)
    op.__name__ = op_name
    op.__doc__ = f"``{op_name}`` elementwise."
    return op


relu = _unary("relu", torch.relu)
relu6 = _unary("relu6", F.relu6)
sigmoid = _unary("sigmoid", torch.sigmoid)
silu = _unary("silu", F.silu)
softsign = _unary("softsign", lambda x: x / (1 + x.abs()))
tanh = _unary("tanh", torch.tanh)
tanhshrink = _unary("tanhshrink", lambda x: x - torch.tanh(x))
log_sigmoid = _unary("log_sigmoid", F.logsigmoid)
mish = _unary("mish", lambda x: x * torch.tanh(F.softplus(x)))


def relu_(x, name=None):
    return x.copy_(relu(x))


def tanh_(x, name=None):
    return x.copy_(tanh(x))


def softmax_(x, axis=-1, name=None):
    return x.copy_(softmax(x, axis))


def elu_(x, alpha=1.0, name=None):
    return x.copy_(elu(x, alpha))


def gelu(x: torch.Tensor, approximate: bool = False, name=None):
    """GELU: ``x * Phi(x)`` by the error function, or with
    ``approximate=True`` the tanh form ``0.5 x (1 + tanh(sqrt(2 / pi)
    (x + 0.044715 x^3)))`` (``jax.nn.gelu``'s two modes; GPT's MLP runs
    the tanh form, which K3b's ``act="gelu_tanh"`` fuses)."""
    x, = _amp.cast_inputs("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def swish(x, name=None):
    return silu(x)


def _as_dtype(x, dtype):
    if dtype is None:
        return x
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return x.to(dtype)


def softmax(x, axis=-1, dtype=None, name=None):
    x, = _amp.cast_inputs("softmax", x)
    return torch.softmax(_as_dtype(x, dtype), dim=int(axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    x, = _amp.cast_inputs("log_softmax", x)
    return torch.log_softmax(_as_dtype(x, dtype), dim=int(axis))


def leaky_relu(x, negative_slope=0.01, name=None):
    x, = _amp.cast_inputs("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    x, = _amp.cast_inputs("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    x, = _amp.cast_inputs("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    x, = _amp.cast_inputs("celu", x)
    return torch.clamp(x, min=0) + alpha * torch.expm1(
        torch.clamp(x, max=0) / alpha)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    x, = _amp.cast_inputs("hardtanh", x)
    return torch.clamp(x, min, max)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    x, = _amp.cast_inputs("hardsigmoid", x)
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    x, = _amp.cast_inputs("hardswish", x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardshrink(x, threshold=0.5, name=None):
    x, = _amp.cast_inputs("hardshrink", x)
    return torch.where(x.abs() > threshold, x, 0.0)


def softshrink(x, threshold=0.5, name=None):
    x, = _amp.cast_inputs("softshrink", x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    x, = _amp.cast_inputs("softplus", x)
    return F.softplus(x, beta, threshold)


def glu(x, axis=-1, name=None):
    x, = _amp.cast_inputs("glu", x)
    return F.glu(x, dim=int(axis))


def prelu(x, weight, data_format="NCHW", name=None):
    """``max(0, x) + weight * min(0, x)`` with one slope, or one a channel
    (axis 1, or the last for a channels-last ``data_format``)."""
    x, weight = _amp.cast_inputs("prelu", x, weight)
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format[1] == "C" else x.dim() - 1] = weight.numel()
        w = weight.reshape(shape)
    return torch.where(x > 0, x, w * x)


def rrelu(x, lower=1.0 / 8, upper=1.0 / 3, training=False, name=None,
          generator=None):
    """In training a slope a element, uniform in ``[lower, upper)``; else
    the leaky ReLU of their mean."""
    if training:
        g = default_generator(x.device) if generator is None else generator
        slope = torch.empty(x.shape, device=x.device, dtype=x.dtype)
        slope.uniform_(lower, upper, generator=g)
        x, = _amp.cast_inputs("rrelu", x)
        return torch.where(x >= 0, x, slope * x)
    return leaky_relu(x, (lower + upper) / 2.0)


def maxout(x, groups, axis=1, name=None):
    x, = _amp.cast_inputs("maxout", x)
    ax = int(axis) % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax + 1)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    x, = _amp.cast_inputs("thresholded_relu", x)
    return torch.where(x > threshold, x, value)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None,
                   generator=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g = -log(-log
    U)``; ``hard`` returns the one-hot of its argmax, with the soft
    sample's gradient (straight-through)."""
    g = default_generator(x.device) if generator is None else generator
    u = torch.empty(x.shape, device=x.device, dtype=x.dtype)
    u.uniform_(torch.finfo(x.dtype).tiny, 1.0, generator=g)
    noise = -torch.log(-torch.log(u))
    x, = _amp.cast_inputs("gumbel_softmax", x)
    ax = int(axis)
    y = torch.softmax((x + noise) / temperature, dim=ax)
    if hard:
        onehot = torch.zeros_like(y).scatter_(
            ax, y.argmax(dim=ax, keepdim=True), 1.0)
        return y + (onehot - y).detach()
    return y
