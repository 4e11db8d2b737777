"""Activation layers (counterpart of ``paddle_tpu/nn/layer/
activation.py``): each calls its functional with the arguments it was
built with (positional ones in the reference's order)."""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "Silu", "Swish", "Mish",
           "Softsign", "Tanhshrink", "LogSigmoid", "Hardswish", "GELU",
           "LeakyReLU", "ELU", "CELU", "Hardtanh", "Hardsigmoid",
           "Hardshrink", "Softshrink", "Softplus", "ThresholdedReLU",
           "Softmax", "LogSoftmax", "GLU", "Maxout", "SELU", "PReLU",
           "RReLU", "Softmax2D"]


def _simple(cls_name, fn_name, **defaults):
    names = list(defaults)

    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        merged = dict(defaults)
        merged.update(zip(names, args))
        merged.update({k: v for k, v in kwargs.items() if k != "name"})
        self._kwargs = merged

    def forward(self, x):
        return getattr(F, fn_name)(x, **self._kwargs)

    return type(cls_name, (Layer,), {"__init__": __init__,
                                     "forward": forward,
                                     "__doc__": f"``F.{fn_name}``."})


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
Sigmoid = _simple("Sigmoid", "sigmoid")
Tanh = _simple("Tanh", "tanh")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "swish")
Mish = _simple("Mish", "mish")
Softsign = _simple("Softsign", "softsign")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
Hardswish = _simple("Hardswish", "hardswish")
GELU = _simple("GELU", "gelu", approximate=False)
LeakyReLU = _simple("LeakyReLU", "leaky_relu", negative_slope=0.01)
ELU = _simple("ELU", "elu", alpha=1.0)
CELU = _simple("CELU", "celu", alpha=1.0)
Hardtanh = _simple("Hardtanh", "hardtanh", min=-1.0, max=1.0)
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Hardshrink = _simple("Hardshrink", "hardshrink", threshold=0.5)
Softshrink = _simple("Softshrink", "softshrink", threshold=0.5)
Softplus = _simple("Softplus", "softplus", beta=1.0, threshold=20.0)
ThresholdedReLU = _simple("ThresholdedReLU", "thresholded_relu",
                          threshold=1.0)
Softmax = _simple("Softmax", "softmax", axis=-1)
LogSoftmax = _simple("LogSoftmax", "log_softmax", axis=-1)
GLU = _simple("GLU", "glu", axis=-1)
Maxout = _simple("Maxout", "maxout", groups=2, axis=1)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale, self.alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self.scale, self.alpha)


class PReLU(Layer):
    """``max(0, x) + weight * min(0, x)``: one slope, or
    ``num_parameters`` (one a channel), starting at ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr, dtype=dtype, device=device,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    """Random slopes in ``[lower, upper)`` in training (from
    ``generator``, or the input device's default stream); their mean in
    ``eval()``."""

    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, name=None, *,
                 generator=None):
        super().__init__()
        self.lower, self.upper = lower, upper
        self.generator = generator

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, self.training,
                       generator=self.generator)


class Softmax2D(Layer):
    """Softmax over the channel axis of ``[N, C, H, W]``."""

    def forward(self, x):
        return F.softmax(x, axis=-3)
