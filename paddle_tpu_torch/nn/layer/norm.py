"""Normalisation layers (counterpart of ``LayerNorm`` and ``RMSNorm`` of
``paddle_tpu/nn/layer/norm.py``), with Paddle's ``weight_attr`` /
``bias_attr`` (``False``: no such parameter) and the port's ``device`` /
``dtype`` keywords. The ``_epsilon`` attribute is the reference's name
(the fused decode tick reads it)."""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` axes, with a
    ``weight`` (ones) and a ``bias`` (zeros) of that shape."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        shape = [normalized_shape] if isinstance(normalized_shape, int) \
            else list(normalized_shape)
        self._normalized_shape = shape
        self._epsilon = float(epsilon)
        mk = dict(dtype=dtype, device=device)
        self.weight = None if weight_attr is False else \
            self.create_parameter(shape, attr=weight_attr,
                                  default_initializer=Constant(1.0), **mk)
        self.bias = None if bias_attr is False else self.create_parameter(
            shape, attr=bias_attr, is_bias=True, **mk)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self._epsilon = float(epsilon)
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr, dtype=dtype, device=device,
            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)
