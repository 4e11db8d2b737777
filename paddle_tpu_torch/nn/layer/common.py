"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``):
``Identity``, ``Linear``, ``Embedding``, the dropouts, ``Flatten``,
``Bilinear``, ``CosineSimilarity`` and ``PairwiseDistance``, in Paddle's
parameter layout: ``Linear.weight`` is ``[in, out]`` and the forward is
``x @ weight + bias``, so a ``state_dict`` moves between the two packages
without transposes.

``Linear`` takes Paddle's signature and defaults: a bias unless
``bias_attr=False``, Xavier-normal weights; the port's models ask for
``bias_attr=False`` where their projections have none. Every layer takes
the port's ``device`` (default: cuda; ``device="cpu"`` asks for the CPU)
and ``dtype`` keywords. ``Linear.forward`` ends in the multi-LoRA hook
(:func:`paddle_tpu_torch.ops.lora.apply`, the reference's call at the end
of its ``mp_layers`` forwards), a no-op unless the layer is tagged and a
serving tick's scope is active.
"""
from __future__ import annotations

import torch

from ...ops import lora as _lora
from .. import functional as F
from ..initializer import Normal, XavierNormal
from .layers import Layer

__all__ = ["Identity", "Linear", "Embedding", "Dropout", "Dropout2D",
           "Dropout3D", "AlphaDropout", "Flatten", "Bilinear",
           "CosineSimilarity", "PairwiseDistance"]


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):
        return input


class Linear(Layer):
    """``y = x @ weight + bias``, ``weight [in, out]``; no bias with
    ``bias_attr=False``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr, dtype=dtype,
            default_initializer=XavierNormal(), device=device)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, dtype=dtype, is_bias=True,
            device=device)

    def forward(self, input):
        return _lora.apply(self, input,
                           F.linear(input, self.weight, self.bias))

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    """A ``[num_embeddings, embedding_dim]`` table, N(0, 1) by default; a
    ``padding_idx`` (negative counts from the end) starts at zeros and
    reads zeros."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (padding_idx if padding_idx is None
                             or padding_idx >= 0
                             else num_embeddings + padding_idx)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr, dtype=dtype,
            default_initializer=Normal(0.0, 1.0), device=device)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    """Dropout of probability ``p`` while the layer is in training mode
    (``nn.functional.dropout``: ``axis`` and ``mode`` as Paddle's); the
    identity in ``eval()``. The mask comes from ``generator`` when one is
    given, else from the default stream of the input's device
    (``framework.random``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None, *, generator=None):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p = p
        self.data_format = data_format
        self.generator = generator

    def forward(self, input):
        return F.dropout2d(input, self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p = p
        self.data_format = data_format
        self.generator = generator

    def forward(self, input):
        return F.dropout3d(input, self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, input):
        return F.alpha_dropout(input, self.p, training=self.training,
                               generator=self.generator)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, input):
        return torch.flatten(input, self.start_axis, self.stop_axis)


class Bilinear(Layer):
    """``out[b, o] = x1[b] . weight[o] . x2[b] + bias[o]``, ``weight [out,
    in1, in2]``, ``bias [1, out]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            dtype=dtype, device=device)
        self.bias = None if bias_attr is False else self.create_parameter(
            [1, out_features], attr=bias_attr, dtype=dtype, is_bias=True,
            device=device)

    def forward(self, x1, x2):
        out = torch.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        if self.bias is not None:
            out = out + self.bias
        return out


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    """``(sum |x - y + epsilon|^p)^(1 / p)`` over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return ((x - y + self.epsilon).abs() ** self.p).sum(
            -1, keepdim=self.keepdim) ** (1.0 / self.p)
