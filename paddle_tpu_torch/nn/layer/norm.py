"""Normalisation layers (counterpart of ``paddle_tpu/nn/layer/norm.py``),
with Paddle's ``weight_attr`` / ``bias_attr`` (``False``: no such
parameter) and the port's ``device`` / ``dtype`` keywords. The
``_epsilon`` attribute is the reference's name (the fused decode tick
reads it).

The batch norms keep their running statistics in the buffers ``_mean``
(zeros) and ``_variance`` (ones), float32, the reference's names, so a
``state_dict`` moves between the packages; ``train()`` normalises by the
batch and updates them (Paddle's ``momentum=0.9``, biased variance),
``eval()`` or ``use_global_stats=True`` normalises by them.
``SyncBatchNorm`` is ``BatchNorm`` at one rank: its cross-rank reduction
comes with ``torch.distributed`` (ROADMAP Queue 1 item 11).
``SpectralNorm`` divides a weight by its largest singular value, from a
power iteration whose vectors (``weight_u`` / ``weight_v``, frozen
parameters) carry over from call to call."""
from __future__ import annotations

import numpy as np
import torch

from .. import functional as F
from ..initializer import Assign, Constant
from .layers import Layer

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "GroupNorm",
           "LocalResponseNorm", "SpectralNorm"]


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


def _affine(layer, n, weight_attr, bias_attr, mk):
    layer.weight = None if weight_attr is False else \
        layer.create_parameter([n], attr=weight_attr,
                               default_initializer=Constant(1.0), **mk)
    layer.bias = None if bias_attr is False else layer.create_parameter(
        [n], attr=bias_attr, is_bias=True, **mk)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        _affine(self, num_features, weight_attr, bias_attr,
                dict(dtype=dtype, device=device))
        dev = self.weight.device if self.weight is not None else device
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=dev))

    def forward(self, input):
        return F.batch_norm(
            input, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device, dtype=dtype)


class SyncBatchNorm(_BatchNormBase):
    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm in it replaced by a
        ``SyncBatchNorm`` sharing its parameters and statistics."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                weight_attr=False if layer.weight is None
                                else None,
                                bias_attr=False if layer.bias is None
                                else None,
                                data_format=layer._data_format,
                                device=layer._mean.device)
            out.weight, out.bias = layer.weight, layer.bias
            out._mean, out._variance = layer._mean, layer._variance
        for name, sub in list(layer.named_children()):
            setattr(out, name, cls.convert_sync_batchnorm(sub))
        return out


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        _affine(self, num_features, weight_attr, bias_attr,
                dict(dtype=dtype, device=device))

    def forward(self, input):
        return F.instance_norm(input, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        _affine(self, num_channels, weight_attr, bias_attr,
                dict(dtype=dtype, device=device))

    def forward(self, input):
        return F.group_norm(input, self._num_groups, self._epsilon,
                            self.weight, self.bias)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, input):
        return F.local_response_norm(input, *self.args)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma ``u^T W v`` after ``power_iters`` (at
    least one) power steps from the last call's ``u`` and ``v`` (first
    from ``RandomState(0)`` normal draws, normalised, as the reference);
    ``W`` is the weight with axis ``dim`` first, flattened to a matrix.
    Only sigma's dependence on ``W`` is differentiated."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32", *, device=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = epsilon
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        rng = np.random.RandomState(0)
        u = rng.randn(h).astype(np.float32)
        v = rng.randn(w).astype(np.float32)
        for name, vec in (("weight_u", u), ("weight_v", v)):
            p = self.create_parameter(
                [vec.size], dtype=dtype, device=device,
                default_initializer=Assign(
                    vec / max(float(np.linalg.norm(vec)), 1e-12)))
            p.requires_grad_(False)
            setattr(self, name, p)

    def forward(self, weight):
        mat = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim],
                                                   -1)
        u, v = self.weight_u.detach(), self.weight_v.detach()
        with torch.no_grad():
            m = mat.detach()
            for _ in range(max(self._power_iters, 1)):
                v = m.T @ u
                v = v / torch.clamp(torch.linalg.norm(v), min=self._eps)
                u = m @ v
                u = u / torch.clamp(torch.linalg.norm(u), min=self._eps)
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        sigma = u @ mat @ v
        return weight / torch.clamp(sigma, min=self._eps)
