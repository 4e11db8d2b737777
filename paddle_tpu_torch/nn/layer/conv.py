"""Convolution layers (counterpart of ``paddle_tpu/nn/layer/conv.py``,
Paddle's ``Conv1D/2D/3D`` and their transposes).

Weights keep Paddle's layouts, which are also PyTorch's: ``[out, in /
groups, k...]``, transposed ``[in, out / groups, k...]``. Weight and bias
start from ``Uniform(-1 / sqrt(fan_in), 1 / sqrt(fan_in))``, ``fan_in =
in / groups * prod(k)``, drawn from the port's explicit generator
(:mod:`paddle_tpu_torch.nn.initializer`). ``padding_mode`` is accepted
and, as in the reference, not applied (zeros). Every layer takes the
port's ``device`` (default: cuda) and ``dtype`` keywords.
"""
from __future__ import annotations

import math

import torch

from .. import functional as F
from ..initializer import Uniform
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nsp,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", transpose=False, output_padding=0, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        ks = [int(k) for k in (kernel_size if isinstance(
            kernel_size, (list, tuple)) else [kernel_size] * nsp)]
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = ks
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._output_padding = output_padding
        w_shape = ([in_channels, out_channels // groups] if transpose
                   else [out_channels, in_channels // groups]) + ks
        bound = 1.0 / math.sqrt((in_channels // groups) * math.prod(ks))
        mk = dict(dtype=dtype, device=device)
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr,
            default_initializer=Uniform(-bound, bound), **mk)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound), **mk)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")


class _Conv(_ConvNd):
    _nsp, _fn, _format = 2, None, "NCHW"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None, *,
                 device=None, dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, self._nsp,
                         stride, padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr,
                         data_format or self._format, device=device,
                         dtype=dtype)

    def forward(self, x):
        return self._fn(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1D(_Conv):
    _nsp, _fn, _format = 1, staticmethod(F.conv1d), "NCL"


class Conv2D(_Conv):
    _nsp, _fn, _format = 2, staticmethod(F.conv2d), "NCHW"


class Conv3D(_Conv):
    _nsp, _fn, _format = 3, staticmethod(F.conv3d), "NCDHW"


class _ConvTranspose(_ConvNd):
    _nsp, _fn, _format = 2, None, "NCHW"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format=None, *,
                 device=None, dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, self._nsp,
                         stride, padding, dilation, groups, "zeros",
                         weight_attr, bias_attr,
                         data_format or self._format, transpose=True,
                         output_padding=output_padding, device=device,
                         dtype=dtype)

    def forward(self, x, output_size=None):
        return self._fn(x, self.weight, self.bias, self._stride,
                        self._padding, self._output_padding, self._groups,
                        self._dilation, output_size, self._data_format)


class Conv1DTranspose(_ConvTranspose):
    """Paddle's order here is ``(..., output_padding, groups, dilation,
    ...)``, unlike the 2-D and 3-D layers'."""
    _nsp, _fn, _format = 1, staticmethod(F.conv1d_transpose), "NCL"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype)


class Conv2DTranspose(_ConvTranspose):
    _nsp, _fn, _format = 2, staticmethod(F.conv2d_transpose), "NCHW"


class Conv3DTranspose(_ConvTranspose):
    _nsp, _fn, _format = 3, staticmethod(F.conv3d_transpose), "NCDHW"
