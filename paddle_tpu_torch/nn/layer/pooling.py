"""Pooling layers (counterpart of ``paddle_tpu/nn/layer/pooling.py``):
each holds its arguments and calls its function of
:mod:`paddle_tpu_torch.nn.functional.conv_pool`. They have no
parameters."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D", "MaxUnPool1D", "MaxUnPool2D",
           "MaxUnPool3D"]


class _Pool(Layer):
    _fn = None

    def __init__(self, kernel_size=None, stride=None, padding=0, **kw):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kw = kw

    def forward(self, x):
        return self._fn(x, self.kernel_size, self.stride, self.padding,
                        **self.kw)


class AvgPool1D(_Pool):
    _fn = staticmethod(F.avg_pool1d)


class AvgPool2D(_Pool):
    _fn = staticmethod(F.avg_pool2d)


class AvgPool3D(_Pool):
    _fn = staticmethod(F.avg_pool3d)


class MaxPool1D(_Pool):
    _fn = staticmethod(F.max_pool1d)


class MaxPool2D(_Pool):
    _fn = staticmethod(F.max_pool2d)


class MaxPool3D(_Pool):
    _fn = staticmethod(F.max_pool3d)


class _AdaptivePool(Layer):
    _fn = None

    def __init__(self, output_size, **kw):
        super().__init__()
        self.output_size = output_size
        self.kw = kw

    def forward(self, x):
        return self._fn(x, self.output_size, **self.kw)


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool1d)


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool2d)


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool3d)


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool1d)


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool2d)


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool3d)


class _MaxUnPool(Layer):
    """The inverse of ``MaxPool*(return_mask=True)``: scatters pooled
    values back to the recorded positions."""
    _fn, _format = None, "NCHW"

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_size = output_size
        self.data_format = data_format or self._format

    def forward(self, x, indices):
        return self._fn(x, indices, self.kernel_size, self.stride,
                        self.padding, self.output_size, self.data_format)


class MaxUnPool1D(_MaxUnPool):
    _fn, _format = staticmethod(F.max_unpool1d), "NCL"


class MaxUnPool2D(_MaxUnPool):
    _fn, _format = staticmethod(F.max_unpool2d), "NCHW"


class MaxUnPool3D(_MaxUnPool):
    _fn, _format = staticmethod(F.max_unpool3d), "NCDHW"
