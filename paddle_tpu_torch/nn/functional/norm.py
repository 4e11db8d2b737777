"""Normalisation functions (counterpart of ``paddle_tpu/nn/functional/
norm.py``), each under the reference's op name for AMP O1
(:func:`paddle_tpu_torch.amp.cast_inputs`: ``layer_norm`` and
``rms_norm`` are black, so their inputs come back to float32)."""
from __future__ import annotations

import torch

from ... import amp as _amp

__all__ = ["rms_norm", "layer_norm", "normalize"]


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x`` over its p-norm along ``axis``, the norm at least
    ``epsilon``."""
    x, = _amp.cast_inputs("normalize", x)
    nrm = (x.abs() ** p).sum(dim=int(axis), keepdim=True) ** (1.0 / p)
    return x / torch.clamp(nrm, min=epsilon)


def rms_norm(x: torch.Tensor, weight=None, epsilon: float = 1e-6,
             name=None):
    """RMSNorm with the reference recipe: the statistic accumulates in
    float32, the normalised rows are cast back to the activation dtype,
    and only then multiplied by ``weight`` (in the activation dtype)."""
    x, weight = _amp.cast_inputs("rms_norm", x, weight)
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5, name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes (an int or a
    list) with the reference recipe: mean and biased variance in
    float32, the normalised rows cast back to the activation dtype, then
    ``* weight`` and ``+ bias`` in that dtype. K3a's plain ``kind="ln"``
    (``ops/kernels/decode_fused.py``) runs this function, so the fused
    and unfused decode ticks are bitwise one model on the CPU."""
    x, weight, bias = _amp.cast_inputs("layer_norm", x, weight, bias)
    n = 1 if isinstance(normalized_shape, int) else len(normalized_shape)
    axes = tuple(range(x.dim() - n, x.dim()))
    xf = x.float()
    m = torch.mean(xf, dim=axes, keepdim=True)
    v = torch.mean((xf - m) * (xf - m), dim=axes, keepdim=True)
    out = ((xf - m) * torch.rsqrt(v + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
