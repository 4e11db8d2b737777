"""Normalisation functions (counterpart of ``paddle_tpu/nn/functional/
norm.py``), each under the reference's op name for AMP O1
(:func:`paddle_tpu_torch.amp.cast_inputs`: ``layer_norm``, ``rms_norm``
and ``batch_norm`` are black, so their inputs come back to float32).

``batch_norm`` keeps Paddle's running statistics: ``running = momentum *
running + (1 - momentum) * batch`` with ``momentum=0.9`` and the
*biased* batch variance, written in place on the buffers (a captured
step keeps reading them). PyTorch's ``batch_norm`` takes the complement
momentum and writes the unbiased variance, so it runs here only to
normalise (its fused kernels, forward and backward) and to hand back the
batch's statistics, which are then folded in by the reference's rule.
``instance_norm`` and ``group_norm`` normalise by the biased variance
over each sample's (group's) spatial positions; like the reference they
read no running statistics and no ``data_format``."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import amp as _amp

__all__ = ["rms_norm", "layer_norm", "normalize", "batch_norm",
           "instance_norm", "group_norm", "local_response_norm"]


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


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Normalise over every axis but the channel one (axis 1, or the last
    for a channels-last ``data_format`` of a tensor past 2-D): by the
    batch's mean and biased variance while ``training`` (unless
    ``use_global_stats``), folding them into ``running_mean`` /
    ``running_var``; by the running statistics otherwise."""
    x, weight, bias = _amp.cast_inputs("batch_norm", x, weight, bias)
    last = not (data_format[1] == "C" or x.dim() <= 2)
    xc = x.movedim(-1, 1) if last else x
    if training and not use_global_stats:
        if running_mean is None:
            out = TF.batch_norm(xc, None, None, weight, bias, True, 0.0,
                                epsilon)
        else:
            n = xc.numel() // xc.shape[1]
            mean = torch.zeros_like(running_mean)
            var = torch.zeros_like(running_var)
            # momentum 1: PyTorch hands back the batch's mean and its
            # unbiased variance in mean / var
            out = TF.batch_norm(xc, mean, var, weight, bias, True, 1.0,
                                epsilon)
            with torch.no_grad():
                running_mean.copy_(momentum * running_mean
                                   + (1 - momentum) * mean)
                running_var.copy_(momentum * running_var
                                  + (1 - momentum) * (var * ((n - 1) / n)))
    else:
        out = TF.batch_norm(xc, running_mean, running_var, weight, bias,
                            False, 0.0, epsilon)
    return out.movedim(1, -1) if last else out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each sample's channels normalised over their spatial positions
    (the running statistics and ``use_input_stats`` are not read, as in
    the reference)."""
    x, weight, bias = _amp.cast_inputs("instance_norm", x, weight, bias)
    return TF.instance_norm(x, None, None, weight, bias, True, 0.0, eps)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    x, weight, bias = _amp.cast_inputs("group_norm", x, weight, bias)
    return TF.group_norm(x, int(num_groups), weight, bias, epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * mean of x^2 over size channels) ** beta``, the
    window ``size // 2`` channels before and ``(size - 1) // 2`` after."""
    x, = _amp.cast_inputs("local_response_norm", x)
    return TF.local_response_norm(x, size, alpha, beta, k)
