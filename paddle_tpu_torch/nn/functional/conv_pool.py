"""Convolution and pooling functions (counterpart of
``paddle_tpu/nn/functional/conv_pool.py``, Paddle's ``conv.py`` and
``pooling.py``).

The reference lowers these to XLA (``lax.conv_general_dilated``,
``lax.reduce_window``), not to a Pallas kernel; the port calls PyTorch's
convolutions and pools (cuDNN on the card), as its projections call
``torch.matmul``.

Paddle's conventions are kept:

- ``padding`` is an int, one int a spatial dim, ``(lo, hi)`` pairs
  flattened, a full-rank ``[[0, 0], [0, 0], [lo, hi], ...]`` list, or
  ``"SAME"`` / ``"VALID"`` (XLA's rule: ``SAME`` pads ``k_eff - 1`` where
  the stride divides, the odd pixel at the end). PyTorch's functions pad
  both sides alike, so unequal sides are padded explicitly first.
- Channels-last ``data_format`` (``"NLC"``, ``"NHWC"``, ``"NDHWC"``)
  runs on the channels-first view of the same memory
  (``torch.channels_last``): no copy either way, the same values.
- Average pools default to ``exclusive=True`` (PyTorch's
  ``count_include_pad=False``); under a ``"SAME"`` / ``"VALID"`` string
  they divide by the whole window, as the reference does.
  ``divisor_override`` and ``ceil_mode`` are accepted and, as in the
  reference, not applied (ROADMAP Queue 3); ``return_mask`` with
  ``ceil_mode`` raises there, and here.
- ``return_mask`` gives each window's first maximum as a flat int32
  index over the input's (unpadded) spatial dims, which
  ``max_unpool1d/2d/3d`` scatter back.

``conv1d/2d/3d`` call :func:`paddle_tpu_torch.amp.cast_inputs` under
their names (white under O1: bfloat16), so do the transposes and pools
under theirs (on no list).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ... import amp as _amp

__all__ = [
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "max_pool1d", "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
    "adaptive_avg_pool2d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
    "adaptive_max_pool2d", "adaptive_max_pool3d", "unfold", "fold",
    "max_unpool1d", "max_unpool2d", "max_unpool3d",
]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}
_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE = {"avg": {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
                     3: TF.adaptive_avg_pool3d},
             "max": {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d,
                     3: TF.adaptive_max_pool3d}}


def _tuplify(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(x) for x in v)
    return tuple(int(v) for _ in range(n))


def _conv_padding(padding, n):
    """Paddle's padding spec -> ``"SAME"`` / ``"VALID"`` or ``[(lo, hi)]``
    a spatial dim (the reference's ``_conv_padding``)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (list, tuple)):
        flat = list(padding)
        if len(flat) == n:
            return [(int(p), int(p)) for p in flat]
        if len(flat) == 2 * n:
            return [(int(flat[2 * i]), int(flat[2 * i + 1]))
                    for i in range(n)]
        if flat and isinstance(flat[0], (list, tuple)):
            return [(int(lo), int(hi)) for lo, hi in flat[-n:]]
    p = int(padding)
    return [(p, p)] * n


def _pads(padding, n, spatial, window, strides):
    """``[(lo, hi)]`` a spatial dim; a string resolved by XLA's rule over
    the (dilated) ``window``."""
    pad = _conv_padding(padding, n)
    if pad == "VALID":
        return [(0, 0)] * n
    if pad == "SAME":
        out = []
        for size, w, s in zip(spatial, window, strides):
            total = max((-(-size // s) - 1) * s + w - size, 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(pad, str):
        raise ValueError(f"unknown padding {pad!r}: use 'SAME', 'VALID' "
                         "or sizes")
    return pad


def _flat(pads):
    """``[(lo, hi)]`` a spatial dim -> ``F.pad``'s list, last dim first."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _channels_first(x, data_format):
    """A channels-last input as the channels-first view of its memory."""
    if data_format and data_format[-1] == "C" and len(data_format) > 2:
        return x.movedim(-1, 1), True
    return x, False


def _restore(y, was_last):
    return y.movedim(1, -1) if was_last else y


def _convnd(x, weight, bias, stride, padding, dilation, groups,
            data_format, nsp, op_name):
    x, weight, bias = _amp.cast_inputs(op_name, x, weight, bias)
    strides, dils = _tuplify(stride, nsp), _tuplify(dilation, nsp)
    x, last = _channels_first(x, data_format)
    window = [d * (k - 1) + 1 for d, k in zip(dils, weight.shape[2:])]
    pads = _pads(padding, nsp, x.shape[2:], window, strides)
    if all(lo == hi for lo, hi in pads):
        sym = [lo for lo, _ in pads]
    else:
        x, sym = TF.pad(x, _flat(pads)), 0
    out = _CONV[nsp](x, weight, bias, strides, sym, dils, groups)
    return _restore(out, last)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _convnd(x, weight, bias, stride, padding, dilation, groups,
                   data_format, 1, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """``weight [out, in / groups, kh, kw]``; ``data_format`` ``"NCHW"``
    or ``"NHWC"``."""
    return _convnd(x, weight, bias, stride, padding, dilation, groups,
                   data_format, 2, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _convnd(x, weight, bias, stride, padding, dilation, groups,
                   data_format, 3, "conv3d")


def _convnd_transpose(x, weight, bias, stride, padding, output_padding,
                      dilation, groups, data_format, nsp, op_name):
    """The reference's transposed conv: the forward conv over the input
    dilated by ``stride``, padded ``(d (k - 1) - lo, d (k - 1) - hi +
    output_padding)``; ``weight [in, out / groups, k...]``. A padding
    string raises ``ValueError``, as there. PyTorch's transposed conv
    takes equal sides and ``output_padding`` below the stride or the
    dilation; otherwise it runs at padding 0 (the conv padded ``(d (k -
    1), d (k - 1))``), and its output is cropped or extended by zeros to
    the reference's pads."""
    x, weight, bias = _amp.cast_inputs(op_name, x, weight, bias)
    strides, dils = _tuplify(stride, nsp), _tuplify(dilation, nsp)
    opad = _tuplify(output_padding, nsp) if output_padding else (0,) * nsp
    pad = _conv_padding(padding, nsp)
    if isinstance(pad, str):
        raise ValueError(f"{op_name}: padding {pad!r} is not supported for "
                         "a transposed convolution; give the sizes")
    x, last = _channels_first(x, data_format)
    if all(lo == hi >= 0 for lo, hi in pad) and all(
            o < max(s, d) for o, s, d in zip(opad, strides, dils)):
        out = _CONV_T[nsp](x, weight, bias, strides, [lo for lo, _ in pad],
                           opad, groups, dils)
        return _restore(out, last)
    out = _CONV_T[nsp](x, weight, None, strides, 0, 0, groups, dils)
    out = TF.pad(out, _flat([(-lo, o - hi) for (lo, hi), o in
                             zip(pad, opad)]))
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nsp)
    return _restore(out, last)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _convnd_transpose(x, weight, bias, stride, padding,
                             output_padding, dilation, groups, data_format,
                             1, "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    """``output_size`` is accepted and, as in the reference, not read:
    ``output_padding`` sets the size."""
    return _convnd_transpose(x, weight, bias, stride, padding,
                             output_padding, dilation, groups, data_format,
                             2, "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _convnd_transpose(x, weight, bias, stride, padding,
                             output_padding, dilation, groups, data_format,
                             3, "conv3d_transpose")


# -- pools -------------------------------------------------------------------

def _pool(x, kernel, stride, padding, nsp, op, data_format, op_name,
          exclusive=True):
    x, = _amp.cast_inputs(op_name, x)
    ks = _tuplify(kernel, nsp)
    st = _tuplify(stride if stride is not None else kernel, nsp)
    x, last = _channels_first(x, data_format)
    pads = _pads(padding, nsp, x.shape[2:], ks, st)
    sym = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ks))
    if op == "max":
        if sym:
            out = _MAX[nsp](x, ks, st, [lo for lo, _ in pads])
        else:
            out = _MAX[nsp](TF.pad(x, _flat(pads), value=-math.inf), ks, st)
        return _restore(out, last)
    by_count = exclusive and not isinstance(_conv_padding(padding, nsp),
                                            str)
    if sym:
        out = _AVG[nsp](x, ks, st, [lo for lo, _ in pads],
                        count_include_pad=not by_count)
    else:
        out = _AVG[nsp](TF.pad(x, _flat(pads)), ks, st)
        if by_count:
            ones = TF.pad(torch.ones_like(x[:1, :1]), _flat(pads))
            out = out / _AVG[nsp](ones, ks, st)
    return _restore(out, last)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, "avg", "NCL",
                 "avg_pool1d", exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, "avg", data_format,
                 "avg_pool2d", exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, "avg", data_format,
                 "avg_pool3d", exclusive)


def _max_with_mask(x, kernel, stride, padding, nsp):
    """Each window's maximum and the flat index of its first maximum
    over the input's spatial dims (int32; the reference's
    ``_max_pool_nd_with_mask``)."""
    k = _tuplify(kernel, nsp)
    s = _tuplify(stride if stride is not None else kernel, nsp)
    p = _tuplify(padding, nsp)
    spatial = x.shape[2:]
    win = TF.pad(x, _flat([(pi, pi) for pi in p]), value=-math.inf)
    for i in range(nsp):
        win = win.unfold(2 + i, k[i], s[i])
    out_sz = tuple(win.shape[2:2 + nsp])
    win = win.reshape(tuple(x.shape[:2]) + out_sz + (-1,))
    arg = win.argmax(dim=-1)
    vals = win.gather(-1, arg[..., None])[..., 0]
    mask, scale = torch.zeros_like(arg), 1
    for i in reversed(range(nsp)):
        off = arg % k[i]
        arg = arg // k[i]
        shape = [1] * (2 + nsp)
        shape[2 + i] = out_sz[i]
        start = (torch.arange(out_sz[i], device=x.device) * s[i]) \
            .reshape(shape)
        mask = mask + (start + off - p[i]) * scale
        scale *= spatial[i]
    return vals, mask.to(torch.int32)


def _max_pool_mask(x, kernel_size, stride, padding, nsp, data_format,
                   want_format, ceil_mode, op_name):
    if data_format != want_format or ceil_mode:
        raise NotImplementedError(
            f"{op_name} return_mask supports {want_format}, "
            "ceil_mode=False")
    x, = _amp.cast_inputs(op_name + "_mask", x)
    return _max_with_mask(x, kernel_size, stride, padding, nsp)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    if return_mask:
        return _max_pool_mask(x, kernel_size, stride, padding, 1, "NCL",
                              "NCL", ceil_mode, "max_pool1d")
    return _pool(x, kernel_size, stride, padding, 1, "max", "NCL",
                 "max_pool1d")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        return _max_pool_mask(x, kernel_size, stride, padding, 2,
                              data_format, "NCHW", ceil_mode, "max_pool2d")
    return _pool(x, kernel_size, stride, padding, 2, "max", data_format,
                 "max_pool2d")


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        return _max_pool_mask(x, kernel_size, stride, padding, 3,
                              data_format, "NCDHW", ceil_mode, "max_pool3d")
    return _pool(x, kernel_size, stride, padding, 3, "max", data_format,
                 "max_pool3d")


def _adaptive_out(x, output_size, nsp):
    """The input's spatial dims and the output's (``None`` keeps a
    dim)."""
    in_sp = tuple(x.shape[-nsp:])
    if isinstance(output_size, (list, tuple)):
        spec = list(output_size) * (nsp if len(output_size) == 1 else 1)
    else:
        spec = [output_size] * nsp
    return in_sp, tuple(i if o is None else int(o)
                        for i, o in zip(in_sp, spec))


def _adaptive_pool(x, output_size, nsp, op, op_name):
    """Bins ``[floor(j in / out), ceil((j + 1) in / out))``, PyTorch's and
    the reference's alike; ``data_format`` is not read (NC...)."""
    x, = _amp.cast_inputs(op_name, x)
    _, out_sp = _adaptive_out(x, output_size, nsp)
    return _ADAPTIVE[op][nsp](x, out_sp)


def _adaptive_max_mask(x, output_size, nsp, op_name):
    in_sp, out_sp = _adaptive_out(x, output_size, nsp)
    if any(i % o for i, o in zip(in_sp, out_sp)):
        raise NotImplementedError(
            f"{op_name} return_mask needs evenly dividing bins "
            f"(input {in_sp} -> output {out_sp})")
    ks = tuple(i // o for i, o in zip(in_sp, out_sp))
    x, = _amp.cast_inputs(op_name + "_mask", x)
    return _max_with_mask(x, ks, ks, 0, nsp)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "avg", "adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, "avg", "adaptive_avg_pool2d")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, "avg", "adaptive_avg_pool3d")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 1, "adaptive_max_pool1d")
    return _adaptive_pool(x, output_size, 1, "max", "adaptive_max_pool1d")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 2, "adaptive_max_pool2d")
    return _adaptive_pool(x, output_size, 2, "max", "adaptive_max_pool2d")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 3, "adaptive_max_pool3d")
    return _adaptive_pool(x, output_size, 3, "max", "adaptive_max_pool3d")


# -- im2col / col2im and unpooling ---------------------------------------------

def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W] -> [N, C kh kw, L]``, channels slowest."""
    x, = _amp.cast_inputs("unfold", x)
    ks, st = _tuplify(kernel_sizes, 2), _tuplify(strides, 2)
    dl = _tuplify(dilations, 2)
    pads = _pads(paddings, 2, x.shape[2:],
                 [d * (k - 1) + 1 for d, k in zip(dl, ks)], st)
    if all(lo == hi for lo, hi in pads):
        return TF.unfold(x, ks, dl, [lo for lo, _ in pads], st)
    return TF.unfold(TF.pad(x, _flat(pads)), ks, dl, 0, st)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, :func:`unfold`'s adjoint: overlapping patches add up."""
    x, = _amp.cast_inputs("fold", x)
    os_, ks = _tuplify(output_sizes, 2), _tuplify(kernel_sizes, 2)
    st, dl = _tuplify(strides, 2), _tuplify(dilations, 2)
    pd = _conv_padding(paddings, 2)
    full = [o + lo + hi for o, (lo, hi) in zip(os_, pd)]
    out = TF.fold(x, full, ks, dl, 0, st)
    return out[:, :, pd[0][0]:pd[0][0] + os_[0], pd[1][0]:pd[1][0] + os_[1]]


def _max_unpool(x, indices, kernel_size, stride, padding, output_size, nsp,
                data_format, want, op_name):
    if data_format != want:
        raise NotImplementedError(f"{op_name} supports {want} only")
    x, = _amp.cast_inputs(op_name, x)
    k = _tuplify(kernel_size, nsp)
    s = _tuplify(stride if stride is not None else kernel_size, nsp)
    p = _tuplify(padding, nsp)
    B, C = x.shape[:2]
    if output_size is not None:
        spatial = tuple(int(v) for v in output_size[-nsp:])
    else:
        spatial = tuple((o - 1) * s[i] - 2 * p[i] + k[i]
                        for i, o in enumerate(x.shape[2:]))
    flat = x.new_zeros((B, C, math.prod(spatial)))
    flat = flat.scatter(2, indices.reshape(B, C, -1).long(),
                        x.reshape(B, C, -1))
    return flat.reshape((B, C) + spatial)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCL", name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       output_size, 1, data_format, "NCL", "max_unpool1d")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    """Scatter pooled values back to the positions ``return_mask``
    recorded; zeros elsewhere."""
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       output_size, 2, data_format, "NCHW", "max_unpool2d")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCDHW", name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       output_size, 3, data_format, "NCDHW", "max_unpool3d")
