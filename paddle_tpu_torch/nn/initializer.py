"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer.py``,
Paddle's ``paddle.nn.initializer``).

An initializer is called on a parameter, ``init(param)``, and fills it in
place, as upstream Paddle's ``init(param, block)``. The random ones draw
from an explicit ``torch.Generator``: the one :func:`use_generator` holds
(a model builds its layers inside it, from its seed), else the default
stream of the parameter's device (``framework.random``); never PyTorch's
global generator. Inside :func:`owner_initializes` a random initializer
leaves the parameter as it was allocated: the model that owns it draws
its weights itself (the Llama, Qwen2, MoE and GPT families do, in
``_init_weights``). Fans follow Paddle's layouts: a 2-D weight is
``[in, out]``; a conv kernel ``[out, in, *k]``.
"""
from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch

from ..framework.random import default_generator

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain",
    "set_global_initializer", "use_generator", "owner_initializes",
]


class _Scope(threading.local):
    def __init__(self):
        self.generator = None
        self.skip_random = False


_scope = _Scope()


@contextlib.contextmanager
def use_generator(generator):
    """Random initializers inside draw from ``generator`` (on its
    device)."""
    prev = _scope.generator
    _scope.generator = generator
    try:
        yield generator
    finally:
        _scope.generator = prev


@contextlib.contextmanager
def owner_initializes():
    """Random initializers inside leave each parameter as allocated: its
    owner draws it. Constant and Assign still fill."""
    prev = _scope.skip_random
    _scope.skip_random = True
    try:
        yield
    finally:
        _scope.skip_random = prev


def _gen(t):
    g = _scope.generator
    if g is not None and g.device.type == t.device.type:
        return g
    return default_generator(t.device)


class Initializer:
    """Fill ``param`` in place; returns it."""
    random = False

    def __call__(self, param, block=None):
        if self.random and _scope.skip_random:
            return param
        with torch.no_grad():
            self._fill(param)
        return param

    def _fill(self, t):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _fill(self, t):
        t.fill_(self.value)


class Normal(Initializer):
    random = True

    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _fill(self, t):
        t.normal_(self.mean, self.std, generator=_gen(t))


class TruncatedNormal(Initializer):
    """A normal of ``mean`` and ``std`` cut to ``[a, b]``."""
    random = True

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _fill(self, t):
        torch.nn.init.trunc_normal_(t, self.mean, self.std, self.a, self.b,
                                    generator=_gen(t))


class Uniform(Initializer):
    random = True

    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def _fill(self, t):
        t.uniform_(self.low, self.high, generator=_gen(t))


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]          # a Linear weight is [in, out]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierNormal(Initializer):
    random = True

    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, t):
        fi, fo = _fans(t.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        t.normal_(0.0, self.gain * math.sqrt(2.0 / (fi + fo)),
                  generator=_gen(t))


class XavierUniform(Initializer):
    random = True

    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, t):
        fi, fo = _fans(t.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        t.uniform_(-limit, limit, generator=_gen(t))


class KaimingNormal(Initializer):
    random = True

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu", name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _fill(self, t):
        fi = self.fan_in if self.fan_in is not None else _fans(t.shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        t.normal_(0.0, gain / math.sqrt(fi), generator=_gen(t))


class KaimingUniform(Initializer):
    random = True

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu", name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _fill(self, t):
        fi = self.fan_in if self.fan_in is not None else _fans(t.shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        t.uniform_(-limit, limit, generator=_gen(t))


class Assign(Initializer):
    """The given values (a tensor, an array or nested lists), reshaped to
    the parameter's shape."""

    def __init__(self, value, name=None):
        self.value = value

    def _fill(self, t):
        v = torch.as_tensor(np.asarray(self.value)) \
            if not isinstance(self.value, torch.Tensor) else self.value
        t.copy_(v.reshape(t.shape).to(t.dtype))


class Orthogonal(Initializer):
    """``gain`` times a random orthogonal matrix over the last axis (the
    columns) and the product of the others (the rows), as
    ``jax.nn.initializers.orthogonal``: orthonormal rows when there are
    fewer rows than columns, else orthonormal columns."""
    random = True

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def _fill(self, t):
        cols = t.shape[-1]
        rows = t.numel() // cols
        big, small = max(rows, cols), min(rows, cols)
        a = torch.empty(big, small, device=t.device, dtype=torch.float32)
        a.normal_(generator=_gen(t))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if rows < cols:
            q = q.t()
        t.copy_((self.gain * q).reshape(t.shape).to(t.dtype))


class Dirac(Initializer):
    """A conv kernel ``[out, in, *k]`` that passes channel ``i % in`` to
    output ``i`` at the kernel's centre, over ``groups``."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def _fill(self, t):
        shape = tuple(t.shape)
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        centers = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + centers] = 1.0
        t.copy_(torch.from_numpy(out).to(t.dtype))


def calculate_gain(nonlinearity, param=None):
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    raise ValueError(f"unknown nonlinearity {nonlinearity}")


_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """Record the global initializers, as the reference does; like the
    reference's ``create_parameter``, the port's does not read them."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init
