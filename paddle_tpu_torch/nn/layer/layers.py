"""``Layer`` (counterpart of ``paddle_tpu/nn/layer/layers.py``, Paddle's
``paddle.nn.Layer``): a ``torch.nn.Module`` with Paddle's API on top.

Where a Paddle name is also a ``Module`` name (``parameters``,
``named_parameters``, ``buffers``, ``register_buffer``, ``train``,
``eval``, ``to``, ``state_dict``, ``apply``), the ``Module`` behaviour and
signature stay, so ``TrainStep``, ``torch.utils.checkpoint``, the
dispatch-mode recorders and CUDA-graph captures see a plain module; the
Paddle keywords (``include_sublayers``, ``structured_name_prefix``,
``persistable``, ``blocking``, a dtype by name) are taken on top.
Paddle's own names are added: ``create_parameter`` (``ParamAttr``,
``default_initializer``, ``is_bias``), ``add_parameter``,
``add_sublayer``, ``sublayers``, ``named_sublayers``,
``register_forward_post_hook`` (and the pre-hook) returning a
:class:`HookRemoveHelper`, ``set_state_dict`` / ``load_dict``,
``clear_gradients``, ``astype`` and ``full_name``.

A parameter is allocated on ``device`` (default: cuda; ``device="cpu"``
asks for the CPU) and filled by its initializer
(:mod:`paddle_tpu_torch.nn.initializer`): Xavier-normal for a weight,
zeros for a bias, unless the attribute or ``default_initializer`` names
another. Its Paddle name (``ParamAttr.name``) is its ``param_name``
attribute, which the optimizers read.
"""
from __future__ import annotations

import collections
import itertools

import numpy as np
import torch
from torch import nn

from ...framework.place import resolve_device
from ..initializer import Constant, XavierNormal
from ..param_attr import ParamAttr

__all__ = ["Layer", "HookRemoveHelper", "create_parameter", "to_dtype"]

_NAME_COUNTS = collections.defaultdict(itertools.count)
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


def to_dtype(dtype):
    """A torch dtype for a Paddle dtype name (or a torch dtype)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


def _unique_name(key):
    return f"{key}_{next(_NAME_COUNTS[key])}"


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None, device=None):
    """A trainable ``nn.Parameter`` of ``shape`` (Paddle's
    ``paddle.create_parameter``): Xavier-normal for a weight, zeros for a
    bias, unless ``default_initializer`` or a ``ParamAttr`` gives
    another; the attribute (or a string) names it, and may freeze it."""
    init = default_initializer
    learning_rate = 1.0
    trainable = True
    if attr is not None and attr is not False:
        if isinstance(attr, ParamAttr):
            init = attr.initializer or init
            name = attr.name or name
            learning_rate = attr.learning_rate
            trainable = attr.trainable
        elif isinstance(attr, str):
            name = attr
    if init is None:
        init = Constant(0.0) if is_bias else XavierNormal()
    p = nn.Parameter(torch.empty([int(s) for s in shape],
                                 device=resolve_device(device),
                                 dtype=to_dtype(dtype)),
                     requires_grad=trainable)
    init(p)
    p.param_name = name
    p.optimize_attr = {"learning_rate": learning_rate}
    return p


class HookRemoveHelper:
    """What Paddle's hook registrations return: ``remove()`` takes the
    hook off."""

    def __init__(self, handle):
        self._handle = handle

    def remove(self):
        self._handle.remove()


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._full_name = _unique_name(name_scope
                                       or type(self).__name__.lower())
        self._casted_by_pure_fp16 = False

    # -- parameters ----------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None):
        return create_parameter(shape, dtype or self._dtype, attr=attr,
                                is_bias=is_bias,
                                default_initializer=default_initializer,
                                device=device)

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter,
                                                    nn.Parameter):
            raise TypeError(
                f"parameter must be Parameter, got {type(parameter)}")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistent=True, *,
                        persistable=None):
        if persistable is not None:
            persistent = bool(persistable)
        super().register_buffer(name, tensor, persistent)
        return tensor

    # -- traversal -----------------------------------------------------
    def parameters(self, recurse=True, *, include_sublayers=None):
        if include_sublayers is not None:
            recurse = include_sublayers
        return super().parameters(recurse)

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True, *, include_sublayers=None):
        if include_sublayers is not None:
            recurse = include_sublayers
        return super().named_parameters(prefix, recurse, remove_duplicate)

    def buffers(self, recurse=True, *, include_sublayers=None):
        if include_sublayers is not None:
            recurse = include_sublayers
        return super().buffers(recurse)

    def named_buffers(self, prefix="", recurse=True, remove_duplicate=True,
                      *, include_sublayers=None):
        if include_sublayers is not None:
            recurse = include_sublayers
        return super().named_buffers(prefix, recurse, remove_duplicate)

    def sublayers(self, include_self=False):
        """Every sub-layer, depth first, each once."""
        return [m for _, m in self.named_sublayers(
            include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    # -- hooks ---------------------------------------------------------
    def register_forward_pre_hook(self, hook, *, prepend=False,
                                  with_kwargs=False):
        """``hook(layer, inputs)`` before ``forward``; a result that is not
        None replaces the inputs (a non-tuple as a 1-tuple)."""
        return HookRemoveHelper(super().register_forward_pre_hook(
            hook, prepend=prepend, with_kwargs=with_kwargs))

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after ``forward``; a result
        that is not None replaces the outputs."""
        return HookRemoveHelper(self.register_forward_hook(hook))

    # -- state ---------------------------------------------------------
    def state_dict(self, *args, destination=None, prefix="", keep_vars=False,
                   include_sublayers=True, structured_name_prefix="",
                   use_hook=True):
        """``Module.state_dict``; ``structured_name_prefix`` prefixes the
        keys and ``include_sublayers=False`` keeps this layer's own."""
        prefix = structured_name_prefix or prefix
        if include_sublayers:
            return super().state_dict(*args, destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        dest = collections.OrderedDict() if destination is None \
            else destination
        for name, t in itertools.chain(self._parameters.items(),
                                       self._buffers.items()):
            if t is not None and name not in \
                    self._non_persistent_buffers_set:
                dest[prefix + name] = t if keep_vars else t.detach()
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy the entries whose names this layer has into its tensors
        (in their dtype; tensors or arrays); a shape that disagrees
        raises. Returns ``(missing, unexpected)`` names."""
        own = self.state_dict(keep_vars=True)
        missing = [n for n in own if n not in state_dict]
        unexpected = [n for n in state_dict if n not in own]
        with torch.no_grad():
            for name, target in own.items():
                if name not in state_dict:
                    continue
                value = state_dict[name]
                v = value if isinstance(value, torch.Tensor) \
                    else torch.from_numpy(np.array(value))
                if tuple(v.shape) != tuple(target.shape):
                    raise ValueError(
                        f"shape mismatch for {name}: {tuple(v.shape)} vs "
                        f"{tuple(target.shape)}")
                target.copy_(v.to(target.dtype))
        return missing, unexpected

    load_dict = set_state_dict

    def to(self, *args, **kwargs):
        """``Module.to``; a dtype may be given by name, and Paddle's
        ``blocking`` is taken (and ignored)."""
        kwargs.pop("blocking", None)
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = to_dtype(kwargs["dtype"])
        args = tuple(to_dtype(a) if isinstance(a, str) and a in _DTYPES
                     else a for a in args)
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=to_dtype(dtype))

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def full_name(self):
        return self._full_name
