"""Carry weights from the JAX package's models into the port.

``params_from_jax`` takes ``{name: numpy array}`` — what the reference
model's ``state_dict()`` holds, converted with ``np.asarray`` by the
caller — and returns torch tensors under the same names. Both packages
keep Paddle's layouts (``Linear.weight`` is ``[in, out]``) and the
reference's parameter names for every ported model (Llama, Qwen2, the
MoE families, and GPT's LayerNorm weights and biases, projection biases
and learned position table), so nothing is renamed or transposed. ``pool_from_jax`` carries one half of a reference paged KV
pool (a floating array, or a ``QuantKV`` of int8 data and float32
scales) into the port's layout, which is the same.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework.place import resolve_device
from .ops.paged_cache import QuantKV

__all__ = ["params_from_jax", "load_jax_params", "pool_from_jax"]


def params_from_jax(named_numpy: dict, device=None, dtype=None) -> dict:
    """``{name: np.ndarray}`` -> ``{name: torch.Tensor}`` on ``device``
    (default: cuda), keeping each array's dtype unless ``dtype`` is
    given."""
    dev = resolve_device(device)
    out = {}
    for name, arr in named_numpy.items():
        t = torch.from_numpy(np.array(arr, copy=True))
        if dtype is not None:
            t = t.to(dtype)
        out[name] = t.to(dev)
    return out


def load_jax_params(model, named_numpy: dict) -> dict:
    """Load reference weights into a port model in place: every parameter
    must be given; a persistent buffer (a batch norm's ``_mean`` /
    ``_variance``) is carried when given, as the reference's
    ``state_dict()`` holds it; no other name may be given, and every
    shape must agree. Returns the converted dict."""
    params = dict(model.named_parameters())
    own = dict(params)
    own.update((k, v) for k, v in model.state_dict(keep_vars=True).items()
               if k in named_numpy and k not in params)
    missing = sorted(set(params) - set(named_numpy))
    extra = sorted(set(named_numpy) - set(own))
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    if not own:
        return {}
    device = getattr(model, "device", None) or next(
        iter(own.values())).device
    sd = params_from_jax(named_numpy, device=device)
    with torch.no_grad():
        for name, p in own.items():
            t = sd[name]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} from the "
                                 f"reference, {tuple(p.shape)} in the port")
            p.copy_(t.to(p.dtype))
    return sd


def pool_from_jax(pool, device=None):
    """One pool half of the reference: an array (anything
    ``np.asarray`` takes) -> a tensor of its dtype, or a ``QuantKV``
    (anything with ``data`` and ``scale``) -> the port's
    :class:`~paddle_tpu_torch.ops.paged_cache.QuantKV`, on ``device``
    (default: cuda)."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev)  # noqa
    if hasattr(pool, "scale"):
        return QuantKV(t(pool.data), t(pool.scale))
    return t(pool)
