"""The few layers the ported models need, in Paddle's parameter
layout (counterparts of ``paddle_tpu/nn/layer/common.py`` and
``norm.py``): ``Linear.weight`` is ``[in, out]`` and the forward is
``x @ weight`` (plus the ``[out]`` bias where there is one), so a ``state_dict`` moves between the two
packages without transposes. Parameters are allocated uninitialised (a
norm's: ones, and zeros for LayerNorm's bias) on the given device
(default: cuda; ``device="cpu"`` asks for the CPU) and are trainable;
the model that owns them initialises them from an explicit
generator. ``Linear.forward`` ends in the multi-LoRA hook
(:func:`paddle_tpu_torch.ops.lora.apply`, the reference's call at the end
of its ``mp_layers`` forwards), a no-op unless the module is tagged and a
serving tick's scope is active."""
from __future__ import annotations

import torch
from torch import nn

from ..framework.place import resolve_device
from ..ops import lora as _lora
from .functional import dropout, layer_norm, rms_norm

__all__ = ["Linear", "Embedding", "RMSNorm", "LayerNorm", "Dropout"]


class Linear(nn.Module):
    """``x @ weight (+ bias)``; ``bias=True`` adds Paddle's ``[out]``
    bias (Qwen2's q/k/v), the default is bias-free (every projection of
    Llama)."""

    def __init__(self, in_features, out_features, device=None,
                 dtype=torch.float32, bias=False):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(
            out_features, device=device, dtype=dtype)) if bias else None

    def forward(self, x):
        y = x @ self.weight
        if self.bias is not None:
            y = y + self.bias
        return _lora.apply(self, x, y)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=resolve_device(device),
            dtype=dtype))

    def forward(self, ids):
        return self.weight[ids]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=resolve_device(device), dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self._epsilon)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes, with a
    ``weight`` (ones) and a ``bias`` (zeros) of that shape. The
    ``_epsilon`` attribute is the reference's name (the fused decode
    tick reads it)."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        shape = [normalized_shape] if isinstance(normalized_shape, int) \
            else list(normalized_shape)
        self._normalized_shape = shape
        self._epsilon = float(epsilon)
        mk = dict(device=resolve_device(device), dtype=dtype)
        self.weight = nn.Parameter(torch.ones(shape, **mk))
        self.bias = nn.Parameter(torch.zeros(shape, **mk))

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)


class Dropout(nn.Module):
    """Dropout of probability ``p`` while the module is in training mode
    (``nn.functional.dropout``: ``axis`` and ``mode`` as Paddle's); the
    identity in ``eval()``. The mask comes from ``generator`` when one is
    given, else from the default stream of the input's device
    (``framework.random``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 generator=None):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return dropout(x, self.p, axis=self.axis, training=self.training,
                       mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"
