"""The few layers the Llama serving path needs, in Paddle's parameter
layout (counterparts of ``paddle_tpu/nn/layer/common.py`` and
``norm.py``): ``Linear.weight`` is ``[in, out]`` and the forward is
``x @ weight`` (plus the ``[out]`` bias where there is one), so a ``state_dict`` moves between the two
packages without transposes. Parameters are allocated uninitialised on
the given device and are trainable; the model that owns them initialises
them from an explicit generator."""
from __future__ import annotations

import torch
from torch import nn

from .functional import rms_norm

__all__ = ["Linear", "Embedding", "RMSNorm"]


class Linear(nn.Module):
    """``x @ weight (+ bias)``; ``bias=True`` adds Paddle's ``[out]``
    bias (Qwen2's q/k/v), the default is bias-free (every projection of
    Llama)."""

    def __init__(self, in_features, out_features, device=None,
                 dtype=torch.float32, bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(
            out_features, device=device, dtype=dtype)) if bias else None

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, ids):
        return self.weight[ids]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self._epsilon)
