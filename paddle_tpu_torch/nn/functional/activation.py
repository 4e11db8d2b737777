"""Activation functions (counterpart of ``paddle_tpu/nn/functional/
activation.py``): the ones the ported models run."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gelu"]


def gelu(x: torch.Tensor, approximate: bool = False):
    """GELU: ``x * Phi(x)`` by the error function, or with
    ``approximate=True`` the tanh form ``0.5 x (1 + tanh(sqrt(2 / pi)
    (x + 0.044715 x^3)))`` (``jax.nn.gelu``'s two modes; GPT's MLP runs
    the tanh form, which K3b's ``act="gelu_tanh"`` fuses)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")
