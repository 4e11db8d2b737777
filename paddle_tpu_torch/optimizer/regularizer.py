"""Weight-decay regularizers (counterpart of
``paddle_tpu/optimizer/regularizer.py``): an optimizer's
``weight_decay=`` folds one into each gradient before the update rule."""
from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def _append(self, p, g):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    """``g + coeff * p``."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def _append(self, p, g):
        return g + self.coeff * p.to(g.dtype)

    def __repr__(self):
        return f"L2Decay({self.coeff})"


class L1Decay(WeightDecayRegularizer):
    """``g + coeff * sign(p)``."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def _append(self, p, g):
        return g + self.coeff * torch.sign(p).to(g.dtype)

    def __repr__(self):
        return f"L1Decay({self.coeff})"
