"""``paddle.regularizer`` namespace (counterpart of
``paddle_tpu/regularizer.py``): the weight-decay regularizers the
optimizers take as ``weight_decay=``."""
from .optimizer.regularizer import (L1Decay, L2Decay,  # noqa: F401
                                    WeightDecayRegularizer)

__all__ = ["L1Decay", "L2Decay", "WeightDecayRegularizer"]
