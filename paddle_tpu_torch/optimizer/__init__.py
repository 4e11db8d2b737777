from . import lr
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        LBFGS, Momentum, NAdam, Optimizer, RAdam, RMSProp)
from .regularizer import L1Decay, L2Decay

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adagrad", "Adam",
           "AdamW", "Adamax", "RMSProp", "Adadelta", "Lamb", "NAdam",
           "RAdam", "LBFGS", "L1Decay", "L2Decay"]
