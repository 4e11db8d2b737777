from . import lr
from .optimizer import Adam, AdamW, L2Decay, Optimizer

__all__ = ["lr", "Adam", "AdamW", "L2Decay", "Optimizer"]
