from . import functional
from .clip import ClipGradByGlobalNorm
from .layer import Dropout, Embedding, LayerNorm, Linear, RMSNorm

__all__ = ["functional", "ClipGradByGlobalNorm", "Dropout", "Embedding",
           "LayerNorm", "Linear", "RMSNorm"]
