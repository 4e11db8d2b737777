from . import functional
from .clip import ClipGradByGlobalNorm
from .layer import Embedding, Linear, RMSNorm

__all__ = ["functional", "ClipGradByGlobalNorm", "Embedding", "Linear",
           "RMSNorm"]
