from . import flash_attention
from .common import dropout
from .flash_attention import flashmask_attention, scaled_dot_product_attention
from .norm import rms_norm

__all__ = ["dropout", "flash_attention", "flashmask_attention", "rms_norm",
           "scaled_dot_product_attention"]
