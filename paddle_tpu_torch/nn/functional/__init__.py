from . import flash_attention
from .activation import gelu
from .common import dropout
from .flash_attention import flashmask_attention, scaled_dot_product_attention
from .norm import layer_norm, rms_norm

__all__ = ["dropout", "flash_attention", "flashmask_attention", "gelu",
           "layer_norm", "rms_norm", "scaled_dot_product_attention"]
