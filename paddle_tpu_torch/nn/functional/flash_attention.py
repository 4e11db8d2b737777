"""``paddle.nn.functional.flash_attention`` (the reference exposes
``paddle_tpu/ops/pallas/flash_attention.py`` under this name): the
attention entry points of ``ops/flash_attention.py``."""
from ...ops.flash_attention import (flash_attention, flash_attention_core,
                                    flashmask_attention, mask_to_bias,
                                    scaled_dot_product_attention)

__all__ = ["flash_attention", "flash_attention_core", "flashmask_attention",
           "mask_to_bias", "scaled_dot_product_attention"]
