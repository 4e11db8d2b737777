from . import flash_attention, kernels, lora, paged_attention, paged_cache

__all__ = ["flash_attention", "kernels", "lora", "paged_attention",
           "paged_cache"]
