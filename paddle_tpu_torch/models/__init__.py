from .deepseek_moe import (DeepseekMoeConfig, DeepseekMoeForCausalLM,
                           deepseek_moe_16b)
from .llama import LlamaConfig, LlamaForCausalLM
from .qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM", "Qwen2MoeConfig",
           "Qwen2MoeForCausalLM", "DeepseekMoeConfig",
           "DeepseekMoeForCausalLM", "deepseek_moe_16b"]
