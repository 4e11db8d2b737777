from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel)
from .deepseek_moe import (DeepseekMoeConfig, DeepseekMoeForCausalLM,
                           deepseek_moe_16b)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion)
from .llama import LlamaConfig, LlamaForCausalLM
from .qwen2 import (Qwen2Config, Qwen2ForCausalLM, Qwen2Model,
                    Qwen2PretrainingCriterion)
from .qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM", "Qwen2Config", "Qwen2Model",
           "Qwen2ForCausalLM", "Qwen2PretrainingCriterion", "Qwen2MoeConfig",
           "Qwen2MoeForCausalLM", "DeepseekMoeConfig",
           "DeepseekMoeForCausalLM", "deepseek_moe_16b", "GPTConfig",
           "GPTModel", "GPTForCausalLM", "GPTPretrainingCriterion",
           "BertConfig", "BertModel", "BertForSequenceClassification",
           "BertForPretraining"]
