"""DeepSeek-MoE causal LM (counterpart of
``paddle_tpu/models/deepseek_moe.py``).

Against Qwen2-MoE: the first ``first_k_dense_replace`` layers use a
dense MLP; sparse layers add ``n_shared_experts`` always-on shared
experts (one dense MLP of ``n_shared_experts * moe_intermediate_size``)
to the routed output ungated; attention is plain multi-head (no q/k/v
bias). The stacked experts and the dispatch are those of
:mod:`paddle_tpu_torch.models.qwen2_moe`; the layer, model and causal LM
subclass the Llama ones.
Parameter names follow the reference's ``state_dict()``
(``deepseek.layers.{i}.mlp.shared_experts.gate_proj.weight``, ...).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..nn import Linear
from .llama import LlamaDecoderLayer, LlamaForCausalLM, LlamaMLP, LlamaModel
from .qwen2_moe import (Qwen2MoeForCausalLM, StackedExpertsMLP,
                        _MoeConfigMixin, _routed)

__all__ = ["DeepseekMoeConfig", "DeepseekMoeBlock",
           "DeepseekMoeDecoderLayer", "DeepseekMoeModel",
           "DeepseekMoeForCausalLM", "deepseek_moe_16b"]


@dataclass
class DeepseekMoeConfig(_MoeConfigMixin):
    """Defaults: deepseek-moe-16b (16.38 B parameters)."""
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944          # dense-layer MLP width
    moe_intermediate_size: int = 1408       # fine-grained expert width
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    norm_topk_prob: bool = False
    router_aux_loss_coef: float = 0.001
    capacity_factor: float = 1.25
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    qkv_bias: bool = False                  # DeepSeek attention: no bias
    expert_axis: str = "dp"                 # one shard on one device
    dropless: bool = False                  # no capacity, no dropped pairs
    moe_fused_gmm: bool = True              # False: the sorted K5 path
    recompute: bool = False                 # every layer recomputed
    dtype: str = "float32"

    @staticmethod
    def tiny(vocab=1024, hidden=128, layers=3, heads=4, kv_heads=4,
             moe_ffn=64, dense_ffn=192, experts=8, shared=2, topk=2):
        return DeepseekMoeConfig(
            vocab_size=vocab, hidden_size=hidden,
            intermediate_size=dense_ffn, moe_intermediate_size=moe_ffn,
            num_hidden_layers=layers, num_attention_heads=heads,
            num_key_value_heads=kv_heads, n_routed_experts=experts,
            n_shared_experts=shared, num_experts_per_tok=topk,
            max_position_embeddings=512)


def deepseek_moe_16b(**overrides) -> DeepseekMoeConfig:
    """deepseek-moe-16b in bfloat16 (the config's defaults); keyword
    overrides (``num_hidden_layers``, ``dropless``, ...) apply on top."""
    return DeepseekMoeConfig(**{"dtype": "bfloat16", **overrides})


class DeepseekMoeBlock(nn.Module):
    """Routed fine-grained experts + ungated shared experts."""

    def __init__(self, config: DeepseekMoeConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        mk = dict(device=device, dtype=dtype)
        d = config.hidden_size
        self.gate = Linear(d, config.n_routed_experts, bias_attr=False,
                           **mk)
        self.experts = StackedExpertsMLP(
            config.n_routed_experts, d, config.moe_intermediate_size, **mk)
        self.shared_experts = LlamaMLP(
            config, device, dtype,
            ffn=config.n_shared_experts * config.moe_intermediate_size)

    def forward(self, x):
        """``(out, aux)`` for ``x [..., d]``."""
        x2 = x.reshape(-1, x.shape[-1])
        y, aux = _routed(self.config, self.config.n_routed_experts, x2,
                         self.gate(x2), self.experts)
        return (y + self.shared_experts(x2)).reshape(x.shape), aux


class DeepseekMoeDecoderLayer(LlamaDecoderLayer):
    """Llama attention + the dense MLP below ``first_k_dense_replace``,
    a sparse block every ``moe_layer_freq`` layers above it; the serving
    tick runs the module path."""
    fused_decode = False

    def make_mlp(self, config, layer_idx, device, dtype):
        if layer_idx >= config.first_k_dense_replace \
                and layer_idx % config.moe_layer_freq == 0:
            return DeepseekMoeBlock(config, device, dtype)
        return super().make_mlp(config, layer_idx, device, dtype)


class DeepseekMoeModel(LlamaModel):
    layer_cls = DeepseekMoeDecoderLayer


class DeepseekMoeForCausalLM(LlamaForCausalLM):
    __doc__ = Qwen2MoeForCausalLM.__doc__.replace("Qwen2-MoE", "DeepSeek-MoE")
    base_prefix = "deepseek"
    model_cls = DeepseekMoeModel
