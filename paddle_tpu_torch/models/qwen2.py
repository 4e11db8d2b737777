"""Dense Qwen2 causal LM (counterpart of ``paddle_tpu/models/qwen2.py``).

Qwen2 is the Llama decoder with three deltas: a bias on the q/k/v
projections (``qkv_bias=True``), a larger rope theta (1e6), and tied
embeddings on the small checkpoints. As in the reference, the deltas are
config over the shared Llama bodies: the dense training forward, the
ragged serving tick (its fused decode path carries the q/k/v biases in
K3a's epilogue, ``ops/kernels/decode_fused.py``), and the paged and dense
cached paths of ``generate()``. Parameter names follow the reference's
``state_dict()``, which keeps Llama's prefix
(``llama.layers.{i}.self_attn.q_proj.bias`` ...), so weights move across
with :func:`paddle_tpu_torch.convert.load_jax_params`. The
pipeline-parallel ``Qwen2ForCausalLMPipe`` comes with the distributed
slice.
"""
from __future__ import annotations

from dataclasses import dataclass

from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaPretrainingCriterion)

__all__ = ["Qwen2Config", "Qwen2Model", "Qwen2ForCausalLM",
           "Qwen2PretrainingCriterion"]


@dataclass
class Qwen2Config(LlamaConfig):
    """Defaults: Qwen2-7B (PaddleNLP's qwen2 config defaults)."""
    vocab_size: int = 151936
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    max_position_embeddings: int = 32768
    rope_theta: float = 1e6
    qkv_bias: bool = True

    @staticmethod
    def tiny(vocab=1024, hidden=256, layers=2, heads=8, kv_heads=4,
             ffn=512):
        return Qwen2Config(
            vocab_size=vocab, hidden_size=hidden, intermediate_size=ffn,
            num_hidden_layers=layers, num_attention_heads=heads,
            num_key_value_heads=kv_heads, max_position_embeddings=2048)


class Qwen2Model(LlamaModel):
    """The decoder stack on the Llama body."""


Qwen2PretrainingCriterion = LlamaPretrainingCriterion


class Qwen2ForCausalLM(LlamaForCausalLM):
    """The causal-LM head over :class:`Qwen2Model`; the config carries the
    deltas. Its base model sits under ``llama``, as in the reference."""
    model_cls = Qwen2Model
