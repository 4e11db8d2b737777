"""Qwen2-MoE causal LM (counterpart of ``paddle_tpu/models/qwen2_moe.py``),
and the pieces the MoE families share.

A decoder layer is the Llama attention (GQA; Qwen2 adds q/k/v biases)
followed by either a dense SwiGLU MLP or a sparse block: the router
``gate``, routed experts held as stacked ``[e, ...]`` parameters and run
through :mod:`paddle_tpu_torch.distributed.moe` (the K4 grouped matmuls;
``moe_fused_gmm=False`` takes the sorted path through K5's gmm), plus an
always-on shared expert scaled by ``sigmoid(shared_expert_gate(x))``.
``dropless=True`` routes without capacity; the default keeps GShard's
capacity rule (the serving engine refuses such a model).

Parameter names and layouts follow the reference's ``state_dict()``
(``qwen2_moe.layers.{i}.mlp.experts.gate_up_proj [e, d, 2f]``, no
``.weight`` suffix), so :func:`paddle_tpu_torch.convert.load_jax_params`
carries weights across.

The layer, model and causal LM subclass the Llama ones, so the MoE
families keep the port's Llama protocol: the dense forward (logits, or
the criterion plus ``router_aux_loss_coef`` times the summed router aux
losses given ``labels``, trained through ``TrainStep`` or
``loss.backward()`` on both MoE paths), the ragged serving tick
(``fused`` is accepted and ignored: MoE layers run the unfused module
path, as in the reference), and the paged and dense cached paths of
``generate()``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..distributed.moe import (moe_dispatch_combine_dropless,
                               moe_dispatch_combine_grouped)
from ..nn import Linear
from .llama import (_DTYPES, LlamaDecoderLayer, LlamaForCausalLM, LlamaMLP,
                    LlamaModel)

__all__ = ["Qwen2MoeConfig", "StackedExpertsMLP", "Qwen2MoeSparseBlock",
           "Qwen2MoeDecoderLayer", "Qwen2MoeModel", "Qwen2MoeForCausalLM"]


class _MoeConfigMixin:
    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


@dataclass
class Qwen2MoeConfig(_MoeConfigMixin):
    """Defaults: Qwen2-57B-A14B."""
    vocab_size: int = 151936
    hidden_size: int = 3584
    intermediate_size: int = 18944          # dense-layer MLP width
    moe_intermediate_size: int = 2560       # per-expert MLP width
    shared_expert_intermediate_size: int = 20480
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    num_experts: int = 64
    num_experts_per_tok: int = 8
    decoder_sparse_step: int = 1            # every k-th layer is sparse
    norm_topk_prob: bool = False
    router_aux_loss_coef: float = 0.001
    capacity_factor: float = 1.25
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    qkv_bias: bool = True                   # the Qwen2 signature detail
    expert_axis: str = "dp"                 # one shard on one device
    dropless: bool = False                  # no capacity, no dropped pairs
    moe_fused_gmm: bool = True              # False: the sorted K5 path
    recompute: bool = False                 # every layer recomputed
    dtype: str = "float32"

    @staticmethod
    def tiny(vocab=1024, hidden=128, layers=2, heads=4, kv_heads=2,
             moe_ffn=96, shared_ffn=192, experts=8, topk=2):
        return Qwen2MoeConfig(
            vocab_size=vocab, hidden_size=hidden, intermediate_size=shared_ffn,
            moe_intermediate_size=moe_ffn,
            shared_expert_intermediate_size=shared_ffn,
            num_hidden_layers=layers, num_attention_heads=heads,
            num_key_value_heads=kv_heads, num_experts=experts,
            num_experts_per_tok=topk, max_position_embeddings=512)


class StackedExpertsMLP(nn.Module):
    """``num_experts`` SwiGLU experts as stacked parameters:
    ``gate_up_proj [e, d, 2f]`` (gate columns ``[:f]``, up ``[f:]``) and
    ``down_proj [e, f, d]``. The computation lives in
    :mod:`paddle_tpu_torch.distributed.moe`."""

    def __init__(self, num_experts, d_model, d_ffn, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.num_experts = num_experts
        self.gate_up_proj = nn.Parameter(torch.empty(
            num_experts, d_model, 2 * d_ffn, device=device, dtype=dtype))
        self.down_proj = nn.Parameter(torch.empty(
            num_experts, d_ffn, d_model, device=device, dtype=dtype))


def _routed(config, num_experts, x2, logits, experts, return_stats=False):
    """The routed experts' output and router aux loss for ``x2 [s, d]``
    (and the dispatch's stats with ``return_stats``)."""
    kw = dict(normalize_gates=config.norm_topk_prob,
              expert_axis=config.expert_axis, fused=config.moe_fused_gmm,
              return_stats=return_stats)
    args = (x2, logits, num_experts, config.num_experts_per_tok,
            experts.gate_up_proj, experts.down_proj)
    if config.dropless:
        return moe_dispatch_combine_dropless(*args, **kw)
    return moe_dispatch_combine_grouped(
        *args, capacity_factor=config.capacity_factor, **kw)


class Qwen2MoeSparseBlock(nn.Module):
    """Router + stacked routed experts + the gated shared expert. With
    ``_collect_stats`` set (by
    :meth:`Qwen2MoeForCausalLM.collect_drop_rates`), a forward keeps the
    dispatch's capacity drop rate in ``drop_rate`` (a device scalar)."""
    _collect_stats = False
    drop_rate = None

    def __init__(self, config: Qwen2MoeConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        mk = dict(device=device, dtype=dtype)
        d = config.hidden_size
        self.gate = Linear(d, config.num_experts, bias_attr=False, **mk)
        self.experts = StackedExpertsMLP(
            config.num_experts, d, config.moe_intermediate_size, **mk)
        self.shared_expert = LlamaMLP(
            config, device, dtype, ffn=config.shared_expert_intermediate_size)
        self.shared_expert_gate = Linear(d, 1, bias_attr=False, **mk)

    def forward(self, x):
        """``(out, aux)`` for ``x [..., d]``."""
        x2 = x.reshape(-1, x.shape[-1])
        routed = _routed(self.config, self.config.num_experts, x2,
                         self.gate(x2), self.experts,
                         return_stats=self._collect_stats)
        y, aux = routed[:2]
        if self._collect_stats:
            self.drop_rate = routed[2]["drop_rate"]
        out = y + self.shared_expert(x2) * torch.sigmoid(
            self.shared_expert_gate(x2))
        return out.reshape(x.shape), aux


class Qwen2MoeDecoderLayer(LlamaDecoderLayer):
    """Llama attention + a sparse block every ``decoder_sparse_step``
    layers (else the dense MLP); the serving tick runs the module path."""
    fused_decode = False

    def make_mlp(self, config, layer_idx, device, dtype):
        if config.num_experts > 0 \
                and (layer_idx + 1) % config.decoder_sparse_step == 0:
            return Qwen2MoeSparseBlock(config, device, dtype)
        return super().make_mlp(config, layer_idx, device, dtype)


class Qwen2MoeModel(LlamaModel):
    layer_cls = Qwen2MoeDecoderLayer


class Qwen2MoeForCausalLM(LlamaForCausalLM):
    """:class:`paddle_tpu_torch.models.llama.LlamaForCausalLM` with the
    Qwen2-MoE layers; given ``labels`` the loss adds
    ``router_aux_loss_coef`` times the summed router aux losses."""
    base_prefix = "qwen2_moe"
    model_cls = Qwen2MoeModel

    def collect_drop_rates(self, input_ids):
        """The expert-capacity drop rate of each sparse block over one
        eager forward of ``input_ids`` in ``eval()`` under ``no_grad``:
        a list of floats, one per sparse block (0 for a dropless
        model)."""
        blocks = [lay.mlp for lay in self.base.layers
                  if isinstance(lay.mlp, Qwen2MoeSparseBlock)]
        was_training = self.training
        self.eval()
        for b in blocks:
            b._collect_stats = True
        try:
            with torch.no_grad():
                self(torch.as_tensor(input_ids, device=self.device))
        finally:
            for b in blocks:
                b._collect_stats = False
            self.train(was_training)
        rates = [float(b.drop_rate) for b in blocks]
        for b in blocks:
            b.drop_rate = None
        return rates
