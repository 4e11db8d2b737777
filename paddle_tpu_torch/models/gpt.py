"""GPT causal LM (counterpart of ``paddle_tpu/models/gpt.py``, PaddleNLP's
GPT): learned positions, pre-LayerNorm decoder layers with one fused
q/k/v projection and a tanh-gelu MLP, and an LM head tied to the token
embedding.

Parameter names and layouts follow the reference's ``state_dict()``
(``gpt.h.{i}.attn.qkv_proj.weight`` ``[in, out]``, ``gpt.h.{i}.ln_1.bias``,
``gpt.position_embeddings.weight`` ...), so weights move across with
:func:`paddle_tpu_torch.convert.load_jax_params`. The projections are the
degree-1 tensor-parallel layers of ``distributed/fleet/mp_layers.py``; the
reference's sharding annotations (``batch_shard`` / ``constraint``) have
no counterpart on one device.

``forward`` keeps the reference's keyword signature, which has no
``attention_mask`` or ``position_ids`` (so ``generate()`` does not
left-pad GPT's prompts into buckets). With ``caches`` None it is the
dense path over ``input_ids [B, L]``: token + position embeddings,
dropout, decoder layers (LayerNorm, q/k/v, causal flash attention
through the K1 kernels, output projection, dropout + residual,
LayerNorm, tanh-gelu MLP, dropout + residual), the final LayerNorm and
the tied head ``h @ embeddings.weight^T``; given ``labels`` it returns
the :class:`GPTPretrainingCriterion` loss. Dropout (``hidden_dropout_prob``)
is live in ``train()``; the reference keeps
``attention_probs_dropout_prob`` but never applies it, and neither does
the port. With ``caches`` it runs one of three decode paths, positions
as the reference's:

- ragged (``ragged_meta`` given): ONE packed row buffer ``[R]`` a
  serving tick, each row at its own position (clipped to
  ``max_position_embeddings - 1``); each decoder layer runs the fused
  decode tick (LayerNorm -> q/k/v and LayerNorm -> MLP-in through K3a's
  ``kind="ln"``; output projection + residual and tanh-gelu -> MLP-out
  + residual through K3b; attention through K2r) or the unfused module
  path, bitwise equal on the CPU;
- paged (``block_tables`` given): ``input_ids [S, T]`` at positions
  ``cache_lens + t``, written into the pools and attended through K2d
  (T = 1) or K2v (T > 1);
- dense cached (neither): ``input_ids [B, L]`` at ``offset + t`` into
  the static ``[B, S_max, H, D]`` caches, attended by
  :func:`~paddle_tpu_torch.models.llama.cached_attention`.

The caches are float32 whatever the model's dtype, as the reference's
(``init_caches`` / ``init_paged_caches``), or int8 ``QuantKV`` pools: a
bfloat16 GPT (``model.to(torch.bfloat16)``, the reference's
``Layer.bfloat16()``) attends with a bfloat16 query over float32 pools,
the K2 kernels' ``*_f32pool`` mode.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..distributed.fleet.mp_layers import (ColumnParallelLinear,
                                           RowParallelLinear,
                                           VocabParallelEmbedding)
from ..framework.place import resolve_device
from ..framework.random import generator as make_generator
from ..generation import GenerationMixin
from ..nn import Dropout, Embedding, LayerNorm
from ..nn.functional import gelu
from ..nn.initializer import owner_initializes
from ..ops import lora as _lora
from ..ops import paged_attention as _pa
from ..ops import paged_cache as _pc
from ..ops.flash_attention import flash_attention_core
from ..ops.kernels import decode_fused as _df
from .llama import cached_attention

__all__ = ["GPTConfig", "GPTAttention", "GPTDecoderLayer", "GPTModel",
           "GPTForCausalLM", "GPTPretrainingCriterion"]


@dataclass
class GPTConfig:
    """Defaults: the reference's (GPT-2 medium widths: 24 layers, hidden
    1024, 16 heads of 64, ffn 4096, 1024 positions)."""
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02

    @staticmethod
    def tiny(vocab=1024, hidden=128, layers=2, heads=4):
        return GPTConfig(vocab_size=vocab, hidden_size=hidden,
                         num_hidden_layers=layers, num_attention_heads=heads,
                         intermediate_size=hidden * 4,
                         max_position_embeddings=512)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class GPTAttention(nn.Module):
    """Multi-head attention over one fused q/k/v projection: dense causal
    (training), ragged paged (serving), paged or dense cached
    (``generate()``)."""

    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        h = config.hidden_size
        mk = dict(device=device, dtype=dtype)
        self.qkv_proj = ColumnParallelLinear(h, 3 * h, gather_output=False,
                                             **mk)
        self.out_proj = RowParallelLinear(h, h, input_is_parallel=True,
                                          **mk)
        # kept as the reference keeps it, and never applied (as there)
        self.dropout_p = config.attention_probs_dropout_prob

    def _heads(self, qkv):
        """``[..., 3 * hidden]`` -> q, k, v ``[..., H, D]`` (q contiguous,
        as the attention kernels take it)."""
        shape = qkv.shape[:-1] + (self.num_heads, self.head_dim)
        q, k, v = qkv.chunk(3, dim=-1)
        return q.reshape(shape).contiguous(), k.reshape(shape), \
            v.reshape(shape)

    def attend(self, qkv, kv_cache, offset=None, block_tables=None,
               cache_lens=None, ragged_meta=None):
        """The cache paths' write + attend, without the output projection
        (the fused decode tick runs it in K3b's epilogue): ragged
        (``qkv [R, 3h]``), paged (``[S, T, 3h]``) or dense cached (``[B,
        L, 3h]`` at ``offset``). Returns ``(ctx [..., hidden], (k, v))``."""
        qh, kh, vh = self._heads(qkv)
        lead = qkv.shape[:-1]
        scale = 1.0 / math.sqrt(self.head_dim)
        if ragged_meta is not None:
            q_lens, row_starts, row_slot, row_pos, w_max = ragged_meta
            out, kp, vp = _pa.ragged_attention_step(
                qh, kh, vh, kv_cache[0], kv_cache[1], block_tables,
                cache_lens, q_lens, row_starts, row_slot, row_pos, w_max,
                sm_scale=scale)
        elif block_tables is not None:
            out, kp, vp = _pa.paged_attention_step(
                qh, kh, vh, kv_cache[0], kv_cache[1], block_tables,
                cache_lens, sm_scale=scale)
        else:
            out, kp, vp = cached_attention(qh, kh, vh, kv_cache[0],
                                           kv_cache[1], offset,
                                           self.head_dim)
        return out.reshape(*lead, -1), (kp, vp)

    def forward(self, x, kv_cache=None, offset=None, block_tables=None,
                cache_lens=None, ragged_meta=None):
        qkv = self.qkv_proj(x)
        if kv_cache is None:                    # dense: [B, L, hidden]
            b, l, _ = x.shape
            qh, kh, vh = self._heads(qkv)
            out = flash_attention_core(qh, kh, vh, is_causal=True)
            return self.out_proj(out.reshape(b, l, -1))
        ctx, cache = self.attend(qkv, kv_cache, offset, block_tables,
                                 cache_lens, ragged_meta)
        return self.out_proj(ctx), cache


class GPTDecoderLayer(nn.Module):
    """Pre-LayerNorm attention and tanh-gelu MLP, each behind dropout and
    a residual."""

    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        mk = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(h, eps, **mk)
        self.attn = GPTAttention(config, **mk)
        self.ln_2 = LayerNorm(h, eps, **mk)
        self.linear1 = ColumnParallelLinear(h, config.intermediate_size,
                                            gather_output=False, **mk)
        self.linear2 = RowParallelLinear(config.intermediate_size, h,
                                         input_is_parallel=True, **mk)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def _fused_decode_eligible(self):
        """The reference's gate: eval mode (the fused epilogues skip the
        inert eval dropout) and every weight a floating tensor."""
        return not self.training and all(
            p.is_floating_point() for p in self.parameters())

    def forward_decode_fused(self, x, kv_cache, block_tables, cache_lens,
                             ragged_meta):
        """The reference's ``_forward_decode_fused``: LayerNorm fused into
        the q/k/v projection (K3a ``kind="ln"``, its bias in the
        epilogue), the output projection + residual (K3b), LayerNorm into
        the first MLP linear (K3a) and tanh-gelu into the second + residual
        (K3b ``act="gelu_tanh"``); attention through K2r (ragged rows) or
        K2d / K2v (paged windows, inside the engine's
        ``paged_fused_scope``). Under multi-LoRA
        serving it composes per module, as Llama's layer does: an armed
        qkv_proj or linear1 adds its delta off the LayerNorm recomputed,
        an armed out_proj or linear2 runs the module call and the
        residual instead of K3b (eval dropout is inert)."""
        attn = self.attn
        (qkv,) = _df.norm_matmul(x, self.ln_1.weight, self.ln_1.bias,
                                 [attn.qkv_proj.weight],
                                 [attn.qkv_proj.bias],
                                 eps=self.ln_1._epsilon, kind="ln")
        if _lora.armed(attn.qkv_proj):
            qkv = _lora.apply(attn.qkv_proj, self.ln_1(x), qkv)
        ctx, cache = attn.attend(qkv, kv_cache, None, block_tables,
                                 cache_lens, ragged_meta)
        if _lora.armed(attn.out_proj):
            x2 = x + attn.out_proj(ctx)
        else:
            x2 = _df.matmul_residual([ctx], attn.out_proj.weight,
                                     attn.out_proj.bias, x)
        (g,) = _df.norm_matmul(x2, self.ln_2.weight, self.ln_2.bias,
                               [self.linear1.weight], [self.linear1.bias],
                               eps=self.ln_2._epsilon, kind="ln")
        if _lora.armed(self.linear1):
            g = _lora.apply(self.linear1, self.ln_2(x2), g)
        if _lora.armed(self.linear2):
            out = x2 + self.linear2(gelu(g, approximate=True))
        else:
            out = _df.matmul_residual([g], self.linear2.weight,
                                      self.linear2.bias, x2,
                                      act="gelu_tanh")
        return out, cache

    def forward(self, x, kv_cache=None, offset=None, block_tables=None,
                cache_lens=None, ragged_meta=None, fused=True):
        """Dense (``kv_cache`` None): ``h``; cached: ``(h, cache)``."""
        if kv_cache is not None and fused and (
                ragged_meta is not None or (block_tables is not None
                                            and _df.paged_fused_armed())) \
                and self._fused_decode_eligible():
            return self.forward_decode_fused(x, kv_cache, block_tables,
                                             cache_lens, ragged_meta)
        cache = None
        if kv_cache is not None:
            a, cache = self.attn(self.ln_1(x), kv_cache, offset,
                                 block_tables=block_tables,
                                 cache_lens=cache_lens,
                                 ragged_meta=ragged_meta)
        else:
            a = self.attn(self.ln_1(x))
        x = x + self.dropout(a)
        h = self.linear2(gelu(self.linear1(self.ln_2(x)), approximate=True))
        out = x + self.dropout(h)
        return out if kv_cache is None else (out, cache)


class GPTModel(nn.Module):
    """Token and learned position embeddings, the decoder layers and the
    final LayerNorm. Dense: ``h``; cached: ``(h, new_caches)``."""

    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.config = config
        mk = dict(device=device, dtype=dtype)
        self.embeddings = VocabParallelEmbedding(config.vocab_size,
                                                 config.hidden_size, **mk)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, **mk)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.h = nn.ModuleList([GPTDecoderLayer(config, **mk)
                                for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                              **mk)

    def _positions(self, ids, offset, cache_lens, ragged_meta):
        """The reference's three rules: ragged rows at their own positions
        (clipped to the last learned one), paged windows at ``cache_lens +
        t``, otherwise ``arange(L) + offset``."""
        dev = ids.device
        if ragged_meta is not None:
            return torch.clamp(ragged_meta[3].long(), 0,
                               self.config.max_position_embeddings - 1)
        l = ids.shape[-1]
        if cache_lens is not None:
            # clipped to the last learned position: a short final prefill
            # chunk's pad rows may run past it (their output is never read)
            return torch.clamp(
                cache_lens.long()[:, None] + torch.arange(l, device=dev), 0,
                self.config.max_position_embeddings - 1)
        return torch.arange(l, device=dev) + (0 if offset is None
                                              else int(offset))

    def forward(self, input_ids, caches=None, offset=None, block_tables=None,
                cache_lens=None, ragged_meta=None, fused=True):
        ids = input_ids.long()
        if ragged_meta is not None:     # one packed row buffer [R]
            ids = ids.reshape(-1)
        pos = self._positions(ids, offset, cache_lens, ragged_meta)
        h = self.dropout(self.embeddings(ids) + self.position_embeddings(pos))
        if caches is None:
            for layer in self.h:
                h = layer(h)
            return self.ln_f(h)
        new_caches = []
        for layer, kv in zip(self.h, caches):
            h, kv2 = layer(h, kv, offset, block_tables, cache_lens,
                           ragged_meta, fused=fused)
            new_caches.append(kv2)
        return self.ln_f(h), new_caches


class GPTPretrainingCriterion(nn.Module):
    """Cross entropy over pre-shifted labels (``labels[t]`` targets
    ``logits[t]``), the reference's recipe: log-softmax in float32, the
    mean over every token (no ignore index)."""

    def forward(self, logits, labels):
        logp = torch.log_softmax(logits.float(), dim=-1)
        picked = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        return -picked.mean()


class GPTForCausalLM(nn.Module, GenerationMixin):
    """``forward(input_ids, labels=None, caches=None, offset=None,
    block_tables=None, cache_lens=None, ragged_meta=None, last_rows=None,
    fused=True, return_hidden=False)``, the cache protocol of
    :class:`~paddle_tpu_torch.models.llama.LlamaForCausalLM`: dense
    (``caches`` None) -> logits ``[B, L, V]`` or, with ``labels``, the
    loss; ragged serving (``ragged_meta = (q_lens, row_starts, row_slot,
    row_pos, w_max)`` over ``input_ids [R]``, ``last_rows`` restricting
    the head), paged (``input_ids [S, T]``) and dense cached (at the host
    int ``offset``) -> ``(logits, caches)``, the caches updated in place;
    ``return_hidden`` makes the logits ``(logits, final hidden state)``.

    Built on ``device`` (default: cuda; ``"cpu"`` runs the plain versions
    of the kernels) in float32, with weights drawn from ``generator`` (or
    a generator seeded with ``seed``) as PaddleNLP's GPT initialises
    them: normal(0, initializer_range) for the projections and both
    embeddings, LayerNorm weights one, every bias zero. ``.to(
    torch.bfloat16)`` makes a bfloat16 model; its caches stay float32."""

    def __init__(self, config: GPTConfig, device=None, seed=0,
                 generator=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        with owner_initializes():     # _init_weights draws the weights
            self.gpt = GPTModel(config, dev)
        self.criterion = GPTPretrainingCriterion()
        self._init_weights(generator if generator is not None
                           else make_generator(seed, dev))

    @property
    def device(self) -> torch.device:
        return self.gpt.embeddings.weight.device

    @torch.no_grad()
    def _init_weights(self, generator):
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln_" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)

    def forward(self, input_ids, labels=None, caches=None, offset=None,
                block_tables=None, cache_lens=None, ragged_meta=None,
                last_rows=None, fused=True, return_hidden=False):
        head = self.gpt.embeddings.weight
        if caches is None:
            logits = torch.matmul(self.gpt(input_ids), head.t())
            if labels is not None:
                return self.criterion(logits, labels)
            return logits
        h, new_caches = self.gpt(input_ids, caches=caches, offset=offset,
                                 block_tables=block_tables,
                                 cache_lens=cache_lens,
                                 ragged_meta=ragged_meta, fused=fused)
        if last_rows is not None:
            h = h[last_rows.long()]
        logits = torch.matmul(h, head.t())
        if return_hidden:
            return (logits, h), new_caches
        return logits, new_caches

    def init_caches(self, batch_size: int, max_length: int):
        """Zeroed per-layer dense ``(k, v)`` caches, each ``[batch_size,
        max_length, H, D]`` float32 (the reference's, whatever the model
        dtype)."""
        cfg = self.config
        shape = (batch_size, max_length, cfg.num_attention_heads,
                 cfg.head_dim)
        mk = dict(dtype=torch.float32, device=self.device)
        return [(torch.zeros(shape, **mk), torch.zeros(shape, **mk))
                for _ in range(cfg.num_hidden_layers)]

    def init_paged_caches(self, num_blocks: int, block_size: int,
                          kv_cache_dtype=None):
        """Zeroed per-layer ``(k_pool, v_pool)``, each ``[num_blocks,
        block_size, H, D]`` (MHA: the kv heads are the query heads; block
        0 is the null block): float32 whatever the model dtype, as the
        reference's, or with ``kv_cache_dtype="int8"`` int8
        :class:`~paddle_tpu_torch.ops.paged_cache.QuantKV` pools."""
        cfg = self.config
        dtype = "int8" if _pc.resolve_kv_cache_dtype(kv_cache_dtype) \
            else torch.float32
        return [_pc.init_pool(num_blocks, block_size,
                              cfg.num_attention_heads, cfg.head_dim, dtype,
                              self.device)
                for _ in range(cfg.num_hidden_layers)]
