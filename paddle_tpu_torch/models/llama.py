"""Llama causal LM (counterpart of ``paddle_tpu/models/llama.py``): the
dense training forward, the ragged serving path and the cache paths of
``generate()``.

Parameter names and layouts follow the reference's ``state_dict()``
(``llama.layers.{i}.self_attn.q_proj.weight`` ``[in, out]``, ...), so
weights move across with :func:`paddle_tpu_torch.convert.params_from_jax`.

``forward`` keeps the reference's keyword signature. With ``caches``
None it is the dense path over ``input_ids [B, L]``: embedding, decoder
layers (RMSNorm, q/k/v, rope, causal flash attention through the K1
kernels, O-projection, residual, RMSNorm, swiglu MLP, residual), final
norm and LM head; given ``labels`` it returns the
:class:`LlamaPretrainingCriterion` loss, else the logits. Everything is
differentiable. With ``caches`` it runs one of three decode paths:

- ragged (``ragged_meta`` given): ONE packed row buffer per serving
  tick, every live query row of every slot; each decoder layer runs
  either the fused decode path (RMSNorm -> q/k/v and RMSNorm -> gate/up
  through ``norm_matmul``; O-projection + residual and swiglu ->
  down-projection + residual through ``matmul_residual``; attention
  through the ragged paged kernel K2r) or the unfused module path; on
  the CPU the two are bitwise equal;
- paged (``block_tables`` given): ``input_ids [S, T]``, T tokens per
  slot written at ``cache_lens + t`` into the shared block pools and
  attended through K2d (T = 1) or K2v (T > 1);
- dense cached (neither): ``input_ids [B, L]`` written into the static
  ``[B, S_max, H_kv, D]`` caches at ``offset``, attended by
  :func:`cached_attention` under a causal-with-offset mask, with an
  optional ``[B, S_max]`` pad mask and per-row ``position_ids`` rope.

The serving engine and ``generate()`` call it under ``torch.no_grad()``;
``generate()`` runs the unfused module path, as the reference does.
With ``config.recompute`` a training forward recomputes every
``recompute_interval``-th decoder layer in the backward
(:func:`paddle_tpu_torch.distributed.recompute.recompute`). Attention
masks on the dense training path belong to a later slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..distributed.recompute import recompute
from ..framework.place import resolve_device
from ..framework.random import generator as make_generator
from ..generation import GenerationMixin
from ..incubate.nn.functional import (apply_rope, rope_rotate, rope_tables,
                                      swiglu)
from ..nn import Embedding, Linear, RMSNorm
from ..nn.initializer import owner_initializes
from ..ops import lora as _lora
from ..ops import paged_attention as _pa
from ..ops import paged_cache as _pc
from ..ops.flash_attention import flash_attention_core
from ..ops.kernels import decode_fused as _df

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "cached_attention"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    dtype: str = "float32"
    # activation recompute in training: layer i is recomputed in the
    # backward when i % recompute_interval == 0 (1: every layer)
    recompute: bool = False
    recompute_interval: int = 1

    @staticmethod
    def llama3_8b():
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, max_position_embeddings=8192,
            rope_theta=500000.0)

    @staticmethod
    def tiny(vocab=1024, hidden=256, layers=2, heads=8, kv_heads=4,
             ffn=512):
        return LlamaConfig(
            vocab_size=vocab, hidden_size=hidden, intermediate_size=ffn,
            num_hidden_layers=layers, num_attention_heads=heads,
            num_key_value_heads=kv_heads, max_position_embeddings=2048)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def cached_attention(qh, kh, vh, kc, vc, off, head_dim, extra_bias=None):
    """KV-cache attention step of the dense decode path: write this
    chunk's heads ``[B, L, H_kv, D]`` into the caches ``[B, S, H_kv, D]``
    at position ``off`` (in place), then attend ``qh [B, L, H, D]``
    against the whole cache under a causal-with-offset mask plus an
    optional additive ``extra_bias`` broadcastable to ``[B, 1, L, S]``
    (a pad mask, ``-1e9`` past its width). The reference's recipe:
    float32 scores divided by ``sqrt(head_dim)``, additive ``-1e9``
    bias, softmax, the weights cast to ``qh``'s dtype before the P @ V
    product in that dtype, and GQA by grouping the query heads (the
    cache is never repeated). Returns ``(out [B, L, H, D], kc, vc)``."""
    b, l, h, d = qh.shape
    hkv = kc.shape[2]
    rep = h // hkv
    size = kc.shape[1]
    off = max(0, min(int(off), size - l))   # the start a slice update takes
    kc[:, off:off + l] = kh.to(kc.dtype)
    vc[:, off:off + l] = vh.to(vc.dtype)
    dev = qh.device
    rows = off + torch.arange(l, device=dev)[:, None]
    cols = torch.arange(size, device=dev)[None, :]
    bias = torch.where(cols <= rows, 0.0, -1e9)[None, None]   # [1,1,L,S]
    if extra_bias is not None:
        pad = size - extra_bias.shape[-1]
        if pad > 0:
            extra_bias = torch.nn.functional.pad(extra_bias, (0, pad),
                                                 value=-1e9)
        bias = bias + extra_bias                               # [B,1,L,S]
    q5 = qh.reshape(b, l, hkv, rep, d)
    scores = torch.einsum("blgrd,bsgd->bgrls", q5.float(),
                          kc.to(qh.dtype).float()) / math.sqrt(head_dim)
    scores = scores + bias[:, :, None]
    w = torch.softmax(scores, dim=-1).to(qh.dtype)
    out = torch.einsum("bgrls,bsgd->blgrd", w, vc.to(qh.dtype))
    return out.reshape(b, l, h, d), kc, vc


def _apply_rope_rows(x, cos, sin):
    """Rope with per-row position tables: ``x [B, L, H, D]``,
    ``cos``/``sin`` ``[B, L, D/2]``."""
    return rope_rotate(x, cos[:, :, None, :], sin[:, :, None, :])


class LlamaAttention(nn.Module):
    """GQA attention: dense causal (training), ragged paged (serving),
    paged or dense cached (``generate()``). It takes any config with the
    Llama attention fields (the MoE families share it); ``qkv_bias``
    (default False) gives q/k/v their Qwen2 bias."""

    def __init__(self, config, device, dtype):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        h, hd = config.hidden_size, self.head_dim
        mk = dict(device=device, dtype=dtype, bias_attr=False)
        qkv = dict(mk, bias_attr=None if getattr(config, "qkv_bias", False)
                   else False)
        self.q_proj = Linear(h, self.num_heads * hd, **qkv)
        self.k_proj = Linear(h, self.num_kv_heads * hd, **qkv)
        self.v_proj = Linear(h, self.num_kv_heads * hd, **qkv)
        self.o_proj = Linear(self.num_heads * hd, h, **mk)

    def attend_ragged(self, q, k, v, rope_cos, rope_sin, kv_cache,
                      block_tables, cache_lens, ragged_meta):
        """Per-row rope + K/V scatter + ragged paged attention, without
        the O-projection. ``q``/``k``/``v`` are the packed projections
        ``[R, *]``; pad rows carry an overflow position whose rope index
        is clamped (their write goes to the null block). Returns
        ``(ctx [R, H * D], (k_pool, v_pool))``."""
        q_lens, row_starts, row_slot, row_pos, w_max = ragged_meta
        r = q.shape[0]
        qh = q.reshape(r, self.num_heads, self.head_dim)
        kh = k.reshape(r, self.num_kv_heads, self.head_dim)
        vh = v.reshape(r, self.num_kv_heads, self.head_dim)
        pos = torch.clamp(row_pos.long(), 0, rope_cos.shape[0] - 1)
        cos = rope_cos[pos][:, None, :]
        sin = rope_sin[pos][:, None, :]
        qh = rope_rotate(qh, cos, sin)
        kh = rope_rotate(kh, cos, sin)
        out, kp, vp = _pa.ragged_attention_step(
            qh, kh, vh, kv_cache[0], kv_cache[1], block_tables, cache_lens,
            q_lens, row_starts, row_slot, row_pos, w_max,
            sm_scale=1.0 / math.sqrt(self.head_dim))
        return out.reshape(r, self.num_heads * self.head_dim), (kp, vp)

    def _heads(self, q, k, v):
        b, l = q.shape[0], q.shape[1]
        return (q.reshape(b, l, self.num_heads, self.head_dim),
                k.reshape(b, l, self.num_kv_heads, self.head_dim),
                v.reshape(b, l, self.num_kv_heads, self.head_dim))

    def attend_paged(self, q, k, v, rope_cos, rope_sin, kv_cache,
                     block_tables, cache_lens):
        """Rope at positions ``cache_lens + t`` (per slot), the pool
        write and paged attention (K2d at T = 1, K2v at T > 1), without
        the O-projection. ``q``/``k``/``v`` are ``[S, T, *]``. Returns
        ``(ctx [S, T, H * D], (k_pool, v_pool))``."""
        qh, kh, vh = self._heads(q, k, v)
        b, l = qh.shape[0], qh.shape[1]
        pos = cache_lens.long()[:, None] + torch.arange(l, device=q.device)
        pos = torch.clamp(pos, 0, rope_cos.shape[0] - 1)
        cos, sin = rope_cos[pos], rope_sin[pos]           # [S, T, D/2]
        out, kp, vp = _pa.paged_attention_step(
            _apply_rope_rows(qh, cos, sin), _apply_rope_rows(kh, cos, sin),
            vh, kv_cache[0], kv_cache[1], block_tables, cache_lens,
            sm_scale=1.0 / math.sqrt(self.head_dim))
        return out.reshape(b, l, -1), (kp, vp)

    def attend_cached(self, q, k, v, rope_cos, rope_sin, kv_cache, offset,
                      attention_mask=None, position_ids=None):
        """The dense decode path: rope at ``offset + t`` (or at the
        per-row ``position_ids [B, L]``), the cache write at ``offset``
        and :func:`cached_attention`, with ``attention_mask [B, S]``
        masking pad cache slots. Returns ``(ctx [B, L, H * D], (k, v))``."""
        qh, kh, vh = self._heads(q, k, v)
        b, l = qh.shape[0], qh.shape[1]
        off = int(offset)
        if position_ids is not None:
            pos = position_ids.long()
            qh = _apply_rope_rows(qh, rope_cos[pos], rope_sin[pos])
            kh = _apply_rope_rows(kh, rope_cos[pos], rope_sin[pos])
        else:
            start = max(0, min(off, rope_cos.shape[0] - l))
            cos, sin = rope_cos[start:start + l], rope_sin[start:start + l]
            qh, kh = apply_rope(qh, cos, sin), apply_rope(kh, cos, sin)
        extra = None
        if attention_mask is not None:
            extra = torch.where(attention_mask > 0, 0.0,
                                -1e9)[:, None, None, :]
        out, kc, vc = cached_attention(qh, kh, vh, kv_cache[0], kv_cache[1],
                                       off, self.head_dim, extra_bias=extra)
        return out.reshape(b, l, -1), (kc, vc)

    def forward(self, h, rope_cos, rope_sin, kv_cache=None,
                block_tables=None, cache_lens=None, ragged_meta=None,
                offset=None, attention_mask=None, position_ids=None):
        if kv_cache is None:
            # dense causal over h [B, L, hidden]; kv heads stay grouped
            b, l, _ = h.shape
            qh, kh, vh = self._heads(self.q_proj(h), self.k_proj(h),
                                     self.v_proj(h))
            out = flash_attention_core(apply_rope(qh, rope_cos, rope_sin),
                                       apply_rope(kh, rope_cos, rope_sin),
                                       vh, is_causal=True)
            return self.o_proj(out.reshape(b, l, -1))
        q, k, v = self.q_proj(h), self.k_proj(h), self.v_proj(h)
        if ragged_meta is not None:
            ctx, cache = self.attend_ragged(q, k, v, rope_cos, rope_sin,
                                            kv_cache, block_tables,
                                            cache_lens, ragged_meta)
        elif block_tables is not None:
            ctx, cache = self.attend_paged(q, k, v, rope_cos, rope_sin,
                                           kv_cache, block_tables,
                                           cache_lens)
        else:
            ctx, cache = self.attend_cached(q, k, v, rope_cos, rope_sin,
                                            kv_cache, offset,
                                            attention_mask, position_ids)
        return self.o_proj(ctx), cache


class LlamaMLP(nn.Module):
    """SwiGLU MLP of width ``ffn`` (default ``config.intermediate_size``)."""

    def __init__(self, config: LlamaConfig, device, dtype, ffn=None):
        super().__init__()
        mk = dict(device=device, dtype=dtype, bias_attr=False)
        h = config.hidden_size
        f = config.intermediate_size if ffn is None else ffn
        self.gate_proj = Linear(h, f, **mk)
        self.up_proj = Linear(h, f, **mk)
        self.down_proj = Linear(f, h, **mk)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    """Attention and MLP, each behind an RMSNorm and a residual. The MLP
    comes from :meth:`make_mlp`; a subclass may return one that gives
    ``(out, aux)`` with a router aux loss (the MoE blocks), and may turn
    ``fused_decode`` off to run the serving tick on the module path."""
    fused_decode = True

    def __init__(self, config: LlamaConfig, device, dtype, layer_idx=0):
        super().__init__()
        self.self_attn = LlamaAttention(config, device, dtype)
        self.mlp = self.make_mlp(config, layer_idx, device, dtype)
        mk = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **mk)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **mk)

    def forward_decode_fused(self, h, rope_cos, rope_sin, kv_cache,
                             block_tables, cache_lens, ragged_meta):
        """The fused decode tick of the reference's
        ``_forward_decode_fused``: four fusion boundaries per layer, each
        projection's bias (Qwen2's q/k/v) in its kernel's epilogue, around
        the ragged attention (``ragged_meta``: K2r over the packed rows
        ``h [R, hidden]``) or the paged one (``h [S, T, hidden]``: K2d at
        T = 1, K2v at T > 1). Under
        multi-LoRA serving the layer composes per module, as the
        reference's: an armed q/k/v or gate/up projection keeps its fused
        prologue and adds its delta off the norm recomputed (the module
        path's input); an armed o_proj or down_proj runs the module call
        and the residual instead of K3b."""
        attn, mlp = self.self_attn, self.mlp
        q, k, v = _df.norm_matmul(
            h, self.input_layernorm.weight, None,
            [attn.q_proj.weight, attn.k_proj.weight, attn.v_proj.weight],
            [attn.q_proj.bias, attn.k_proj.bias, attn.v_proj.bias],
            eps=self.input_layernorm._epsilon, kind="rms")
        if _lora.armed(attn.q_proj) or _lora.armed(attn.k_proj) \
                or _lora.armed(attn.v_proj):
            hn = self.input_layernorm(h)
            q = _lora.apply(attn.q_proj, hn, q)
            k = _lora.apply(attn.k_proj, hn, k)
            v = _lora.apply(attn.v_proj, hn, v)
        if ragged_meta is not None:
            ctx, cache = attn.attend_ragged(q, k, v, rope_cos, rope_sin,
                                            kv_cache, block_tables,
                                            cache_lens, ragged_meta)
        else:
            ctx, cache = attn.attend_paged(q, k, v, rope_cos, rope_sin,
                                           kv_cache, block_tables,
                                           cache_lens)
        if _lora.armed(attn.o_proj):
            h = h + attn.o_proj(ctx)
        else:
            h = _df.matmul_residual([ctx], attn.o_proj.weight,
                                    attn.o_proj.bias, h)
        g, u = _df.norm_matmul(
            h, self.post_attention_layernorm.weight, None,
            [mlp.gate_proj.weight, mlp.up_proj.weight],
            [mlp.gate_proj.bias, mlp.up_proj.bias],
            eps=self.post_attention_layernorm._epsilon, kind="rms")
        if _lora.armed(mlp.gate_proj) or _lora.armed(mlp.up_proj):
            hn2 = self.post_attention_layernorm(h)
            g = _lora.apply(mlp.gate_proj, hn2, g)
            u = _lora.apply(mlp.up_proj, hn2, u)
        if _lora.armed(mlp.down_proj):
            out = h + mlp.down_proj(swiglu(g, u))
        else:
            out = _df.matmul_residual([g, u], mlp.down_proj.weight,
                                      mlp.down_proj.bias, h, act="swiglu")
        return out, cache

    def make_mlp(self, config, layer_idx, device, dtype):
        return LlamaMLP(config, device, dtype)

    def _mlp_residual(self, h):
        """``(h + mlp(norm(h)), aux)``; ``aux`` is None for an MLP
        without a router."""
        m = self.mlp(self.post_attention_layernorm(h))
        m, aux = m if isinstance(m, tuple) else (m, None)
        return h + m, aux

    def forward(self, h, rope_cos, rope_sin, kv_cache=None,
                block_tables=None, cache_lens=None, ragged_meta=None,
                fused=True, offset=None, attention_mask=None,
                position_ids=None):
        """Dense (``kv_cache`` None): ``(h, aux)``; cached: ``(h,
        cache)``."""
        if kv_cache is None:             # dense: [B, L, hidden]
            h = h + self.self_attn(self.input_layernorm(h), rope_cos,
                                   rope_sin)
            return self._mlp_residual(h)
        if fused and self.fused_decode and (
                ragged_meta is not None or (block_tables is not None
                                            and _df.paged_fused_armed())):
            return self.forward_decode_fused(h, rope_cos, rope_sin,
                                             kv_cache, block_tables,
                                             cache_lens, ragged_meta)
        a, cache = self.self_attn(self.input_layernorm(h), rope_cos,
                                  rope_sin, kv_cache, block_tables,
                                  cache_lens, ragged_meta, offset=offset,
                                  attention_mask=attention_mask,
                                  position_ids=position_ids)
        return self._mlp_residual(h + a)[0], cache


class LlamaModel(nn.Module):
    """Embedding, ``layer_cls`` decoder layers, final norm and the rope
    tables. Dense: ``(h, aux)``, ``aux`` the summed router aux losses
    (None without a router); cached: ``(h, new_caches)``."""
    layer_cls = LlamaDecoderLayer

    def __init__(self, config: LlamaConfig, device, dtype):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            [self.layer_cls(config, device, dtype, layer_idx=i)
             for i in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=dtype)
        cos, sin = rope_tables(config.max_position_embeddings,
                               config.head_dim, config.rope_theta)
        self.register_buffer("_rope_cos", torch.from_numpy(cos).to(device),
                             persistent=False)
        self.register_buffer("_rope_sin", torch.from_numpy(sin).to(device),
                             persistent=False)

    def forward(self, input_ids, attention_mask=None, position_ids=None,
                caches=None, block_tables=None, cache_lens=None,
                ragged_meta=None, fused=True, offset=None):
        if caches is None:
            if attention_mask is not None or position_ids is not None:
                # the reference takes both here and uses neither (its
                # attention is always plain causal): refuse them rather
                # than drop them silently
                raise NotImplementedError(
                    f"{type(self).__name__}: attention_mask / position_ids "
                    "on the dense path without a cache are ignored by the "
                    "reference; they are refused here until both packages "
                    "implement them")
            h = self.embed_tokens(input_ids.long())
            l = h.shape[1]
            cos, sin = self._rope_cos[:l], self._rope_sin[:l]
            aux_total = None
            # the MoE configs carry no interval: every layer recomputes
            every = max(getattr(self.config, "recompute_interval", 1), 1)
            for i, layer in enumerate(self.layers):
                if getattr(self.config, "recompute", False) \
                        and self.training and i % every == 0:
                    h, aux = recompute(layer, h, cos, sin)
                else:
                    h, aux = layer(h, cos, sin)
                if aux is not None:
                    aux_total = aux if aux_total is None else aux_total + aux
            return self.norm(h), aux_total
        if ragged_meta is not None:     # one packed row buffer [R]
            input_ids = input_ids.reshape(-1)
        h = self.embed_tokens(input_ids.long())
        new_caches = []
        for layer, kv in zip(self.layers, caches):
            h, kv2 = layer(h, self._rope_cos, self._rope_sin, kv,
                           block_tables, cache_lens, ragged_meta,
                           fused=fused, offset=offset,
                           attention_mask=attention_mask,
                           position_ids=position_ids)
            new_caches.append(kv2)
        return self.norm(h), new_caches


class LlamaPretrainingCriterion(nn.Module):
    """Masked cross entropy over pre-shifted labels (``labels[t]`` is the
    target of ``logits[t]``; no internal shift), with the reference's
    recipe: the row max in the logits dtype (no gradient), the float32
    upcast only on ``logits - max`` under the exp-sum, the picked logit
    gathered in the logits dtype, ``ignore_index`` rows masked, and the
    mean over the rows that count. No full ``log_softmax`` is built."""

    def __init__(self, config: LlamaConfig = None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        m = logits.detach().amax(-1, keepdim=True)
        zs = (logits - m).float()
        lse = m[..., 0].float() + torch.log(torch.exp(zs).sum(-1))
        lb = labels.long()
        picked = torch.gather(logits, -1, lb.clamp(min=0)[..., None])[
            ..., 0].float()
        valid = lb != self.ignore_index
        loss = torch.where(valid, lse - picked, torch.zeros_like(lse))
        return loss.sum() / valid.float().sum().clamp(min=1.0)


class LlamaForCausalLM(nn.Module, GenerationMixin):
    """``forward(input_ids, labels=None, attention_mask=None,
    position_ids=None, caches=None, offset=None, block_tables=None,
    cache_lens=None, ragged_meta=None, last_rows=None, fused=True,
    return_hidden=False)``.

    Dense (``caches`` None): ``input_ids [B, L]`` -> logits
    ``[B, L, V]``, or the scalar loss when ``labels [B, L]`` is given.

    Ragged serving (``caches`` and ``ragged_meta`` given): ``input_ids
    [R]``, ``block_tables [S, MB]`` int32, ``cache_lens [S]`` int32 and
    ``ragged_meta = (q_lens [S], row_starts [S], row_slot [R], row_pos
    [R], w_max)`` (int32 tensors on the model's device plus a host int
    bounding ``q_lens``) -> ``(logits, caches)``; ``last_rows`` (``[S]``
    row indices) restricts the LM head to those rows.

    Paged (``caches`` the per-layer pools and ``block_tables`` given,
    no ``ragged_meta``): ``input_ids [S, T]`` at positions ``cache_lens
    + t`` -> ``(logits [S, T, V], caches)``. Dense cached (``caches``
    from :meth:`init_caches`): ``input_ids [B, L]`` at ``offset`` (a
    host int), with optional ``attention_mask [B, S_max]`` and
    ``position_ids [B, L]`` -> ``(logits [B, L, V], caches)``. Both
    update the caches in place. ``return_hidden`` makes the logits
    ``(logits, final hidden state)``.

    :meth:`generate` comes from
    :class:`paddle_tpu_torch.generation.GenerationMixin`.

    Built on ``device`` (default: cuda; ``"cpu"`` runs the plain
    versions of the kernels) with weights drawn from ``generator`` (or a
    generator seeded with ``seed``), normal(0, initializer_range) for
    projections and embeddings, ones for norms. Every parameter is
    trainable.

    A subclass names its base model's class (``model_cls``) and its
    ``state_dict`` prefix (``base_prefix``); given ``labels``, a model
    whose layers report router aux losses adds
    ``config.router_aux_loss_coef`` times their sum to the loss."""
    base_prefix = "llama"
    model_cls = LlamaModel

    def __init__(self, config: LlamaConfig, device=None, seed=0,
                 generator=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dtype = config.torch_dtype
        # the layers leave their random weights to _init_weights
        with owner_initializes():
            setattr(self, self.base_prefix,
                    self.model_cls(config, dev, dtype))
            self.lm_head = None if config.tie_word_embeddings else Linear(
                config.hidden_size, config.vocab_size, bias_attr=False,
                device=dev, dtype=dtype)
        self.criterion = LlamaPretrainingCriterion(config)
        self._init_weights(generator if generator is not None
                           else make_generator(seed, dev))

    @property
    def base(self) -> LlamaModel:
        return getattr(self, self.base_prefix)

    @property
    def device(self) -> torch.device:
        return self.base.embed_tokens.weight.device

    @torch.no_grad()
    def _init_weights(self, generator):
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)

    def forward(self, input_ids, labels=None, attention_mask=None,
                position_ids=None, caches=None, offset=None,
                block_tables=None, cache_lens=None, ragged_meta=None,
                last_rows=None, fused=True, return_hidden=False):
        if caches is None:
            h, aux = self.base(input_ids, attention_mask, position_ids)
            out = self._head_and_loss(h, labels)
            coef = getattr(self.config, "router_aux_loss_coef", 0.0)
            if labels is not None and aux is not None and coef:
                out = out + coef * aux
            return out
        h, new_caches = self.base(input_ids, attention_mask, position_ids,
                                   caches=caches, block_tables=block_tables,
                                   cache_lens=cache_lens,
                                   ragged_meta=ragged_meta, fused=fused,
                                   offset=offset)
        if last_rows is not None:
            h = h[last_rows.long()]
        logits = self._head_and_loss(h, None)
        if return_hidden:
            return (logits, h), new_caches
        return logits, new_caches

    def _head_and_loss(self, h, labels):
        if self.lm_head is None:
            logits = h @ self.base.embed_tokens.weight.t()
        else:
            logits = self.lm_head(h)
        if labels is not None:
            return self.criterion(logits, labels)
        return logits

    def init_caches(self, batch_size: int, max_length: int):
        """Zeroed per-layer dense ``(k, v)`` caches, each
        ``[batch_size, max_length, H_kv, D]`` in the model dtype."""
        cfg = self.config
        shape = (batch_size, max_length, cfg.num_key_value_heads,
                 cfg.head_dim)
        mk = dict(dtype=cfg.torch_dtype, device=self.device)
        return [(torch.zeros(shape, **mk), torch.zeros(shape, **mk))
                for _ in range(cfg.num_hidden_layers)]

    def init_paged_caches(self, num_blocks: int, block_size: int,
                          kv_cache_dtype=None):
        """Zeroed per-layer ``(k_pool, v_pool)``, each
        ``[num_blocks, block_size, H_kv, D]`` (block 0 is the null
        block): in the model dtype, or with ``kv_cache_dtype="int8"``
        int8 :class:`~paddle_tpu_torch.ops.paged_cache.QuantKV` pools
        (data + a float32 scale a position and kv head)."""
        cfg = self.config
        dtype = "int8" if _pc.resolve_kv_cache_dtype(kv_cache_dtype) \
            else cfg.torch_dtype
        return [_pc.init_pool(num_blocks, block_size,
                              cfg.num_key_value_heads, cfg.head_dim,
                              dtype, self.device)
                for _ in range(cfg.num_hidden_layers)]
