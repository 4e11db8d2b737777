"""BERT (counterpart of ``paddle_tpu/models/bert.py``, PaddleNLP's BERT):
embeddings (word + position + token type, LayerNorm, dropout), a
post-LayerNorm ``TransformerEncoder`` of gelu layers, a tanh pooler over
the first position, and two heads — ``BertForSequenceClassification``
(dropout + a classifier on the pooled row; BASELINE's SST-2 fine-tune)
and ``BertForPretraining`` (an MLM head over every position and an NSP
head over the pooled row).

Built from the port's ``nn`` layers, so the parameter names are the
reference's (``bert.encoder.layers.0.self_attn.q_proj.weight`` ...) and
:func:`paddle_tpu_torch.convert.load_jax_params` moves weights across as
they are. Attention with no ``attention_mask`` runs K1 (non-causal); a
mask (bool ``[B, 1, 1, L]`` keeping True, or a float bias) runs the plain
biased recipe, as the reference runs XLA there.

Three quirks of the reference are kept (ROADMAP Queue 3): the encoder
layers' LayerNorms take the default eps 1e-5, only the embeddings' takes
``layer_norm_eps``; the encoder deep-copies its first layer, so every
layer starts from the same weights; the MLM head is one ``Linear``, with
no transform and no weight tying. Weights start as the layers' defaults
(Xavier-normal linears, N(0, 1) embeddings, zero biases, unit norms),
drawn from ``generator`` or a generator seeded with ``seed``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..distributed.shard_utils import batch_shard
from ..framework.place import resolve_device
from ..framework.random import generator as make_generator
from ..nn import functional as F
from ..nn.initializer import use_generator
from ..nn.layer import (Dropout, Embedding, Layer, LayerNorm, Linear,
                        TransformerEncoder, TransformerEncoderLayer)

__all__ = ["BertConfig", "BertEmbeddings", "BertPooler", "BertModel",
           "BertForSequenceClassification", "BertForPretraining"]


@dataclass
class BertConfig:
    """Defaults: BERT-base (vocab 30522, 12 layers, hidden 768, 12 heads
    of 64, ffn 3072, 512 positions)."""
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    num_labels: int = 2

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny(vocab=1024, hidden=128, layers=2, heads=4):
        return BertConfig(vocab_size=vocab, hidden_size=hidden,
                          num_hidden_layers=layers,
                          num_attention_heads=heads,
                          intermediate_size=hidden * 4)


def _tensor(x, device):
    """A tensor (or None) on ``device``: numpy arrays and lists are
    converted."""
    if x is None or isinstance(x, torch.Tensor):
        return x if x is None or x.device == device else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class BertEmbeddings(Layer):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h, device=device)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             h, device=device)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h,
                                               device=device)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, device=device)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(h))


class BertPooler(Layer):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            device=device)

    def forward(self, hidden_states):
        return F.tanh(self.dense(hidden_states[:, 0]))


class BertModel(Layer):
    """``(encoded [B, L, hidden], pooled [B, hidden])``."""

    def __init__(self, config: BertConfig, device=None, seed=0,
                 generator=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        with use_generator(generator if generator is not None
                           else make_generator(seed, dev)):
            self.embeddings = BertEmbeddings(config, dev)
            enc_layer = TransformerEncoderLayer(
                config.hidden_size, config.num_attention_heads,
                config.intermediate_size, dropout=config.hidden_dropout_prob,
                activation=config.hidden_act,
                attn_dropout=config.attention_probs_dropout_prob,
                act_dropout=0.0, device=dev)
            self.encoder = TransformerEncoder(enc_layer,
                                              config.num_hidden_layers)
            self.pooler = BertPooler(config, dev)

    @property
    def device(self) -> torch.device:
        return self.embeddings.word_embeddings.weight.device

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        dev = self.device
        input_ids = batch_shard(_tensor(input_ids, dev))
        emb = self.embeddings(input_ids, _tensor(token_type_ids, dev),
                              _tensor(position_ids, dev))
        encoded = self.encoder(emb, _tensor(attention_mask, dev))
        return encoded, self.pooler(encoded)


class BertForSequenceClassification(Layer):
    """Logits ``[B, num_classes]``, or with ``labels`` their
    cross-entropy."""

    def __init__(self, config: BertConfig = None, num_classes=None,
                 device=None, seed=0, generator=None):
        super().__init__()
        config = config or BertConfig()
        dev = resolve_device(device)
        g = generator if generator is not None else make_generator(seed, dev)
        with use_generator(g):
            self.bert = BertModel(config, dev, generator=g)
            self.dropout = Dropout(config.hidden_dropout_prob)
            self.classifier = Linear(config.hidden_size,
                                     num_classes or config.num_labels,
                                     device=dev)

    @property
    def device(self) -> torch.device:
        return self.bert.device

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, _tensor(labels, self.device))
        return logits


class BertForPretraining(Layer):
    """``(mlm_logits [B, L, vocab], nsp_logits [B, 2])``; with ``labels``
    (-100 where no token is predicted) the MLM cross-entropy, plus the NSP
    one with ``next_sentence_label``."""

    def __init__(self, config: BertConfig = None, device=None, seed=0,
                 generator=None):
        super().__init__()
        config = config or BertConfig()
        dev = resolve_device(device)
        g = generator if generator is not None else make_generator(seed, dev)
        with use_generator(g):
            self.bert = BertModel(config, dev, generator=g)
            self.mlm_head = Linear(config.hidden_size, config.vocab_size,
                                   device=dev)
            self.nsp_head = Linear(config.hidden_size, 2, device=dev)

    @property
    def device(self) -> torch.device:
        return self.bert.device

    def forward(self, input_ids, token_type_ids=None, labels=None,
                next_sentence_label=None):
        encoded, pooled = self.bert(input_ids, token_type_ids)
        mlm_logits = self.mlm_head(encoded)
        nsp_logits = self.nsp_head(pooled)
        if labels is not None:
            loss = F.cross_entropy(mlm_logits, _tensor(labels, self.device),
                                   ignore_index=-100)
            if next_sentence_label is not None:
                loss = loss + F.cross_entropy(
                    nsp_logits, _tensor(next_sentence_label, self.device))
            return loss
        return mlm_logits, nsp_logits
