"""Tensor-parallel layers at degree 1 (counterpart of
``paddle_tpu/distributed/fleet/mp_layers.py``).

On one device each layer is its plain twin, with the reference's
parameter names, Paddle's ``[in, out]`` layout and its bias defaults:
``ColumnParallelLinear`` (``x @ W + b``, a bias unless ``has_bias`` is
False), ``RowParallelLinear`` (``x @ W``, then ``+ b``; a bias unless
``has_bias`` is False) and ``VocabParallelEmbedding`` (a table lookup).
``gather_output`` / ``input_is_parallel`` describe where the shards
would meet and change nothing at degree 1. Any ``mp_group`` raises
``NotImplementedError``: sharded layers come with the distributed slice
(ROADMAP Queue 1 item 11). Parameters start as ``nn.Linear``'s and
``nn.Embedding``'s (Xavier-normal and N(0, 1) weights, zero biases); a
model that owns them draws its own weights.
"""
from __future__ import annotations

import torch

from ...nn.layer import Embedding, Linear

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]


def _one_rank(mp_group, what):
    """Raise unless ``mp_group`` is None: the port's layers run at degree
    1, where no group is given."""
    if mp_group is not None:
        raise NotImplementedError(
            f"{what} over a model-parallel group: tensor parallelism comes "
            "with the distributed slice of the PyTorch port (ROADMAP Queue 1 "
            "item 11); degree 1 only, with mp_group=None")


class ColumnParallelLinear(Linear):
    """``y = x @ W (+ b)``, ``W [in, out]`` (column-sharded at degree >
    1); a bias unless ``has_bias`` is False."""

    def __init__(self, in_features, out_features, has_bias=None,
                 gather_output=True, mp_group=None, device=None,
                 dtype=torch.float32):
        _one_rank(mp_group, "ColumnParallelLinear")
        super().__init__(in_features, out_features,
                         bias_attr=None if has_bias is not False else False,
                         device=device, dtype=dtype)
        self.gather_output = gather_output


class RowParallelLinear(Linear):
    """``y = x @ W`` then ``+ b``, ``W [in, out]`` (row-sharded at degree
    > 1, the partial sums reduced before the bias); a bias unless
    ``has_bias`` is False."""

    def __init__(self, in_features, out_features, has_bias=True,
                 input_is_parallel=False, mp_group=None, device=None,
                 dtype=torch.float32):
        _one_rank(mp_group, "RowParallelLinear")
        super().__init__(in_features, out_features,
                         bias_attr=None if has_bias else False,
                         device=device, dtype=dtype)
        self.input_is_parallel = input_is_parallel


class VocabParallelEmbedding(Embedding):
    """A ``[num_embeddings, embedding_dim]`` table (vocab-sharded at
    degree > 1)."""

    def __init__(self, num_embeddings, embedding_dim, mp_group=None,
                 device=None, dtype=torch.float32):
        _one_rank(mp_group, "VocabParallelEmbedding")
        super().__init__(num_embeddings, embedding_dim, device=device,
                         dtype=dtype)
