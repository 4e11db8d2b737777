"""Megatron-style tensor-parallel layers at degree 1 (the parts of
``paddle_tpu/distributed/fleet`` the ported models build on)."""
from . import mp_layers
from .mp_layers import (ColumnParallelLinear, RowParallelLinear,
                        VocabParallelEmbedding)

__all__ = ["mp_layers", "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]
