"""Distributed pieces of the port on one device: Mixture-of-Experts
dispatch (expert parallelism comes with a later slice), activation
recompute, ``batch_shard`` and the degree-1 tensor-parallel layers of
``fleet``."""
from . import fleet, moe, shard_utils
from .recompute import RecomputeFunction, recompute, recompute_sequential
from .shard_utils import batch_shard

__all__ = ["fleet", "moe", "shard_utils", "batch_shard", "recompute",
           "recompute_sequential", "RecomputeFunction"]
