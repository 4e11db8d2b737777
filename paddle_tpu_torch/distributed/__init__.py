"""Distributed pieces of the port on one device: Mixture-of-Experts
dispatch (expert parallelism comes with a later slice), activation
recompute and the degree-1 tensor-parallel layers of ``fleet``."""
from . import fleet, moe
from .recompute import RecomputeFunction, recompute, recompute_sequential

__all__ = ["fleet", "moe", "recompute", "recompute_sequential",
           "RecomputeFunction"]
