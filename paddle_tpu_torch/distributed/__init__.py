"""Distributed pieces of the port on one device: Mixture-of-Experts
dispatch (expert parallelism comes with a later slice) and the
degree-1 tensor-parallel layers of ``fleet``."""
from . import fleet, moe

__all__ = ["fleet", "moe"]
