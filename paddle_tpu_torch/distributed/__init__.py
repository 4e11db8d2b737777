"""Mixture-of-Experts dispatch of the port (one device; expert
parallelism comes with a later slice)."""
from . import moe

__all__ = ["moe"]
