"""Sharding helpers at degree 1 (counterpart of
``paddle_tpu/distributed/shard_utils.py``): ``batch_shard`` splits the
batch over the data-parallel ranks in the reference; on one device it is
the identity. A live process group of several ranks raises: data
parallelism comes with the distributed slice (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import torch

from .moe import _later

__all__ = ["batch_shard"]


def batch_shard(x, axes=("dp", "sharding", "ep")):
    """``x`` as it is on one device; more ranks raise."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise _later(f"batch_shard over {dist.get_world_size()} ranks "
                     f"(axes {axes})", "distribution")
    return x
