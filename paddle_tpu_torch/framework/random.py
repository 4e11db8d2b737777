"""Seeding, explicit random generators and the default random stream.

The port never draws from PyTorch's global generator: weight init and
sampling each take a ``torch.Generator`` made here, so two runs from one
seed give the same numbers on the same device. Dropout draws from the
default stream of its tensor's device (:func:`default_generator`, the
counterpart of the reference's ``next_key``) unless the caller passes a
generator of its own. Like the reference's ``seed()``, :func:`seed` also
seeds numpy's global generator, which the data pipeline's samplers and
the synthetic datasets draw from in both packages (``io``, ``vision``).
"""
from __future__ import annotations

import numpy as np
import torch

from .place import resolve_device

__all__ = ["seed", "generator", "default_generator"]

_SEED = 0
_STREAMS = {}   # torch.device -> its default torch.Generator


def seed(value: int) -> int:
    """Set the default seed for generators made without an explicit one
    (and PyTorch's and numpy's global seeds, as the reference seeds
    numpy's), and restart every device's default stream from it."""
    global _SEED
    _SEED = int(value)
    torch.manual_seed(_SEED)
    np.random.seed(_SEED % (2 ** 32))
    _STREAMS.clear()
    return _SEED


def generator(seed_value=None, device=None) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` (default: cuda), seeded
    with ``seed_value`` or the last value given to :func:`seed`."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(_SEED if seed_value is None else int(seed_value))
    return g


def default_generator(device) -> torch.Generator:
    """The default random stream of ``device``: one generator per device,
    made at first use from the last value given to :func:`seed` and
    advanced by every draw from it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    g = _STREAMS.get(dev)
    if g is None:
        g = _STREAMS[dev] = torch.Generator(device=dev)
        g.manual_seed(_SEED)
    return g
