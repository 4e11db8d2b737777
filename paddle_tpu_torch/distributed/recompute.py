"""Activation recompute (counterpart of
``paddle_tpu/distributed/recompute.py``; Paddle's
``fleet.utils.recompute``).

A segment run through :func:`recompute` keeps none of its activations
for the backward: ``torch.utils.checkpoint.checkpoint`` (non-reentrant)
saves its inputs and replays its forward when the backward first needs
what it would have saved. That is the reference's default policy,
``"full"`` (``jax.checkpoint`` saving nothing). The reference's named
policies (``"dots"``, ``"save_attn"``, ``"dots_attn"``), chosen by a
flag, come with the port's flags module.

The replay must draw the same random numbers as the forward did. The
port's dropout draws from its own generators (each device's default
stream of ``framework.random`` and any generator a ``Dropout`` was
given), which ``checkpoint``'s ``preserve_rng_state`` does not cover: so
the state of each such generator is taken before the forward, set again
for the replay, and the state the replay found is put back after it, so
the backward leaves the streams where the forward left them. Host
statistics that the reference counts once a forward (``MOE_STATS``) are
put back after the replay too; kernel launch counts keep the replayed
launches, which are real. With ``preserve_rng_state=False`` nothing is
restored.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from ..framework.random import _STREAMS, default_generator
from .moe import MOE_STATS

__all__ = ["recompute", "recompute_sequential", "RecomputeFunction"]


def _generators(function, args):
    """Every port generator the segment can draw from: each device's
    default stream (made now, at its seed, for the devices of the inputs
    and parameters, so the forward cannot create it midway) and each
    generator a submodule holds."""
    devs = {a.device for a in args if isinstance(a, torch.Tensor)}
    gens = []
    if isinstance(function, torch.nn.Module):
        devs |= {p.device for p in function.parameters()}
        for m in function.modules():
            g = getattr(m, "generator", None)
            if isinstance(g, torch.Generator):
                gens.append(g)
    for d in devs:
        default_generator(d)
    gens.extend(_STREAMS.values())
    return list({id(g): g for g in gens}.values())


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward. ``function`` may be a module (its parameters receive
    their gradients) or any callable of tensors; it may return a tensor
    or a tuple. ``preserve_rng_state`` (default True) replays the same
    random draws; ``use_reentrant`` is accepted and ignored, as the
    reference does (the non-reentrant form is always used)."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", True)
    gens = _generators(function, args) if preserve else []
    states = [g.get_state() for g in gens]

    @contextlib.contextmanager
    def replay():
        found = [g.get_state() for g in gens]
        stats = dict(MOE_STATS)
        for g, s in zip(gens, states):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(gens, found):
                g.set_state(s)
            MOE_STATS.update(stats)

    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          replay()),
                      **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Run the layers of ``functions`` (a sequential container) in
    ``ctx["segments"]`` chunks, each chunk recomputed."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    chunk = max(len(layers) // max(segments, 1), 1)
    x = args[0]
    for i in range(0, len(layers), chunk):
        seg = layers[i:i + chunk]

        def run_seg(t, seg=seg):
            for layer in seg:
                t = layer(t)
            return t
        if all(isinstance(layer, torch.nn.Module) for layer in seg):
            run_seg = torch.nn.Sequential(*seg)    # its generators found
        x = recompute(run_seg, x)
    return x


RecomputeFunction = recompute
