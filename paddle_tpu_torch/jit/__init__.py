"""``TrainStep`` (counterpart of ``paddle_tpu/jit/__init__.py``): one
training step of a layer — forward, loss, gradients, clip, optimizer
update — with the reference's step semantics, run eagerly.

The trainable set is the parameters that require grad and that the
optimizer was given. Each call runs the forward and
``loss_fn(out, args, kwargs)``, takes the gradients of the loss with
respect to the trainable set, applies the optimizer's ``grad_clip`` and
``_apply_decay``, then its ``_update_rule`` per parameter **on the
stored parameter, with no float32 master copy** (the reference's
compiled step calls the rule on the bf16 parameter directly; only the
moments are float32), and bumps the optimizer's step count. Batches
given as numpy arrays or tensors move to the layer's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.place import resolve_device

__all__ = ["TrainStep"]


def _to_device(x, dev):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).to(dev)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return x


class TrainStep:
    """``step = TrainStep(layer, loss_fn, optimizer)``; ``loss =
    step(*batch)`` runs one step and returns the loss (detached)."""

    def __init__(self, layer, loss_fn, optimizer):
        self.layer = layer
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.device = resolve_device(next(layer.parameters()).device)
        opt_ids = {id(p) for p in optimizer._parameter_list}
        self.trainable = [p for p in layer.parameters()
                          if p.requires_grad
                          and (not opt_ids or id(p) in opt_ids)]

    def __call__(self, *args, **kwargs):
        args = tuple(_to_device(a, self.device) for a in args)
        kwargs = {k: _to_device(v, self.device) for k, v in kwargs.items()}
        out = self.layer(*args, **kwargs)
        loss = self.loss_fn(out, args, kwargs)
        grads = torch.autograd.grad(loss, self.trainable, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.trainable, grads)]
        opt = self.optimizer
        lr = opt.get_lr()
        with torch.no_grad():
            if opt._grad_clip is not None:
                grads = [g for _, g in opt._grad_clip(
                    list(zip(self.trainable, grads)))]
            for p, g in zip(self.trainable, grads):
                g = opt._apply_decay(p, g)
                p_new, s_new = opt._update_rule(p.detach(), g,
                                                opt._state_for(p), lr)
                p.copy_(p_new)
                opt._write_state_dict(p, s_new)
        opt._step_count += 1
        return loss.detach()
