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
given as numpy arrays or tensors (or tuples of them) move to the
layer's device. A keyword ``_labels`` is the reference's channel for
``hapi.Model``'s labels: it is kept from the layer and handed to
``loss_fn`` in its ``kwargs``. The first call draws one number from
numpy's global generator, as the reference's does for its step's
dropout key, so a seeded ``Model.fit`` shuffles its later epochs as the
reference's does.

Telemetry, as the reference's step keeps it (each step has a
``telemetry_name``, ``train_step:<layer class>:<n>``):

- the first call runs under
  :class:`~paddle_tpu_torch.monitor.accounting.CostRecorder`, so its
  report (``monitor.step_report(step.telemetry_name)``: the counted
  FLOPs and bytes, the hand-written kernels' declared work included and
  a recomputed segment counted twice, as XLA's remat is; on CUDA the
  first step's peak device memory, the allocator's peak statistic reset
  as the first call starts; an empty collective census) is filed by
  ``monitor.record_compiled_step``, and ``train_step_compiles`` counts
  it. The accounting is wrapped, never the step: a fault in the step
  itself propagates;
- ``train_step_calls`` counts every call, and ``sample_device_memory``
  reads the allocator's watermarks at each step boundary;
- ``train_step_fallback_recompiles`` counts the first call whose input
  signature (each tensor's shape and dtype) differs from the first
  call's. The port compiles nothing, so nothing is missed: it counts
  what the reference's executable would miss, once, as the reference
  drops to its caching path after one miss.
"""
from __future__ import annotations

import itertools
import warnings

import numpy as np
import torch

from .. import monitor as _monitor
from ..framework.place import resolve_device
from ..monitor import accounting as _acct

__all__ = ["TrainStep"]

_TRAIN_STEP_SEQ = itertools.count(1)


def _to_device(x, dev):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).to(dev)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(v, dev) for v in x)
    return x


def _signature(args, kwargs):
    return tuple((tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
                 else type(v) for v in list(args) + sorted(kwargs.items()))


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
        self.telemetry_name = (f"train_step:{type(layer).__name__}:"
                               f"{next(_TRAIN_STEP_SEQ)}")
        self._step_idx = 0
        self._sig = None
        self._missed = False

    def _counter(self, name, help_):
        return _monitor.counter(name, help_, labels=("step",)) \
            .labels(step=self.telemetry_name)

    def _step(self, args, kwargs):
        kwargs = dict(kwargs)
        labels = kwargs.pop("_labels", ())
        out = self.layer(*args, **kwargs)
        loss = self.loss_fn(out, args, {"_labels": labels, **kwargs})
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
                state = opt._state_for(p)
                opt._current_param = p
                p_new, s_new = opt._update_rule(p.detach(), g, state, lr)
                p.copy_(p_new)
                opt._write_state_dict(p, s_new)
            opt._current_param = None
        opt._step_count += 1
        return loss.detach()

    def __call__(self, *args, **kwargs):
        args = tuple(_to_device(a, self.device) for a in args)
        kwargs = {k: _to_device(v, self.device) for k, v in kwargs.items()}
        sig = _signature(args, kwargs)
        cuda = self.device.type == "cuda"
        if self._sig is None:
            self._sig = sig
            np.random.randint(0, 2 ** 31 - 1)
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            with _acct.CostRecorder() as rec:
                loss = self._step(args, kwargs)
            self._counter("train_step_compiles",
                          "TrainStep first-call accountings").inc()
            mem = {"peak_hbm_bytes": int(torch.cuda.max_memory_allocated(
                self.device))} if cuda else {}
            try:
                _monitor.record_compiled_step(self.telemetry_name,
                                              rec.result(), mem)
            except Exception as e:  # accounting must never sink the step
                warnings.warn(f"{self.telemetry_name}: step accounting "
                              f"failed: {e!r}")
        else:
            if sig != self._sig and not self._missed:
                self._missed = True
                self._counter("train_step_fallback_recompiles",
                              "signature misses off the first call's").inc()
            loss = self._step(args, kwargs)
        self._counter("train_step_calls", "TrainStep invocations").inc()
        _monitor.sample_device_memory(step=self._step_idx,
                                      device=self.device)
        self._step_idx += 1
        return loss
