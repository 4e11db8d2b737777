"""Optimizer base, Adam and AdamW (counterpart of
``paddle_tpu/optimizer/optimizer.py``), on tensors.

Each optimizer's math is a pure ``_update_rule(param, grad, state, lr)
-> (new_param, new_state)``, as in the reference, so one rule serves the
eager :meth:`Optimizer.step` and :class:`paddle_tpu_torch.jit.TrainStep`.
The dtype flow is the reference's: under ``multi_precision`` the moments
are float32; ``beta1_pow`` / ``beta2_pow`` are float32 scalars that start
at beta1 / beta2; a bfloat16 gradient enters the moment updates in
bfloat16 and the step itself runs in float32 before one rounding to the
parameter's dtype. Where a Python scalar meets a bfloat16 tensor
(``(1 - beta1) * g``, the decay factor) it is rounded to bfloat16 first,
as JAX rounds a weakly typed scalar (:func:`_weak`).
``torch.optim.AdamW`` keeps bf16 moments for bf16 parameters and rounds
elsewhere, so it is not used.

The eager ``step()`` keeps float32 master weights under
``multi_precision`` (the reference's ``step``); ``TrainStep`` updates the
stored parameter with no master copy (the reference's compiled step).
The updated parameter is written into the parameter in place; moments
are replaced by the rule's new tensors.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..framework.place import resolve_device
from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW", "L2Decay"]


def _weak(value, like):
    """``value`` as JAX's weakly typed scalar meets ``like``: in
    ``like``'s dtype (bf16 turns 0.1 into 0.10009765625, where PyTorch
    would keep the scalar in float32 inside the op)."""
    if like.dtype == torch.float32:
        return value
    return torch.tensor(value, dtype=like.dtype, device=like.device)


class L2Decay:
    """L2 regularisation folded into the gradient (``regularizer.py``)."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def _append(self, p, g):
        return g + self.coeff * p.to(g.dtype)

    def __repr__(self):
        return f"L2Decay({self.coeff})"


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        self._parameter_list = list(parameters)
        for dev in {p.device for p in self._parameter_list}:
            resolve_device(dev)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        if isinstance(weight_decay, (float, int)) and weight_decay:
            self._regularization = L2Decay(float(weight_decay))
        else:
            self._regularization = weight_decay
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._step_count = 0

    # -- lr ------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when LR is driven by a scheduler")
        self._learning_rate = float(value)

    # -- state ---------------------------------------------------------
    def _create_accumulator(self, name, param, fill=0.0, dtype=None):
        store = self._accumulators.setdefault(name, {})
        pid = id(param)
        if pid not in store:
            dt = dtype or (torch.float32 if self._multi_precision
                           else param.dtype)
            store[pid] = torch.full(param.shape, fill, dtype=dt,
                                    device=param.device)
        return store[pid]

    def _create_scalar_acc(self, name, param, fill):
        store = self._accumulators.setdefault(name, {})
        pid = id(param)
        if pid not in store:
            store[pid] = torch.tensor(fill, dtype=torch.float32,
                                      device=param.device)
        return store[pid]

    def _state_for(self, param) -> dict:
        return {}

    def _write_state_dict(self, p, new_state: dict):
        for k, v in new_state.items():
            self._accumulators.setdefault(k, {})[id(p)] = v

    # -- the per-param pure update rule ---------------------------------
    def _update_rule(self, p, g, state: dict, lr):
        raise NotImplementedError

    def _apply_decay(self, param, g):
        """L2 regularisation folds into the gradient."""
        if self._regularization is not None:
            return self._regularization._append(param, g)
        return g

    def _params_grads(self):
        pairs = [(p, p.grad) for p in self._parameter_list
                 if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        return pairs

    @torch.no_grad()
    def step(self):
        self._step_count += 1
        lr = self.get_lr()
        for p, g in self._params_grads():
            if self._multi_precision and p.dtype != torch.float32:
                master = self._master(p)
                g = self._apply_decay(p, g.float())
                new_master, new_state = self._update_rule(
                    master, g, self._state_for(p), lr)
                self._master_weights[id(p)] = new_master
                p.copy_(new_master.to(p.dtype))
            else:
                g = self._apply_decay(p, g)
                new_p, new_state = self._update_rule(
                    p.detach(), g, self._state_for(p), lr)
                p.copy_(new_p)
            self._write_state_dict(p, new_state)

    def _master(self, p):
        pid = id(p)
        if pid not in self._master_weights:
            self._master_weights[pid] = p.detach().float()
        return self._master_weights[pid]

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        if amsgrad:
            raise NotImplementedError("Adam: amsgrad is not ported yet")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _state_for(self, param):
        return {
            "moment1": self._create_accumulator("moment1", param),
            "moment2": self._create_accumulator("moment2", param),
            "beta1_pow": self._create_scalar_acc("beta1_pow", param,
                                                 self._beta1),
            "beta2_pow": self._create_scalar_acc("beta2_pow", param,
                                                 self._beta2),
        }

    def _decayed_g(self, p, g, lr):
        return g, p

    def _update_rule(self, p, g, state, lr):
        g, p = self._decayed_g(p, g, lr)
        m1 = self._beta1 * state["moment1"] + _weak(1 - self._beta1, g) * g
        m2 = self._beta2 * state["moment2"] \
            + _weak(1 - self._beta2, g) * g * g
        b1p = state["beta1_pow"]
        b2p = state["beta2_pow"]
        m1_hat = m1 / (1 - b1p)
        m2_hat = m2 / (1 - b2p)
        p_new = p - lr * m1_hat / (torch.sqrt(m2_hat) + self._epsilon)
        new_state = {"moment1": m1, "moment2": m2,
                     "beta1_pow": b1p * self._beta1,
                     "beta2_pow": b2p * self._beta2}
        return p_new.to(p.dtype), new_state


class AdamW(Adam):
    """Decoupled weight decay: decay multiplies the *parameter* (as
    stored, in its dtype), not the gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                "AdamW: lr_ratio / apply_decay_param_fun are not ported yet")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        self._wd = float(weight_decay) if weight_decay else 0.0

    def _decayed_g(self, p, g, lr):
        if self._wd:
            p = p * _weak(1.0 - lr * self._wd, p)
        return g, p
