"""The optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``),
on tensors: SGD, Momentum, Adagrad, Adam, AdamW, Adamax, RMSProp,
Adadelta, Lamb, NAdam, RAdam and LBFGS.

Each optimizer's math is a pure ``_update_rule(param, grad, state, lr)
-> (new_param, new_state)``, as in the reference, so one rule serves the
eager :meth:`Optimizer.step` and :class:`paddle_tpu_torch.jit.TrainStep`.
The dtype flow is the reference's: under ``multi_precision`` the
accumulators are float32; ``beta1_pow`` / ``beta2_pow`` are float32
scalars that start at beta1 / beta2; a bfloat16 gradient enters the
accumulator updates in bfloat16, and where one meets a float32 scalar
state it is widened first (JAX promotes a bf16 array against a float32
0-d array to float32; PyTorch would keep bf16, :func:`_up`), before one
rounding to the parameter's dtype. Where a Python scalar meets a
bfloat16 tensor it is rounded to bfloat16 first, as JAX rounds a weakly
typed scalar (:func:`_weak`). ``torch.optim`` keeps bf16 moments for
bf16 parameters and rounds elsewhere, so it is not used.

The eager ``step()`` keeps float32 master weights under
``multi_precision`` (the reference's ``step``); ``TrainStep`` updates the
stored parameter with no master copy (the reference's compiled step).
The updated parameter is written into the parameter in place;
accumulators are replaced by the rule's new tensors.
``state_dict()`` holds the accumulators under the reference's keys
(``<name or 'param'>_<index>_<accumulator>``, the name a parameter's
``param_name`` attribute, ``"@step"``, and the
scheduler's under ``"LR_Scheduler"``); ``set_state_dict`` restores them
into a fresh optimizer.

Two deviations, each where the reference gives a wrong result:
``AdamW(lr_ratio=fn)`` scales the learning rate of each parameter by
``fn(param)``, as Paddle does (the reference stores ``lr_ratio`` and
never applies it); and ``LBFGS``, which in the reference is a plain
gradient step under ``step(closure)`` with no rule for the compiled
step, gives ``TrainStep`` that same step as its rule.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..framework.place import resolve_device
from .lr import LRScheduler
from .regularizer import L2Decay

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "AdamW",
           "Adamax", "RMSProp", "Adadelta", "Lamb", "NAdam", "RAdam",
           "LBFGS", "L2Decay"]


def _weak(value, like):
    """``value`` as JAX's weakly typed scalar meets ``like``: in
    ``like``'s dtype (bf16 turns 0.1 into 0.10009765625, where PyTorch
    would keep the scalar in float32 inside the op)."""
    if like.dtype == torch.float32:
        return value
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _pname(p):
    """A parameter's Paddle name: its ``param_name`` attribute (PyTorch's
    ``Tensor.name`` is read-only), None by default, as the reference's
    parameters made without a name."""
    return getattr(p, "param_name", None)


def _up(x, scalar_state):
    """``x`` widened to JAX's result dtype against a float32 0-d state
    (``beta1_pow``): PyTorch treats a 0-d tensor as a scalar and would
    keep bf16."""
    return x.to(torch.promote_types(x.dtype, scalar_state.dtype))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        self._parameter_list = list(parameters)
        self._param_groups = self._parameter_list
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
        self._name = name
        self._current_param = None

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

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

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

    def state_dict(self):
        """The accumulators by the reference's keys, the step count and
        the scheduler's state."""
        out = {}
        for name, store in self._accumulators.items():
            for i, p in enumerate(self._parameter_list):
                if id(p) in store:
                    key = f"{_pname(p) or 'param'}_{i}_{name}"
                    out[key] = store[id(p)].detach().clone()
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        out["@step"] = self._step_count
        return out

    def set_state_dict(self, state_dict):
        """Restore a :meth:`state_dict`; the keys are parsed from it, so a
        fresh optimizer with no accumulators yet takes it."""
        self._step_count = int(state_dict.get("@step", 0))
        if "LR_Scheduler" in state_dict and isinstance(
                self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(
                dict(state_dict["LR_Scheduler"]))
        for i, p in enumerate(self._parameter_list):
            prefix = f"{_pname(p) or 'param'}_{i}_"
            for key, value in state_dict.items():
                if isinstance(key, str) and key.startswith(prefix):
                    self._accumulators.setdefault(key[len(prefix):], {})[
                        id(p)] = torch.as_tensor(value).detach().clone() \
                        .to(p.device)
        return self

    # -- the per-param pure update rule ---------------------------------
    def _update_rule(self, p, g, state: dict, lr):
        raise NotImplementedError

    def _apply_decay(self, param, g):
        """A regulariser (``weight_decay``) folds into the gradient."""
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
            self._current_param = p
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
        self._current_param = None

    def _master(self, p):
        pid = id(p)
        if pid not in self._master_weights:
            self._master_weights[pid] = p.detach().float()
        return self._master_weights[pid]

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then :meth:`step` (the dynamic-graph
        branch; the static-graph one comes with the port's ``static``)."""
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update_rule(self, p, g, state, lr):
        return p - _weak(lr, p) * g.to(p.dtype), {}


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _state_for(self, param):
        return {"velocity": self._create_accumulator("velocity", param)}

    def _update_rule(self, p, g, state, lr):
        v = state["velocity"]
        if v.shape == g.shape:
            v = v.to(g.dtype)
        v_new = _weak(self._momentum, v) * v + g
        if self._use_nesterov:
            p_new = p - _weak(lr, g) * (g + _weak(self._momentum, v_new)
                                        * v_new)
        else:
            p_new = p - _weak(lr, v_new) * v_new
        return p_new.to(p.dtype), {"velocity": v_new}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _state_for(self, param):
        return {"moment": self._create_accumulator("moment", param,
                                                   self._init_acc)}

    def _update_rule(self, p, g, state, lr):
        m = state["moment"] + g * g
        p_new = p - _weak(lr, g) * g / (torch.sqrt(m)
                                        + _weak(self._epsilon, m))
        return p_new.to(p.dtype), {"moment": m}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad

    def _state_for(self, param):
        s = {
            "moment1": self._create_accumulator("moment1", param),
            "moment2": self._create_accumulator("moment2", param),
            "beta1_pow": self._create_scalar_acc("beta1_pow", param,
                                                 self._beta1),
            "beta2_pow": self._create_scalar_acc("beta2_pow", param,
                                                 self._beta2),
        }
        if self._amsgrad:
            s["moment2_max"] = self._create_accumulator("moment2_max",
                                                        param)
        return s

    def _decayed_g(self, p, g, lr):
        return g, p, lr

    def _moments(self, state, g):
        m1 = _weak(self._beta1, state["moment1"]) * state["moment1"] \
            + _weak(1 - self._beta1, g) * g
        m2 = _weak(self._beta2, state["moment2"]) * state["moment2"] \
            + _weak(1 - self._beta2, g) * g * g
        return m1, m2

    def _update_rule(self, p, g, state, lr):
        g, p, lr = self._decayed_g(p, g, lr)
        m1, m2 = self._moments(state, g)
        b1p = state["beta1_pow"]
        b2p = state["beta2_pow"]
        m1_hat = _up(m1, b1p) / (1 - b1p)
        extra = {}
        if self._amsgrad:
            m2_max = torch.maximum(state.get("moment2_max", m2), m2)
            m2_hat = _up(m2_max, b2p) / (1 - b2p)
            extra = {"moment2_max": m2_max}
        else:
            m2_hat = _up(m2, b2p) / (1 - b2p)
        p_new = p - lr * m1_hat / (torch.sqrt(m2_hat) + self._epsilon)
        new_state = {"moment1": m1, "moment2": m2,
                     "beta1_pow": b1p * self._beta1,
                     "beta2_pow": b2p * self._beta2, **extra}
        return p_new.to(p.dtype), new_state


class AdamW(Adam):
    """Decoupled weight decay: decay multiplies the *parameter* (as
    stored, in its dtype), not the gradient. ``apply_decay_param_fun``
    gets each parameter's name (its ``param_name``; ``""`` without one,
    as the reference's unnamed parameters) and decays it only where it
    returns True; ``lr_ratio(param)`` scales that parameter's learning
    rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        self._wd = float(weight_decay) if weight_decay else 0.0
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _decayed_g(self, p, g, lr):
        cur = self._current_param
        if self._lr_ratio is not None and cur is not None:
            lr = lr * float(self._lr_ratio(cur))
        decay = self._wd
        if self._apply_decay_param_fun is not None and cur is not None \
                and not self._apply_decay_param_fun(_pname(cur) or ""):
            decay = 0.0
        if decay:
            p = p * _weak(1.0 - lr * decay, p)
        return g, p, lr


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _state_for(self, param):
        return {
            "moment": self._create_accumulator("moment", param),
            "inf_norm": self._create_accumulator("inf_norm", param),
            "beta1_pow": self._create_scalar_acc("beta1_pow", param,
                                                 self._beta1),
        }

    def _update_rule(self, p, g, state, lr):
        m = _weak(self._beta1, state["moment"]) * state["moment"] \
            + _weak(1 - self._beta1, g) * g
        u = torch.maximum(_weak(self._beta2, state["inf_norm"])
                          * state["inf_norm"], torch.abs(g))
        b1p = state["beta1_pow"]
        p_new = p - (lr / (1 - b1p)) * _up(m, b1p) / (
            u + _weak(self._epsilon, u))
        return p_new.to(p.dtype), {
            "moment": m, "inf_norm": u, "beta1_pow": b1p * self._beta1}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _state_for(self, param):
        return {
            "mean_square": self._create_accumulator("mean_square", param),
            "mean_grad": self._create_accumulator("mean_grad", param),
            "momentum": self._create_accumulator("momentum", param),
        }

    def _update_rule(self, p, g, state, lr):
        rho = self._rho
        ms = _weak(rho, state["mean_square"]) * state["mean_square"] \
            + _weak(1 - rho, g) * g * g
        if self._centered:
            mg = _weak(rho, state["mean_grad"]) * state["mean_grad"] \
                + _weak(1 - rho, g) * g
            denom = torch.sqrt(ms - mg * mg + _weak(self._epsilon, ms))
        else:
            mg = state["mean_grad"]
            denom = torch.sqrt(ms + _weak(self._epsilon, ms))
        mom = _weak(self._momentum, state["momentum"]) * state["momentum"] \
            + _weak(lr, g) * g / denom
        return (p - mom).to(p.dtype), {
            "mean_square": ms, "mean_grad": mg, "momentum": mom}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon, self._rho = epsilon, rho

    def _state_for(self, param):
        return {
            "avg_squared_grad": self._create_accumulator(
                "avg_squared_grad", param),
            "avg_squared_update": self._create_accumulator(
                "avg_squared_update", param),
        }

    def _update_rule(self, p, g, state, lr):
        rho, eps = self._rho, self._epsilon
        asg = _weak(rho, state["avg_squared_grad"]) \
            * state["avg_squared_grad"] + _weak(1 - rho, g) * g * g
        asu = state["avg_squared_update"]
        update = -torch.sqrt(asu + _weak(eps, asu)) \
            / torch.sqrt(asg + _weak(eps, asg)) * g
        asu_new = _weak(rho, asu) * asu \
            + _weak(1 - rho, update) * update * update
        return (p + _weak(lr, update) * update).to(p.dtype), {
            "avg_squared_grad": asg, "avg_squared_update": asu_new}


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _state_for(self, param):
        self._current_param = param
        return {
            "moment1": self._create_accumulator("moment1", param),
            "moment2": self._create_accumulator("moment2", param),
            "beta1_pow": self._create_scalar_acc("beta1_pow", param,
                                                 self._beta1),
            "beta2_pow": self._create_scalar_acc("beta2_pow", param,
                                                 self._beta2),
        }

    _moments = Adam._moments

    def _update_rule(self, p, g, state, lr):
        m1, m2 = self._moments(state, g)
        b1p, b2p = state["beta1_pow"], state["beta2_pow"]
        m1_hat = _up(m1, b1p) / (1 - b1p)
        m2_hat = _up(m2, b2p) / (1 - b2p)
        r = m1_hat / (torch.sqrt(m2_hat) + self._epsilon)
        wd = self._lamb_wd
        if self._exclude_fn is not None and self._current_param is not None \
                and self._exclude_fn(self._current_param):
            wd = 0.0
        update = r + _weak(wd, p) * p
        w_norm = torch.linalg.vector_norm(p.float())
        u_norm = torch.linalg.vector_norm(update.float())
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        p_new = p - lr * ratio * update
        return p_new.to(p.dtype), {
            "moment1": m1, "moment2": m2, "beta1_pow": b1p * self._beta1,
            "beta2_pow": b2p * self._beta2}


class NAdam(Adam):
    def _update_rule(self, p, g, state, lr):
        m1, m2 = self._moments(state, g)
        b1p, b2p = state["beta1_pow"], state["beta2_pow"]
        b1 = self._beta1
        m1_hat = (_up(_weak(b1, m1) * m1, b1p) / (1 - b1p * b1)
                  + _up(_weak(1 - b1, g) * g, b1p) / (1 - b1p))
        m2_hat = _up(m2, b2p) / (1 - b2p)
        p_new = p - lr * m1_hat / (torch.sqrt(m2_hat) + self._epsilon)
        return p_new.to(p.dtype), {
            "moment1": m1, "moment2": m2, "beta1_pow": b1p * b1,
            "beta2_pow": b2p * self._beta2}


class RAdam(Adam):
    def _update_rule(self, p, g, state, lr):
        m1, m2 = self._moments(state, g)
        b1p, b2p = state["beta1_pow"], state["beta2_pow"]
        t = torch.log(b1p) / math.log(self._beta1)     # the step count
        rho_inf = 2.0 / (1 - self._beta2) - 1
        rho_t = rho_inf - 2 * t * b2p / (1 - b2p)
        m1_hat = _up(m1, b1p) / (1 - b1p)
        r = torch.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf)
                       / ((rho_inf - 4) * (rho_inf - 2) * rho_t))
        m2_hat = torch.sqrt(_up(m2, b2p) / (1 - b2p))
        rect = p - lr * r * m1_hat / (m2_hat + self._epsilon)
        p_new = torch.where(rho_t > 5.0, rect, p - lr * m1_hat)
        return p_new.to(p.dtype), {
            "moment1": m1, "moment2": m2, "beta1_pow": b1p * self._beta1,
            "beta2_pow": b2p * self._beta2}


class LBFGS(Optimizer):
    """The reference's LBFGS: ``step(closure)`` evaluates the closure
    (which computes the loss and its gradients) and takes one plain
    gradient step ``p - lr * grad``; without a closure it takes the step
    on the gradients present. No curvature history is kept (nor in the
    reference). ``TrainStep`` applies the same step as this optimizer's
    rule."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-8, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = max_iter

    def _update_rule(self, p, g, state, lr):
        return p - _weak(lr, p) * g, {}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        lr = self.get_lr()
        for p in self._parameter_list:
            if p.grad is not None and p.requires_grad:
                p.copy_(self._update_rule(p.detach(), p.grad, {}, lr)[0])
        return loss
