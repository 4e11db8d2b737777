"""The PyTorch port's optimizers, regularizers and learning-rate
schedulers against the JAX package on the CPU.

A two-layer float32 perceptron (biases, named parameters: the
reference's ``name``, the port's ``param_name``) in each
package starts from the same seeded weights. For each optimizer family
(the twelve optimizers, ``Adam(amsgrad=True)``, ``AdamW``'s
``apply_decay_param_fun``, ``Lamb``'s exclusion function, ``L1Decay`` /
``L2Decay`` regularizers, a scheduler driving the rate) three eager
steps (``loss.backward(); opt.step(); opt.clear_grad()``; LBFGS through
``step(closure)``) give the reference's parameters and accumulators
within 1e-6 relative, under the reference's ``state_dict`` keys. The
port's ``TrainStep`` applies the same rule, with no master weights, to
the same numbers in float32, so it is held to the reference's eager loop
too, and a ``state_dict`` -> ``set_state_dict`` round trip into a fresh
optimizer continues the trajectory bit for bit. ``AdamW(lr_ratio=)``
scales each parameter's rate, as Paddle does (the reference never
applies it). Every scheduler gives the reference's rate over 14 steps
and round-trips its ``state_dict``; ``ReduceOnPlateau`` takes a float or
a 0-d tensor.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import lr as tlr

SHAPES = [("w1", (4, 8)), ("b1", (8,)), ("w2", (8, 3)), ("b2", (3,))]
STEPS = 3


def _data():
    rng = np.random.RandomState(0)
    weights = {n: (0.5 * rng.randn(*s)).astype(np.float32)
               for n, s in SHAPES}
    batches = [(rng.randn(6, 4).astype(np.float32),
                rng.randn(6, 3).astype(np.float32)) for _ in range(STEPS)]
    return weights, batches


class _Mlp(torch.nn.Module):
    """The port's perceptron; ``forward(x, y)`` is the loss."""

    def __init__(self, weights):
        super().__init__()
        # the reference's layer lists its parameters l2 first: the same
        # order gives the same state_dict indices
        self.l2 = Linear(8, 3, device="cpu")
        self.l1 = Linear(4, 8, device="cpu")
        for p, n in zip(self.parameters(), ("w2", "b2", "w1", "b1")):
            with torch.no_grad():
                p.copy_(torch.from_numpy(weights[n]))
            p.param_name = n

    def forward(self, x, y):
        out = self.l2(torch.relu(self.l1(x)))
        return ((out - y) ** 2).mean()


class _RefMlp(paddle.nn.Layer):
    def __init__(self, weights):
        super().__init__()
        self.l1 = paddle.nn.Linear(4, 8)
        self.l2 = paddle.nn.Linear(8, 3)
        names = {"l1.weight": "w1", "l1.bias": "b1", "l2.weight": "w2",
                 "l2.bias": "b2"}
        for key, p in self.named_parameters():
            p.set_value(weights[names[key]])
            p.name = names[key]

    def forward(self, x, y):
        out = self.l2(paddle.nn.functional.relu(self.l1(x)))
        return ((out - y) ** 2).mean()


def _no_decay(name):
    return name not in ("b1", "b2")


def _name(p):
    """A parameter's Paddle name in either package."""
    return getattr(p, "param_name", None) or p.name


def _exclude(p):
    return _name(p) in ("b1", "b2")


# family -> (class name, keyword arguments); "reg" names a regulariser,
# "sched" a scheduler factory over the package's lr module
FAMILIES = {
    "sgd": ("SGD", dict(learning_rate=0.1)),
    "sgd_l1": ("SGD", dict(learning_rate=0.1, reg=("L1Decay", 0.01))),
    "momentum": ("Momentum", dict(learning_rate=0.1, momentum=0.9)),
    "momentum_nesterov_l2": ("Momentum", dict(
        learning_rate=0.1, momentum=0.8, use_nesterov=True,
        reg=("L2Decay", 0.02))),
    "adagrad": ("Adagrad", dict(learning_rate=0.1,
                                initial_accumulator_value=0.1)),
    "adam_sched": ("Adam", dict(sched=lambda m: m.StepDecay(0.05, 2, 0.5))),
    "adam_amsgrad": ("Adam", dict(learning_rate=0.05, amsgrad=True,
                                  weight_decay=0.01)),
    "adamw": ("AdamW", dict(learning_rate=0.05, weight_decay=0.1,
                            apply_decay_param_fun=_no_decay)),
    "adamax": ("Adamax", dict(learning_rate=0.05)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01, momentum=0.5)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, centered=True)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0)),
    "lamb": ("Lamb", dict(learning_rate=0.05, lamb_weight_decay=0.05,
                          exclude_from_weight_decay_fn=_exclude)),
    "nadam": ("NAdam", dict(learning_rate=0.05)),
    "radam": ("RAdam", dict(learning_rate=0.05)),
    "lbfgs": ("LBFGS", dict(learning_rate=0.1)),
}


def _make(pkg, family, params):
    name, kw = FAMILIES[family]
    kw = dict(kw)
    optm, lrm, regm = {"ref": (jopt, jlr, jopt),
                       "port": (topt, tlr, treg)}[pkg]
    if "reg" in kw:
        rname, coeff = kw.pop("reg")
        kw["weight_decay"] = getattr(regm, rname)(coeff)
    if "sched" in kw:
        kw["learning_rate"] = kw.pop("sched")(lrm)
    return getattr(optm, name)(parameters=params, **kw)


def _ref_run(family):
    weights, batches = _data()
    model = _RefMlp(weights)
    opt = _make("ref", family, model.parameters())
    for x, y in batches:
        def closure():
            opt.clear_grad()
            loss = model(paddle.to_tensor(x), paddle.to_tensor(y))
            loss.backward()
            return loss
        if family == "lbfgs":
            opt.step(closure)
        else:
            closure()
            opt.step()
            opt.clear_grad()
        if isinstance(opt._learning_rate, jlr.LRScheduler):
            opt._learning_rate.step()
    params = {p.name: np.asarray(p.numpy()) for p in model.parameters()}
    state = {k: (np.asarray(v.numpy()) if hasattr(v, "numpy") else v)
             for k, v in opt.state_dict().items()}
    return params, state


def _port_run(family, via_train_step=False, resume_at=None):
    weights, batches = _data()
    model = _Mlp(weights)
    opt = _make("port", family, model.parameters())
    step = TrainStep(model, lambda out, a, k: out, opt) \
        if via_train_step else None
    for i, (x, y) in enumerate(batches):
        if i == resume_at:          # a fresh optimizer takes the state
            saved = opt.state_dict()
            opt = _make("port", family, model.parameters())
            opt.set_state_dict(saved)
            if step is not None:
                step = TrainStep(model, lambda out, a, k: out, opt)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        if step is not None:
            step(xt, yt)
        elif family == "lbfgs":
            def closure():
                opt.clear_grad(set_to_zero=False)
                loss = model(xt, yt)
                loss.backward()
                return loss
            opt.step(closure)
        else:
            model(xt, yt).backward()
            opt.step()
            opt.clear_grad(set_to_zero=False)
        if isinstance(opt._learning_rate, tlr.LRScheduler):
            opt._learning_rate.step()
    params = {_name(p): p.detach().numpy().copy()
              for p in model.parameters()}
    return params, opt.state_dict()


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                               err_msg=what)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_optimizer_matches_reference(family):
    want_p, want_s = _ref_run(family)
    for via in (False, True):
        got_p, got_s = _port_run(family, via_train_step=via)
        for n, w in want_p.items():
            _close(got_p[n], w, f"{family} {n} train_step={via}")
        assert set(got_s) == set(want_s), (sorted(got_s), sorted(want_s))
        for k, w in want_s.items():
            if isinstance(w, np.ndarray):
                _close(got_s[k].numpy(), w, f"{family} {k}")
            elif via and k == "@step":  # TrainStep counts LBFGS's too
                assert got_s[k] == STEPS, k
            else:
                assert got_s[k] == w, k
    # a state_dict round trip into a fresh optimizer continues bit for bit
    if family != "lbfgs":
        whole, _ = _port_run(family)
        resumed, _ = _port_run(family, resume_at=2)
        for n in whole:
            assert np.array_equal(resumed[n], whole[n]), n


def test_adamw_lr_ratio_scales_each_parameter():
    weights, batches = _data()
    x, y = (torch.from_numpy(a) for a in batches[0])
    runs = []
    for ratio, lr in ((lambda p: 0.5 if _name(p) == "w1" else 1.0, 0.05),
                      (None, 0.025), (None, 0.05)):
        model = _Mlp(weights)
        opt = topt.AdamW(lr, parameters=model.parameters(), lr_ratio=ratio)
        model(x, y).backward()
        opt.step()
        runs.append({_name(p): p.detach().clone()
                     for p in model.parameters()})
    assert torch.equal(runs[0]["w1"], runs[1]["w1"])
    for n in ("b1", "w2", "b2"):
        assert torch.equal(runs[0][n], runs[2][n])


SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(64, 4, learning_rate=2.0),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, 0.9),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, 0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, 0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, 5, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.5, 10), 4, 0.0, 0.5),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 7], [1.0, 0.5, 0.1]),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.5, 6, 0.01),
    "StepDecay": lambda m: m.StepDecay(0.5, 3, 0.5),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [2, 5, 9], 0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.9 ** e),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.5, patience=1, cooldown=1, factor=0.5),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.5, lambda e: 0.95),
    "OneCycleLR": lambda m: m.OneCycleLR(1.0, 12, three_phase=False),
    "CyclicLR": lambda m: m.CyclicLR(0.1, 1.0, 3, 2, mode="triangular2"),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.5, 3, T_mult=2),
    "LinearLR": lambda m: m.LinearLR(0.5, 8),
}
METRICS = [3.0, 2.0, 2.5, 2.6, 2.7, 1.0, 1.5, 1.6, 1.7, 1.8, 0.5, 0.6, 0.7,
           0.8]


def _rates(sched, plateau, tensor_metric=False):
    out = []
    for i, v in enumerate(METRICS):
        out.append(sched())
        if plateau:
            sched.step(torch.tensor(v) if tensor_metric and i % 2 else v)
        else:
            sched.step()
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_reference(name):
    plateau = name == "ReduceOnPlateau"
    want = _rates(SCHEDULERS[name](jlr), plateau)
    got = _rates(SCHEDULERS[name](tlr), plateau, tensor_metric=True)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # a state_dict taken midway restores into a fresh scheduler
    a = SCHEDULERS[name](tlr)
    for v in METRICS[:5]:
        a.step(v) if plateau else a.step()
    state = a.state_dict()
    ref_state = SCHEDULERS[name](jlr)
    for v in METRICS[:5]:
        ref_state.step(v) if plateau else ref_state.step()
    assert set(state) == set(ref_state.state_dict())
    b = SCHEDULERS[name](tlr)
    b.set_state_dict(dict(state))
    assert _rates(b, plateau) == _rates(a, plateau)


def test_regularizers_match_reference():
    rng = np.random.RandomState(1)
    p, g = rng.randn(5).astype(np.float32), rng.randn(5).astype(np.float32)
    for name in ("L1Decay", "L2Decay"):
        want = getattr(jopt, name)(0.3)._append(
            paddle.to_tensor(p)._data, paddle.to_tensor(g)._data)
        got = getattr(treg, name)(0.3)._append(torch.from_numpy(p),
                                               torch.from_numpy(g))
        _close(got.numpy(), np.asarray(want), name)
        assert repr(getattr(treg, name)(0.3)) == f"{name}(0.3)"
    assert treg.L2Decay is topt.L2Decay


def test_param_groups_alias_the_parameter_list():
    model = _Mlp(_data()[0])
    opt = topt.SGD(0.1, parameters=model.parameters())
    assert opt._param_groups is opt._parameter_list
    opt.set_lr_scheduler(tlr.StepDecay(0.2, 1))
    assert opt.get_lr() == 0.2
