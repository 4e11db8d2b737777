"""The port's training path against the JAX package on the CPU — the
slice as a whole.

A seeded tiny JAX ``LlamaForCausalLM`` gives its weights to the port's
model through ``load_jax_params``; then, in float32:

- the dense loss and every parameter's gradient against the reference's
  ``loss.backward()`` (loss rtol 1e-6; gradients atol 2e-6, the same
  sums in another order), with ``config.recompute`` at
  ``recompute_interval`` 1 and 2 too (one reference backward for all
  three, a module fixture);
- five ``TrainStep`` steps of AdamW (weight decay 0.01): the loss
  trajectory (rtol 1e-5) and the final parameters against the
  reference's compiled ``TrainStep``: all but 1e-4 of each tensor's
  elements within 2e-6, and every element within 5e-5 (5% of one step
  at lr 1e-3: on the first step Adam moves by ``lr * g / (|g| + eps)``,
  which turns the last bits of a gradient within a few eps of zero into
  a visible part of a step);
- the eager loop (``loss.backward(); opt.step(); opt.clear_grad()``)
  with ``ClipGradByGlobalNorm`` and ``LinearWarmup`` against the
  reference's eager loop (the same tolerances).

The optimizer on bfloat16 parameters is pinned with gradients made
exactly equal in both packages: ``_update_rule`` on a bf16 parameter
with float32 moments (bitwise, state within 1e-6 relative),
``TrainStep`` keeping no master weights (within one bf16 ulp: the
reference compiles the step, and XLA's fused elementwise chain skips
some of the intermediate bf16 roundings that an op-by-op evaluation
makes), and the eager ``AdamW.step()`` keeping float32 master weights
(1e-6 relative).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework.core import as_jax
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer.lr import LinearWarmup as JaxWarmup
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaPretrainingCriterion)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, Linear
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay, LinearWarmup

TINY = dict(vocab=128, hidden=256, layers=2, heads=4, kv_heads=2, ffn=256)
B, L = 2, 16


def _pair():
    paddle.seed(7)
    ref = JaxLlama(JaxLlamaConfig.tiny(**TINY))
    ref.train()
    port = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    return ref, port


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, TINY["vocab"], size=(B, L)).astype(np.int64)
        out.append((ids, np.roll(ids, -1, axis=1)))
    return out


def _ref_params(model):
    return {n: np.asarray(p.numpy()) for n, p in model.named_parameters()}


def _port_params(model):
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def _assert_params_close(port, ref):
    want = _ref_params(ref)
    for name, arr in _port_params(port).items():
        d = np.abs(arr - want[name])
        assert d.max() <= 5e-5, (name, float(d.max()))
        assert (d > 2e-6).sum() <= 1e-4 * d.size, (name, int((d > 2e-6)
                                                            .sum()))


@pytest.fixture(scope="module")
def dense_reference():
    """The reference's dense loss and every gradient on one batch (rows
    of ``ignore_index`` included), with its weights and its logits: one
    reference backward shared by the tests that hold the port to it."""
    ref, _ = _pair()
    ids, labels = _batches(1)[0]
    labels[0, :3] = -100                        # ignore_index rows count 0
    loss_r = ref(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss_r.backward()
    return dict(
        ids=ids, labels=labels, loss=float(loss_r.numpy()),
        grads={n: p.grad.numpy() for n, p in ref.named_parameters()},
        weights={k: np.asarray(v) for k, v in ref.state_dict().items()},
        logits=ref(paddle.to_tensor(ids)).numpy())


def _port_from(weights, **config):
    cfg = LlamaConfig.tiny(**TINY)
    for k, v in config.items():
        setattr(cfg, k, v)
    port = LlamaForCausalLM(cfg, device="cpu")
    load_jax_params(port, weights)
    return port


def test_dense_loss_and_every_gradient_match_reference(dense_reference):
    r = dense_reference
    ids, labels = r["ids"], r["labels"]
    port = _port_from(r["weights"])
    loss_p = port(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss_p.backward()
    np.testing.assert_allclose(float(loss_p.detach()), r["loss"], rtol=1e-6)
    grads_r = r["grads"]
    n_checked = 0
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads_r[name], atol=2e-6,
                                   rtol=0, err_msg=name)
        n_checked += 1
    assert n_checked == len(grads_r) == 2 + 1 + 9 * TINY["layers"]
    # logits without labels: the dense forward itself
    with torch.no_grad():
        logits = port(torch.from_numpy(ids))
    np.testing.assert_allclose(logits.numpy(), r["logits"], atol=1e-5)


@pytest.mark.parametrize("interval", [1, 2])
def test_recompute_loss_and_every_gradient_match_reference(dense_reference,
                                                           interval):
    """``config.recompute`` at ``recompute_interval`` 1 and 2 (every and
    every other decoder layer recomputed in the backward): the
    reference's loss and every gradient at the dense test's tolerances
    (the reference's own recompute replays the same function, so its
    numbers are these), and the port's plain run's bit for bit."""
    r = dense_reference
    ids, labels = (torch.from_numpy(a) for a in (r["ids"], r["labels"]))
    port = _port_from(r["weights"], recompute=True,
                      recompute_interval=interval)
    runs = []
    for on in (True, False):
        port.config.recompute = on
        port.zero_grad(set_to_none=True)
        loss = port(ids, labels=labels)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad.clone()
                                     for n, p in port.named_parameters()}))
    (loss, grads), (loss0, grads0) = runs
    np.testing.assert_allclose(float(loss), r["loss"], rtol=1e-6)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), r["grads"][name], atol=2e-6,
                                   rtol=0, err_msg=name)
        assert torch.equal(g, grads0[name]), name
    assert torch.equal(loss, loss0)


def test_criterion_matches_reference_recipe():
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 5, 40).astype(np.float32) * 3
    labels = rng.randint(0, 40, size=(2, 5))
    labels[1, 2] = -100
    from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCE
    want = float(JaxCE()(paddle.to_tensor(logits),
                         paddle.to_tensor(labels)).numpy())
    got = LlamaPretrainingCriterion()(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert float(LlamaPretrainingCriterion()(
        torch.from_numpy(logits), torch.full((2, 5), -100))) == 0.0


def test_train_step_trajectory_matches_reference():
    ref, port = _pair()
    opt_r = JaxAdamW(1e-3, parameters=ref.parameters(), weight_decay=0.01)
    opt_p = AdamW(1e-3, parameters=port.parameters(), weight_decay=0.01)
    step_r = JaxTrainStep(ref, lambda out, a, k: out, opt_r)
    step_p = TrainStep(port, lambda out, a, k: out, opt_p)
    losses_r, losses_p = [], []
    for ids, labels in _batches(5, seed=1):
        losses_r.append(float(step_r(paddle.to_tensor(ids),
                                     paddle.to_tensor(labels)).numpy()))
        losses_p.append(float(step_p(ids, labels)))     # numpy batch
    np.testing.assert_allclose(losses_p, losses_r, rtol=1e-5)
    assert losses_p[-1] < losses_p[0]
    assert opt_p._step_count == opt_r._step_count == 5
    _assert_params_close(port, ref)


def test_eager_loop_with_clip_and_warmup_matches_reference():
    ref, port = _pair()
    sched_r = JaxWarmup(2e-3, 2, 0.0, 2e-3)
    sched_p = LinearWarmup(2e-3, 2, 0.0, 2e-3)
    opt_r = JaxAdamW(sched_r, parameters=ref.parameters(),
                     grad_clip=JaxClip(0.5), weight_decay=0.01)
    opt_p = AdamW(sched_p, parameters=port.parameters(),
                  grad_clip=ClipGradByGlobalNorm(0.5), weight_decay=0.01)
    for ids, labels in _batches(3, seed=2):
        loss_r = ref(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        loss_r.backward()
        opt_r.step()
        opt_r.clear_grad()
        sched_r.step()
        loss_p = port(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss_p.backward()
        opt_p.step()
        opt_p.clear_grad()
        sched_p.step()
        np.testing.assert_allclose(float(loss_p.detach()), float(loss_r.numpy()),
                                   rtol=1e-5)
        assert opt_p.get_lr() == opt_r.get_lr()
    _assert_params_close(port, ref)


def test_schedulers_match_reference():
    from paddle_tpu.optimizer.lr import CosineAnnealingDecay as JaxCos
    a = LinearWarmup(CosineAnnealingDecay(3e-4, T_max=10), 3, 0.0, 3e-4)
    b = JaxWarmup(JaxCos(3e-4, T_max=10), 3, 0.0, 3e-4)
    for _ in range(14):
        assert a() == b()
        a.step()
        b.step()
    opt = AdamW(a, parameters=[torch.nn.Parameter(torch.zeros(2))])
    assert opt.get_lr() == a()
    with pytest.raises(RuntimeError, match="scheduler"):
        opt.set_lr(1.0)


# -- bfloat16 parameters: the optimizer with identical gradients --------

BF = torch.bfloat16


def _bf16(a):
    """numpy float32 values that bfloat16 represents exactly."""
    return torch.from_numpy(a).to(BF).float().numpy()


def _ulp_close(got_bf16, want, what):
    got = got_bf16.float().numpy()
    want = np.asarray(want, np.float32)
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    bad = np.abs(got - want) > ulp
    assert not bad.any(), f"{what}: {bad.sum()} elements beyond one ulp"


def test_update_rule_bf16_param_with_fp32_moments_matches_reference():
    rng = np.random.RandomState(5)
    w0 = _bf16(rng.randn(16, 24).astype(np.float32) * 0.05)
    ref_p = paddle.create_parameter([16, 24], dtype="bfloat16")
    ref_p._data = jnp.asarray(w0, jnp.bfloat16)
    port_p = torch.nn.Parameter(torch.from_numpy(w0).to(BF))
    opt_r = JaxAdamW(3e-2, parameters=[ref_p], weight_decay=0.1,
                     multi_precision=True)
    opt_p = AdamW(3e-2, parameters=[port_p], weight_decay=0.1,
                  multi_precision=True)
    st_r, st_p = opt_r._state_for(ref_p), opt_p._state_for(port_p)
    assert st_p["moment1"].dtype == torch.float32
    assert float(st_p["beta1_pow"]) == float(st_r["beta1_pow"]) == \
        np.float32(0.9)
    p_r, p_p = as_jax(ref_p), port_p.detach()
    for i in range(2):
        g = _bf16(rng.randn(16, 24).astype(np.float32))
        p_r, st_r = opt_r._update_rule(p_r, jnp.asarray(g, jnp.bfloat16),
                                       st_r, 3e-2)
        p_p, st_p = opt_p._update_rule(p_p, torch.from_numpy(g).to(BF),
                                       st_p, 3e-2)
        assert p_p.dtype == BF and st_p["moment1"].dtype == torch.float32
        np.testing.assert_array_equal(
            p_p.float().numpy(), np.asarray(p_r.astype(jnp.float32)))
        for k in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
            np.testing.assert_allclose(st_p[k].numpy(), np.asarray(st_r[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)


def _bf16_linear_pair(rng):
    w0 = _bf16(rng.randn(8, 12).astype(np.float32) * 0.1)
    ref = paddle.nn.Linear(8, 12, bias_attr=False)
    ref.to(dtype="bfloat16")
    ref.weight._data = jnp.asarray(w0, jnp.bfloat16)
    port = Linear(8, 12, bias_attr=False, device="cpu", dtype=BF)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w0).to(BF))
    return ref, port


def test_train_step_keeps_no_master_weights_like_reference():
    """``TrainStep`` with ``multi_precision=True`` updates the bf16
    parameter itself (moments float32, no master copy), in both
    packages. Inputs are small integers, so the gradient ``x^T 1`` is
    exact in bf16 on both sides."""
    rng = np.random.RandomState(6)
    ref, port = _bf16_linear_pair(rng)
    x = rng.randint(-3, 4, size=(5, 8)).astype(np.float32)
    opt_r = JaxAdamW(1e-2, parameters=ref.parameters(), weight_decay=0.01,
                     multi_precision=True)
    opt_p = AdamW(1e-2, parameters=port.parameters(), weight_decay=0.01,
                  multi_precision=True)
    step_r = JaxTrainStep(ref, lambda out, a, k: out.sum(), opt_r)
    step_p = TrainStep(port, lambda out, a, k: out.float().sum(), opt_p)
    for _ in range(2):
        step_r(paddle.to_tensor(x).astype("bfloat16"))
        step_p(torch.from_numpy(x).to(BF))
    assert opt_r._master_weights == {} and opt_p._master_weights == {}
    m1 = opt_p._accumulators["moment1"][id(port.weight)]
    assert m1.dtype == torch.float32 and port.weight.dtype == BF
    _ulp_close(port.weight.detach(),
               np.asarray(as_jax(ref.weight).astype(jnp.float32)),
               "TrainStep bf16 weight")


def test_eager_step_keeps_fp32_master_weights_like_reference():
    """The eager ``AdamW.step()`` under ``multi_precision`` updates a
    float32 master copy and rounds it into the bf16 parameter, with the
    global-norm clip and warmup, in both packages."""
    rng = np.random.RandomState(8)
    ref, port = _bf16_linear_pair(rng)
    sched_r, sched_p = JaxWarmup(1e-2, 2, 0.0, 1e-2), \
        LinearWarmup(1e-2, 2, 0.0, 1e-2)
    opt_r = JaxAdamW(sched_r, parameters=ref.parameters(), weight_decay=0.1,
                     multi_precision=True, grad_clip=JaxClip(1.0))
    opt_p = AdamW(sched_p, parameters=port.parameters(), weight_decay=0.1,
                  multi_precision=True,
                  grad_clip=ClipGradByGlobalNorm(1.0))
    for _ in range(3):
        x = rng.randint(-3, 4, size=(5, 8)).astype(np.float32)
        ref(paddle.to_tensor(x).astype("bfloat16")).sum().backward()
        port(torch.from_numpy(x).to(BF)).float().sum().backward()
        opt_r.step()
        opt_p.step()
        opt_r.clear_grad()
        opt_p.clear_grad()
        sched_r.step()
        sched_p.step()
    master_r = np.array(opt_r._master_weights[id(ref.weight)])
    master_p = opt_p._master_weights[id(port.weight)]
    assert master_p.dtype == torch.float32
    np.testing.assert_allclose(master_p.numpy(), master_r, rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_array_equal(
        port.weight.detach().float().numpy(),
        torch.from_numpy(master_r).to(BF).float().numpy())
