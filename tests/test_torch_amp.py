"""The port's AMP against the JAX package's on the CPU.

O1 casts by op name in both packages. On the tiny BERT of
``test_torch_bert.py`` (dropout 0, float32 weights carried across) each
named op's inputs as O1 casts them (``linear``, ``flash_attention``,
``layer_norm``, ``gelu``, ``tanh``, ``embedding``, ``cross_entropy``, in
call order) and every sub-layer's output dtype equal the reference's,
under the default lists, custom white and black lists and nested
contexts. The O1 loss agrees with the reference's within 2e-2 relative
(both round the white ops to bfloat16 on the CPU, with other sums).
``decorate`` O2 gives bfloat16 parameters and ``multi_precision`` (float32
master weights after a step); ``GradScaler``'s scale over 8 steps with
non-finite gradients injected at steps 1, 4 and 5 equals the
reference's step for step, and a skipped step leaves the weights.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.framework import core as jcore
from paddle_tpu.framework.core import as_jax
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import \
    BertForSequenceClassification as JaxClassifier
import paddle_tpu_torch
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.models import BertConfig, BertForSequenceClassification
from paddle_tpu_torch.nn import Linear

TINY = dict(vocab=96, hidden=128, layers=2, heads=2)
NAMED = {"linear", "flash_attention", "layer_norm", "gelu", "tanh",
         "embedding", "cross_entropy", "softmax"}
LOSS_RTOL = 2e-2


def _cfg(cls):
    cfg = cls.tiny(**TINY)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


@pytest.fixture(scope="module")
def bert_pair():
    paddle.seed(3)
    ref = JaxClassifier(_cfg(JaxBertConfig))
    port = BertForSequenceClassification(_cfg(BertConfig), device="cpu")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    rng = np.random.RandomState(5)
    ids = rng.randint(0, TINY["vocab"], (2, 32)).astype(np.int64)
    return ref, port, ids, np.array([1, 0])


def _name(dtype):
    return str(dtype).replace("torch.", "")


CONTEXTS = {
    "default": [dict()],
    "custom_white": [dict(custom_white_list={"gelu", "tanh"})],
    "custom_black": [dict(custom_black_list={"embedding", "gelu"})],
    "nested": [dict(custom_black_list={"tanh"}),
               dict(custom_white_list={"gelu", "embedding"})],
    "inner_off": [dict(), dict(enable=False)],
}


def _run(lib, model, ids, labels, ctxs, to_in):
    """The loss under the nested ``auto_cast`` contexts, with each
    sub-layer's output dtype by name."""
    outs = {}
    handles = []
    for name, layer in model.named_sublayers():
        def hook(layer, inputs, out, name=name):
            o = out[0] if isinstance(out, tuple) else out
            outs[name] = _name(o.dtype) if isinstance(o, torch.Tensor) \
                else str(as_jax(o).dtype)
        handles.append(layer.register_forward_post_hook(hook))
    managers = [lib.auto_cast(level="O1", dtype="bfloat16", **c)
                for c in ctxs]
    for m in managers:
        m.__enter__()
    try:
        loss = model(to_in(ids), labels=to_in(labels))
    finally:
        for m in reversed(managers):
            m.__exit__(None, None, None)
        for h in handles:
            h.remove()
    return loss, outs


@pytest.mark.parametrize("ctx", sorted(CONTEXTS))
def test_o1_casts_what_the_reference_casts(bert_pair, ctx, monkeypatch):
    ref, port, ids, labels = bert_pair
    rec_r, rec_p = [], []

    def ref_hook(op, arrays):
        arrays = jamp._cast_for_op(op, arrays)
        if op in NAMED:
            rec_r.append((op, [str(a.dtype) for a in arrays
                               if hasattr(a, "dtype")
                               and "float" in str(a.dtype)]))
        return arrays
    real = amp.cast_inputs

    def port_hook(op, *xs):
        xs = real(op, *xs)
        if op in NAMED:
            rec_p.append((op, [_name(x.dtype) for x in xs
                               if isinstance(x, torch.Tensor)
                               and x.is_floating_point()]))
        return xs
    monkeypatch.setattr(amp, "cast_inputs", port_hook)
    jcore.set_amp_hook(ref_hook)
    try:
        loss_r, outs_r = _run(jamp, ref, ids, labels, CONTEXTS[ctx],
                              paddle.to_tensor)
    finally:
        jcore.set_amp_hook(jamp._cast_for_op)
    loss_p, outs_p = _run(amp, port, ids, labels, CONTEXTS[ctx],
                          lambda a: torch.from_numpy(np.asarray(a)))
    assert len(rec_p) > 10 and rec_p == rec_r
    assert outs_p == outs_r
    assert _name(loss_p.dtype) == str(as_jax(loss_r).dtype)
    np.testing.assert_allclose(float(loss_p.detach()),
                               float(np.asarray(loss_r.numpy())),
                               rtol=LOSS_RTOL)
    if ctx == "default":
        assert outs_p["bert.encoder.layers.0.linear1"] == "bfloat16"
        assert outs_p["bert.encoder.layers.0.norm1"] == "float32"
    # nothing leaks out of the contexts
    assert not amp.amp_state().enabled and amp.amp_state().white is None


def test_o1_gradients_reach_float32_parameters(bert_pair):
    _, port, ids, labels = bert_pair
    port.zero_grad()
    with amp.auto_cast(level="O1"):
        loss = port(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    for name, p in port.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all(), name


def test_decorate_o2_matches_reference():
    paddle.seed(7)
    ref = JaxClassifier(_cfg(JaxBertConfig))
    port = BertForSequenceClassification(_cfg(BertConfig), device="cpu")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    opt_r = paddle.optimizer.AdamW(1e-3, parameters=ref.parameters())
    opt_p = popt.AdamW(1e-3, parameters=port.parameters())
    ref, opt_r = jamp.decorate(ref, opt_r, level="O2", dtype="bfloat16")
    port2, opt2 = amp.decorate(port, opt_p, level="O2", dtype="bfloat16")
    assert port2 is port and opt2 is opt_p
    assert opt_p._multi_precision and opt_r._multi_precision
    for (n, p), (_, q) in zip(sorted(port.named_parameters()),
                              sorted(ref.named_parameters())):
        assert p.dtype == torch.bfloat16
        assert str(as_jax(q).dtype) == "bfloat16", n
    ids = np.random.RandomState(8).randint(0, TINY["vocab"], (2, 16))
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    loss = port(torch.from_numpy(ids), labels=torch.tensor([0, 1]))
    assert loss.dtype == torch.bfloat16
    loss.backward()
    opt_p.step()
    masters = opt_p._master_weights
    assert len(masters) == len(before) and all(
        m.dtype == torch.float32 for m in masters.values())
    assert any(not torch.equal(p, before[n])
               for n, p in port.named_parameters())
    assert amp.decorate(Linear(2, 2, device="cpu"), level="O2").weight.dtype \
        == torch.bfloat16


INF_STEPS = (1, 4, 5)


def _scaler_run(lib, make_param, set_grad, opt_of):
    scaler = lib.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2,
                            decr_every_n_nan_or_inf=1)
    p = make_param()
    opt = opt_of(p)
    scales = []
    for step in range(8):
        g = np.full((3, 2), 0.5 * scaler.get_init_loss_scaling(),
                    np.float32)
        if step in INF_STEPS:
            g[1, 0] = np.inf if step != 5 else np.nan
        set_grad(p, g)
        scaler.step(opt)
        scaler.update()
        scales.append(scaler.get_init_loss_scaling())
    return scales, scaler.state_dict()


def test_grad_scaler_scale_trajectory_matches_reference():
    def port_param():
        return torch.nn.Parameter(torch.ones(3, 2))

    def port_set(p, g):
        p.grad = torch.from_numpy(g)

    scales_p, state_p = _scaler_run(
        amp, port_param, port_set,
        lambda p: popt.SGD(0.1, parameters=[p]))

    def ref_param():
        return paddle.create_parameter([3, 2], "float32",
                                       default_initializer=paddle.nn.
                                       initializer.Constant(1.0))

    def ref_set(p, g):
        p._grad = paddle.to_tensor(g)

    scales_r, state_r = _scaler_run(
        jamp, ref_param, ref_set,
        lambda p: paddle.optimizer.SGD(0.1, parameters=[p]))
    assert scales_p == scales_r
    assert state_p == state_r
    # a skipped step leaves the weights; a good one moves them by the
    # unscaled gradient
    p = torch.nn.Parameter(torch.ones(2))
    opt = popt.SGD(0.1, parameters=[p])
    scaler = amp.GradScaler(init_loss_scaling=4.0)
    p.grad = torch.tensor([float("inf"), 1.0])
    scaler.step(opt)
    scaler.update()
    assert torch.equal(p.detach(), torch.ones(2))
    assert scaler.get_init_loss_scaling() == 2.0
    loss = scaler.scale((p * torch.tensor([1.0, 2.0])).sum())
    p.grad = None
    loss.backward()
    scaler.step(opt)
    scaler.update()
    assert torch.allclose(p.detach(), torch.tensor([0.9, 0.8]))
    with pytest.raises(RuntimeError, match="already been called"):
        scaler.unscale_(opt)
        scaler.unscale_(opt)


def test_amp_is_exported_and_reports_support():
    assert paddle_tpu_torch.amp is amp
    assert amp.is_bfloat16_supported("cpu") and amp.is_float16_supported()
    assert amp.autocast is amp.auto_cast and amp.amp_guard is amp.auto_cast
    assert amp.white_list == jamp.white_list
    assert amp.black_list == jamp.black_list
