"""The PyTorch port's BERT against the JAX package on the CPU.

A tiny float32 BERT (vocab 96, hidden 128, 2 layers, 2 heads of 64,
dropout 0) of the reference, its biases and LayerNorm parameters drawn
away from their zero / one init and its two encoder layers made to
differ, carried into the port by ``load_jax_params``; the same seeded
ids (B 2, L 32) through both. Unmasked attention runs the plain K1 on
the port's side (a spy counts its forwards) and XLA on the reference's;
a bool padding mask and a float additive mask run both packages' plain
biased recipe. Tolerances (float32): logits and losses rtol 1e-5, atol
1e-5; every gradient atol 1e-5 (the same sums in another order through
2 layers); 3 AdamW steps of the example's recipe (warmup-linear
``LambdaDecay``, global-norm clip 1.0, weight decay 0.01 off biases and
norms by ``apply_decay_param_fun``): losses rtol 1e-5, every parameter
rtol 1e-5, atol 1e-6 (Adam turns a gradient near zero into a whole
step: the elements of a tensor differing past that may be at most 1e-3
of it, and all within 1e-4; the k bias, whose gradient is rounding
noise, within its 3 steps).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import BertForPretraining as JaxPretraining
from paddle_tpu.models.bert import \
    BertForSequenceClassification as JaxClassifier
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     BertForSequenceClassification)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops.kernels import flash_attention as fa

TINY = dict(vocab=96, hidden=128, layers=2, heads=2)
B, L = 2, 32
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(cls):
    cfg = cls.tiny(**TINY)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _draw(ref, seed):
    """Biases and norms away from their init, and the second encoder
    layer away from the first (the reference deep-copies it)."""
    rng = np.random.RandomState(seed)
    for name, p in ref.named_parameters():
        a = np.asarray(p.numpy())
        if name.endswith("bias"):
            a = 0.1 * rng.randn(*a.shape)
        elif "norm" in name:
            a = 1.0 + 0.1 * rng.randn(*a.shape)
        elif ".layers.1." in name:
            a = a + 0.05 * rng.randn(*a.shape)
        p.set_value(a.astype(np.float32))


def _pair(kind, seed=3):
    paddle.seed(seed)
    if kind == "cls":
        ref = JaxClassifier(_cfg(JaxBertConfig), num_classes=3)
        port = BertForSequenceClassification(_cfg(BertConfig), num_classes=3,
                                             device="cpu")
    else:
        ref = JaxPretraining(_cfg(JaxBertConfig))
        port = BertForPretraining(_cfg(BertConfig), device="cpu")
    _draw(ref, seed)
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    return ref, port


@pytest.fixture(scope="module")
def cls_pair():
    return _pair("cls")


@pytest.fixture(scope="module")
def pretrain_pair():
    return _pair("pretrain", seed=5)


def _batch(seed=7):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TINY["vocab"], (B, L)).astype(np.int64)
    types = (np.arange(L)[None, :] >= L // 2).astype(np.int64).repeat(B, 0)
    lens = np.array([L, 19])
    keep = np.arange(L)[None, :] < lens[:, None]
    mlm = np.where(rng.rand(B, L) < 0.3, ids, -100).astype(np.int64)
    return dict(ids=ids, types=types, keep=keep, labels=np.array([2, 0]),
                mlm=mlm, nsp=np.array([1, 0]))


def _masks(kind, keep):
    if kind == "none":
        return None, None
    m = keep[:, None, None, :]
    if kind == "bool":
        return paddle.to_tensor(m), torch.from_numpy(m)
    bias = np.where(m, 0.0, -1e4).astype(np.float32) \
        + 0.1 * np.random.RandomState(1).randn(B, 1, 1, L).astype(np.float32)
    return paddle.to_tensor(bias), torch.from_numpy(bias)


def _t(a):
    return torch.from_numpy(np.asarray(a))


class _K1Spy:
    """Counts the port's K1 forwards (the plain version on the CPU)."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = fa.flash_attention_fwd

        def spy(*a, **k):
            self.n += 1
            return real(*a, **k)
        monkeypatch.setattr(fa, "flash_attention_fwd", spy)


@pytest.mark.parametrize("mask", ["none", "bool", "float"])
def test_classifier_logits_loss_and_gradients_match_reference(
        cls_pair, mask, monkeypatch):
    ref, port = cls_pair
    b = _batch()
    m_r, m_p = _masks(mask, b["keep"])
    spy = _K1Spy(monkeypatch)
    logits_r = ref(paddle.to_tensor(b["ids"]), paddle.to_tensor(b["types"]),
                   attention_mask=m_r)
    logits_p = port(_t(b["ids"]), _t(b["types"]), attention_mask=m_p)
    np.testing.assert_allclose(logits_p.detach().numpy(),
                               np.asarray(logits_r.numpy()), **TOL)
    assert spy.n == (TINY["layers"] if mask == "none" else 0)
    for p in ref.parameters():
        p.clear_grad()
    port.zero_grad()
    loss_r = ref(paddle.to_tensor(b["ids"]), paddle.to_tensor(b["types"]),
                 attention_mask=m_r, labels=paddle.to_tensor(b["labels"]))
    loss_r.backward()
    loss_p = port(_t(b["ids"]), _t(b["types"]), attention_mask=m_p,
                  labels=_t(b["labels"]))
    loss_p.backward()
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_r.numpy()),
                               **TOL)
    grads = {n: np.asarray(p.grad.numpy()) for n, p in ref.named_parameters()}
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name], atol=1e-5,
                                   err_msg=name)


def test_pretraining_logits_loss_and_gradients_match_reference(
        pretrain_pair):
    ref, port = pretrain_pair
    b = _batch(11)
    mlm_r, nsp_r = ref(paddle.to_tensor(b["ids"]),
                       paddle.to_tensor(b["types"]))
    mlm_p, nsp_p = port(_t(b["ids"]), _t(b["types"]))
    np.testing.assert_allclose(mlm_p.detach().numpy(),
                               np.asarray(mlm_r.numpy()), **TOL)
    np.testing.assert_allclose(nsp_p.detach().numpy(),
                               np.asarray(nsp_r.numpy()), **TOL)
    for p in ref.parameters():
        p.clear_grad()
    port.zero_grad()
    loss_r = ref(paddle.to_tensor(b["ids"]), paddle.to_tensor(b["types"]),
                 labels=paddle.to_tensor(b["mlm"]),
                 next_sentence_label=paddle.to_tensor(b["nsp"]))
    loss_r.backward()
    loss_p = port(_t(b["ids"]), _t(b["types"]), labels=_t(b["mlm"]),
                  next_sentence_label=_t(b["nsp"]))
    loss_p.backward()
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_r.numpy()),
                               **TOL)
    grads = {n: np.asarray(p.grad.numpy()) for n, p in ref.named_parameters()}
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name], atol=1e-5,
                                   err_msg=name)


def test_parameters_and_quirks_follow_reference(cls_pair, pretrain_pair):
    """Names and shapes are the reference's; the encoder LayerNorms take
    eps 1e-5 and only the embeddings' ``layer_norm_eps``; every encoder
    layer starts as a copy of the first; the MLM head is one Linear."""
    for ref, port in (cls_pair, pretrain_pair):
        want = {n: tuple(p.shape) for n, p in ref.named_parameters()}
        assert {n: tuple(p.shape) for n, p in port.named_parameters()} \
            == want
    fresh = BertForPretraining(BertConfig.tiny(**TINY), device="cpu")
    layers = fresh.bert.encoder.layers
    for (n, a), (_, b) in zip(layers[0].named_parameters(),
                              layers[1].named_parameters()):
        assert torch.equal(a, b), n
    assert fresh.bert.embeddings.layer_norm._epsilon == 1e-12
    assert layers[0].norm1._epsilon == layers[1].norm2._epsilon == 1e-5
    assert type(fresh.mlm_head).__name__ == "Linear"
    assert fresh.mlm_head.weight.shape == (TINY["hidden"], TINY["vocab"])
    # the defaults, as the reference's layers draw them
    emb = fresh.bert.embeddings.word_embeddings.weight
    assert abs(float(emb.std()) - 1.0) < 0.05
    q = layers[0].self_attn.q_proj
    assert abs(float(q.weight.std()) - (2 / (2 * TINY["hidden"])) ** 0.5) \
        < 0.01 and float(q.bias.abs().max()) == 0.0


def test_seeded_construction_and_device_default():
    a = BertForSequenceClassification(BertConfig.tiny(**TINY), device="cpu",
                                      seed=4)
    b = BertForSequenceClassification(BertConfig.tiny(**TINY), device="cpu",
                                      seed=4)
    c = BertForSequenceClassification(BertConfig.tiny(**TINY), device="cpu",
                                      seed=5)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["classifier.weight"], sc["classifier.weight"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BertForSequenceClassification(BertConfig.tiny(**TINY))


def _recipe(params, lib, clip, names, steps=3):
    """The example's AdamW: warmup-linear LambdaDecay over ``steps``,
    global-norm clip 1.0, decay 0.01 off biases and norms."""
    decay = [n for n in names if not any(k in n for k in ("bias", "norm"))]
    sched = lib.lr.LambdaDecay(
        learning_rate=1e-3,
        lr_lambda=lambda s: min((s + 1) / 2, max(0.0, (steps - s) / 1)))
    return lib.AdamW(learning_rate=sched, parameters=params,
                     weight_decay=0.01,
                     apply_decay_param_fun=lambda n: n in decay,
                     grad_clip=clip, epsilon=1e-8), sched


def test_adamw_trajectory_matches_reference(cls_pair):
    """Last of the file: it trains the module's pair."""
    ref, port = cls_pair
    names = [n for n, _ in ref.named_parameters()]
    for n, p in ref.named_parameters():
        p.name = n
    for n, p in port.named_parameters():
        p.param_name = n
    opt_r, sch_r = _recipe(ref.parameters(), paddle.optimizer,
                           paddle.nn.ClipGradByGlobalNorm(1.0), names)
    opt_p, sch_p = _recipe(list(port.parameters()), popt,
                           ClipGradByGlobalNorm(1.0), names)
    b = _batch(17)
    losses_r, losses_p = [], []
    for _ in range(3):
        loss_r = ref(paddle.to_tensor(b["ids"]),
                     labels=paddle.to_tensor(b["labels"]))
        loss_r.backward()
        opt_r.step()
        opt_r.clear_grad()
        sch_r.step()
        losses_r.append(float(loss_r.numpy()))
        loss_p = port(_t(b["ids"]), labels=_t(b["labels"]))
        loss_p.backward()
        opt_p.step()
        opt_p.clear_grad()
        sch_p.step()
        losses_p.append(float(loss_p.detach()))
    np.testing.assert_allclose(losses_p, losses_r, rtol=1e-5)
    want = {n: np.asarray(p.numpy()) for n, p in ref.named_parameters()}
    # the k bias's gradient is zero but for rounding (softmax ignores a
    # shift shared by a row), so Adam steps it by noise: the two packages
    # may differ by twice its 3 steps, each at most 3.2 x the rate
    # ((1 - beta1) / sqrt(1 - beta2))
    k_bias = 2 * 3.2 * (5e-4 + 1e-3 + 1e-3)
    for name, p in port.named_parameters():
        got = p.detach().numpy()
        if name.endswith("k_proj.bias"):
            np.testing.assert_allclose(got, want[name], atol=k_bias)
            continue
        off = ~np.isclose(got, want[name], rtol=1e-5, atol=1e-6)
        assert off.mean() <= 1e-3, (name, off.sum())
        np.testing.assert_allclose(got, want[name], atol=1e-4, err_msg=name)
