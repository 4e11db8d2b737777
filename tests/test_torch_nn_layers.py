"""The port's ``nn`` layers against the JAX package on the CPU: the
transformer stack (encoder, decoder, ``Transformer``, ``MultiHeadAttention``
with its incremental and static caches), every ported loss, activation,
container, clip and deterministic initializer, and ``Layer``'s Paddle API.

Inputs are seeded with numpy and weights carried across by name. Float32
tolerances: elementwise functions and losses rtol 1e-5, atol 1e-6 (one
op in another library); the transformer stacks rtol 1e-5, atol 1e-5 (two
layers of sums in another order); incremental decoding against one full
forward inside the port atol 1e-5. The random initializers are held by
shape, bounds and moments (over 40k draws: mean within 0.02 of the
scale, std within 3 %), and two draws under one seeded generator are
equal bit for bit.
"""
import collections
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import initializer as jinit
from paddle_tpu_torch import nn
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as pinit

EW = dict(rtol=1e-5, atol=1e-6)
STACK = dict(rtol=1e-5, atol=1e-5)
D, H = 128, 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return paddle.to_tensor(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x.numpy())


def _load(port, ref):
    port.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in ref.state_dict().items()}, "cpu"))


def _perturb(ref, seed):
    rng = np.random.RandomState(seed)
    for name, p in ref.named_parameters():
        a = np.asarray(p.numpy())
        if name.endswith("bias"):
            a = 0.1 * rng.randn(*a.shape)
        elif "norm" in name:
            a = 1.0 + 0.1 * rng.randn(*a.shape)
        else:
            a = a + 0.05 * rng.randn(*a.shape)
        p.set_value(a.astype(np.float32))


# ----------------------------------------------------------- transformer

@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_matches_reference(normalize_before):
    paddle.seed(1)
    kw = dict(d_model=D, nhead=H, num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=2 * D, dropout=0.0,
              normalize_before=normalize_before)
    ref = paddle.nn.Transformer(**kw)
    _perturb(ref, 2)
    port = nn.Transformer(**kw, device="cpu")
    _load(port, ref)
    rng = np.random.RandomState(3)
    src, tgt = rng.randn(2, 12, D), rng.randn(2, 7, D)
    src, tgt = src.astype(np.float32), tgt.astype(np.float32)
    mask_r = ref.generate_square_subsequent_mask(7)
    mask_p = port.generate_square_subsequent_mask(7)
    np.testing.assert_array_equal(_np(mask_p), _np(mask_r))
    out_r = ref(_j(src), _j(tgt), tgt_mask=mask_r)
    out_p = port(_t(src), _t(tgt), tgt_mask=mask_p)
    np.testing.assert_allclose(_np(out_p), _np(out_r), **STACK)
    # the encoder alone, with a bool padding mask, and its gradients
    keep = np.arange(12)[None, None, None, :] < np.array([12, 5])[
        :, None, None, None]
    enc_r = ref.encoder(_j(src), _j(keep))
    enc_p = port.encoder(_t(src), _t(keep))
    np.testing.assert_allclose(_np(enc_p), _np(enc_r), **STACK)
    enc_r.sum().backward()
    enc_p.sum().backward()
    grads = {n: _np(p.grad) for n, p in ref.encoder.named_parameters()}
    for n, p in port.encoder.named_parameters():
        np.testing.assert_allclose(_np(p.grad), grads[n], atol=1e-4,
                                   rtol=1e-5, err_msg=n)


def _mha_pair(seed=4):
    paddle.seed(seed)
    ref = paddle.nn.MultiHeadAttention(D, H)
    _perturb(ref, seed)
    port = nn.MultiHeadAttention(D, H, device="cpu")
    _load(port, ref)
    return ref, port


def test_mha_incremental_cache_equals_full_forward():
    """Three one-token steps against a growing ``Cache`` (K1 at Lq = 1
    over 1, 2, 3 keys, non-causal) equal one causal-masked forward, and
    the reference's own incremental steps."""
    ref, port = _mha_pair()
    x = np.random.RandomState(5).randn(2, 3, D).astype(np.float32)
    causal = np.where(np.tril(np.ones((3, 3), bool)), 0.0, -1e9)
    full = port(_t(x), attn_mask=_t(causal.astype(np.float32)))
    cache_p = port.gen_cache(_t(x))
    cache_r = ref.gen_cache(_j(x))
    for t in range(3):
        step = x[:, t:t + 1]
        out_p, cache_p = port(_t(step), _t(step), _t(step), None, cache_p)
        out_r, cache_r = ref(_j(step), _j(step), _j(step), None, cache_r)
        assert cache_p.k.shape == (2, t + 1, H, D // H)
        np.testing.assert_allclose(_np(out_p)[:, 0], _np(full)[:, t],
                                   atol=1e-5)
        np.testing.assert_allclose(_np(out_p), _np(out_r), **STACK)


def test_mha_static_cache_and_cross_attention():
    ref, port = _mha_pair(6)
    rng = np.random.RandomState(7)
    q = rng.randn(2, 5, D).astype(np.float32)
    mem = rng.randn(2, 9, D).astype(np.float32)
    static_p = port.gen_cache(_t(mem), _t(mem), nn.MultiHeadAttention.
                              StaticCache)
    static_r = ref.gen_cache(_j(mem), _j(mem),
                             paddle.nn.MultiHeadAttention.StaticCache)
    out_p = port(_t(q), _t(mem), _t(mem), None, static_p)
    np.testing.assert_allclose(_np(out_p), _np(port(_t(q), _t(mem),
                                                    _t(mem))), atol=1e-6)
    out_r = ref(_j(q), _j(mem), _j(mem), None, static_r)
    np.testing.assert_allclose(_np(out_p), _np(out_r), **STACK)


# ---------------------------------------------------------------- losses

def _loss_cases():
    r = np.random.RandomState(11)
    f = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    prob = lambda *s: (1 / (1 + np.exp(-f(*s)))).astype(np.float32)  # noqa
    lab = lambda n, c: r.randint(0, c, n).astype(np.int64)  # noqa: E731
    sign = lambda n: np.where(r.rand(n) < 0.5, -1.0, 1.0).astype(  # noqa
        np.float32)
    soft = np.abs(f(6, 5))
    soft = (soft / soft.sum(-1, keepdims=True)).astype(np.float32)
    ign = lab(6, 5)
    ign[[1, 4]] = -100
    w5 = np.abs(f(5)) + 0.1
    logp = np.log(prob(6, 5) / prob(6, 5).sum(-1, keepdims=True))
    return {
        "cross_entropy": ("cross_entropy", (f(6, 5), ign), {}),
        "cross_entropy_weight": ("cross_entropy", (f(6, 5), ign),
                                 dict(weight=w5)),
        "cross_entropy_soft": ("cross_entropy", (f(6, 5), soft),
                               dict(soft_label=True)),
        "cross_entropy_smooth": ("cross_entropy", (f(6, 5), lab(6, 5)),
                                 dict(label_smoothing=0.1)),
        "cross_entropy_axis1_none": ("cross_entropy", (f(3, 5, 4),
                                                       lab(12, 5).reshape(
                                                           3, 1, 4)),
                                     dict(axis=1, reduction="none")),
        "cross_entropy_probs": ("cross_entropy", (soft, lab(6, 5)),
                                dict(use_softmax=False, reduction="sum")),
        "softmax_with_cross_entropy": ("softmax_with_cross_entropy",
                                       (f(6, 5), lab(6, 5)[:, None]), {}),
        "binary_cross_entropy": ("binary_cross_entropy",
                                 (prob(6), prob(6)), {}),
        "binary_cross_entropy_with_logits": (
            "binary_cross_entropy_with_logits", (f(6, 3), prob(6, 3)),
            dict(pos_weight=np.abs(f(3)) + 0.5)),
        "mse_loss": ("mse_loss", (f(6, 3), f(6, 3)), {}),
        "l1_loss": ("l1_loss", (f(6, 3), f(6, 3)), dict(reduction="sum")),
        "smooth_l1_loss": ("smooth_l1_loss", (f(6, 3), f(6, 3)), {}),
        "nll_loss": ("nll_loss", (logp, ign), dict(weight=w5)),
        "kl_div": ("kl_div", (logp, soft), dict(reduction="batchmean")),
        "margin_ranking_loss": ("margin_ranking_loss",
                                (f(6), f(6), sign(6)), dict(margin=0.1)),
        "cosine_similarity": ("cosine_similarity", (f(4, 6), f(4, 6)), {}),
        "cosine_embedding_loss": ("cosine_embedding_loss",
                                  (f(4, 6), f(4, 6), sign(4)),
                                  dict(margin=0.2)),
        "label_smooth": ("label_smooth", (soft,), {}),
        "sigmoid_focal_loss": ("sigmoid_focal_loss", (f(6, 3), prob(6, 3)),
                               {}),
        "hinge_embedding_loss": ("hinge_embedding_loss", (f(6), sign(6)),
                                 {}),
        "triplet_margin_loss": ("triplet_margin_loss",
                                (f(4, 6), f(4, 6), f(4, 6)),
                                dict(swap=True)),
        "soft_margin_loss": ("soft_margin_loss", (f(6), sign(6)), {}),
        "square_error_cost": ("square_error_cost", (f(6), f(6)), {}),
        "log_loss": ("log_loss", (prob(6), prob(6)), {}),
        "poisson_nll_loss": ("poisson_nll_loss", (f(6), np.abs(f(6)) * 3),
                             dict(full=True)),
        "multi_label_soft_margin_loss": ("multi_label_soft_margin_loss",
                                         (f(6, 3), prob(6, 3).round()), {}),
        "dice_loss": ("dice_loss", (soft, lab(6, 5)[:, None]), {}),
        "triplet_margin_with_distance_loss": (
            "triplet_margin_with_distance_loss", (f(4, 6), f(4, 6),
                                                  f(4, 6)), {}),
        "gaussian_nll_loss": ("gaussian_nll_loss",
                              (f(6), f(6), np.abs(f(6)) + 0.1),
                              dict(full=True)),
    }


LOSSES = _loss_cases()


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_matches_reference(case):
    name, args, kw = LOSSES[case]
    kw_r = {k: _j(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    kw_p = {k: _t(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    xs = [_t(a).requires_grad_() if a.dtype == np.float32 and i == 0
          else _t(a) for i, a in enumerate(args)]
    got = getattr(F, name)(*xs, **kw_p)
    want = getattr(JF, name)(*[_j(a) for a in args], **kw_r)
    np.testing.assert_allclose(_np(got), _np(want), **EW)
    if xs[0].requires_grad:
        got.sum().backward()
        assert torch.isfinite(xs[0].grad).all()


LOSS_LAYERS = {
    "CrossEntropyLoss": ("cross_entropy", dict(ignore_index=-100)),
    "MSELoss": ("mse_loss", {}), "L1Loss": ("l1_loss", {}),
    "NLLLoss": ("nll_loss", {}), "BCELoss": ("binary_cross_entropy", {}),
    "BCEWithLogitsLoss": ("binary_cross_entropy_with_logits", {}),
    "KLDivLoss": ("kl_div", {}), "SmoothL1Loss": ("smooth_l1_loss", {}),
    "MarginRankingLoss": ("margin_ranking_loss", {}),
    "CosineEmbeddingLoss": ("cosine_embedding_loss", {}),
    "TripletMarginLoss": ("triplet_margin_loss", {}),
    "SoftMarginLoss": ("soft_margin_loss", {}),
    "MultiLabelSoftMarginLoss": ("multi_label_soft_margin_loss", {}),
    "HingeEmbeddingLoss": ("hinge_embedding_loss", {}),
    "PoissonNLLLoss": ("poisson_nll_loss", {}),
    "GaussianNLLLoss": ("gaussian_nll_loss", {}),
}


@pytest.mark.parametrize("layer", sorted(LOSS_LAYERS))
def test_loss_layer_matches_reference(layer):
    fn, kw = LOSS_LAYERS[layer]
    case = {"cross_entropy": "cross_entropy", "nll_loss": "nll_loss"}.get(
        fn, fn)
    _, args, _ = LOSSES[case]
    got = getattr(nn, layer)(**kw)(*[_t(a) for a in args])
    want = getattr(paddle.nn, layer)(**kw)(*[_j(a) for a in args])
    np.testing.assert_allclose(_np(got), _np(want), **EW)


# ----------------------------------------------------------- activations

ACTS = {
    "relu": {}, "relu6": {}, "gelu": {}, "gelu_tanh": dict(approximate=True),
    "sigmoid": {}, "silu": {}, "swish": {}, "softmax": dict(axis=0),
    "log_softmax": {}, "leaky_relu": dict(negative_slope=0.2), "elu": {},
    "selu": {}, "celu": dict(alpha=0.7), "hardtanh": {}, "hardsigmoid": {},
    "hardswish": {}, "hardshrink": {}, "softshrink": {}, "tanhshrink": {},
    "softplus": dict(beta=2.0), "softsign": {}, "mish": {}, "glu": dict(axis=1),
    "prelu": {}, "rrelu": {}, "tanh": {}, "maxout": dict(groups=2),
    "thresholded_relu": dict(threshold=0.3), "log_sigmoid": {},
}


@pytest.mark.parametrize("act", sorted(ACTS))
def test_activation_matches_reference(act):
    x = np.random.RandomState(13).randn(4, 6, 3).astype(np.float32) * 3
    kw = dict(ACTS[act])
    name = "gelu" if act == "gelu_tanh" else act
    extra_r, extra_p = (), ()
    if act == "prelu":
        w = np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6], np.float32)
        extra_r, extra_p = (_j(w),), (_t(w),)
    xp = _t(x).requires_grad_()
    got = getattr(F, name)(xp, *extra_p, **kw)
    want = getattr(JF, name)(_j(x), *extra_r, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **EW)
    got.sum().backward()
    assert torch.isfinite(xp.grad).all()


def test_activation_layers_and_random_activations():
    x = np.random.RandomState(14).randn(4, 6).astype(np.float32)
    for cls, kw in (("ReLU", {}), ("GELU", {}), ("LeakyReLU", dict(
            negative_slope=0.3)), ("Softmax", dict(axis=0)), ("Hardtanh", (
            dict(min=-0.5, max=0.5))), ("SELU", {}), ("Softmax2D", {}),
            ("PReLU", dict(num_parameters=1, init=0.2)), ("GLU", {})):
        want = getattr(paddle.nn, cls)(**kw)(_j(x.reshape(2, 2, 3, 2)))
        extra = dict(device="cpu") if cls == "PReLU" else {}
        got = getattr(nn, cls)(**kw, **extra)(_t(x.reshape(2, 2, 3, 2)))
        np.testing.assert_allclose(_np(got), _np(want), **EW)
    # rrelu in training: slopes in [lower, upper), seeded; gumbel: a
    # distribution over the axis, hard = one-hot
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    neg = -torch.rand(1000) - 0.1
    a = F.rrelu(neg, 0.1, 0.3, training=True, generator=g1)
    assert torch.equal(a, F.rrelu(neg, 0.1, 0.3, training=True,
                                  generator=g2))
    slope = a / neg
    assert float(slope.min()) >= 0.1 and float(slope.max()) < 0.3
    y = F.gumbel_softmax(_t(x), hard=True,
                         generator=torch.Generator().manual_seed(1))
    assert torch.equal(y.sum(-1), torch.ones(4)) and set(
        y.unique().tolist()) <= {0.0, 1.0}


# ----------------------------------------------------- common functionals

def test_common_functionals_match_reference():
    rng = np.random.RandomState(15)
    x = rng.randn(3, 4).astype(np.float32)
    w = rng.randn(4, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    np.testing.assert_allclose(_np(F.linear(_t(x), _t(w), _t(b))),
                               _np(JF.linear(_j(x), _j(w), _j(b))), **EW)
    ids = np.array([[0, 2, 4], [4, 1, 0]], np.int64)
    table = rng.randn(6, 3).astype(np.float32)
    np.testing.assert_allclose(
        _np(F.embedding(_t(ids), _t(table), padding_idx=4)),
        _np(JF.embedding(_j(ids), _j(table), padding_idx=4)), **EW)
    lab = np.array([0, 3, 7, -1], np.int64)
    np.testing.assert_array_equal(_np(F.one_hot(_t(lab), 5)),
                                  _np(JF.one_hot(_j(lab), 5)))
    lens = np.array([1, 4, 2], np.int64)
    np.testing.assert_array_equal(_np(F.sequence_mask(_t(lens))),
                                  _np(JF.sequence_mask(_j(lens))))
    np.testing.assert_array_equal(
        _np(F.sequence_mask(_t(lens), 6, dtype="float32")),
        _np(JF.sequence_mask(_j(lens), 6, dtype="float32")))
    y = rng.randn(3, 4).astype(np.float32)
    for p in (1.0, 2.0, float("inf")):
        np.testing.assert_allclose(
            _np(F.pairwise_distance(_t(x), _t(y), p)),
            _np(JF.pairwise_distance(_j(x), _j(y), p)), **EW)
    np.testing.assert_allclose(_np(F.normalize(_t(x))),
                               _np(JF.normalize(_j(x))), **EW)
    # the layers over them
    for cls, args, ins in (("CosineSimilarity", (), (x, y)),
                           ("PairwiseDistance", (), (x, y)),
                           ("Flatten", (), (rng.randn(2, 3, 4).astype(
                               np.float32),)), ("Identity", (), (x,))):
        np.testing.assert_allclose(
            _np(getattr(nn, cls)(*args)(*[_t(a) for a in ins])),
            _np(getattr(paddle.nn, cls)(*args)(*[_j(a) for a in ins])),
            **EW)


def test_dropouts_are_seeded_and_keep_their_shapes():
    x = torch.ones(8, 16, 4, 4)
    g = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    a = F.dropout2d(x, 0.5, generator=g())
    assert torch.equal(a, F.dropout2d(x, 0.5, generator=g()))
    per_channel = a.reshape(8, 16, -1)
    assert bool((per_channel.amin(-1) == per_channel.amax(-1)).all())
    assert set(a.unique().tolist()) <= {0.0, 2.0}
    v = F.dropout3d(torch.ones(2, 6, 2, 2, 2), 0.5, generator=g())
    assert bool((v.reshape(2, 6, -1).std(-1) == 0).all())
    z = torch.randn(20000, generator=torch.Generator().manual_seed(99))
    ad = F.alpha_dropout(z, 0.2, generator=g())
    assert abs(float(ad.mean())) < 0.05 and abs(float(ad.std()) - 1) < 0.05
    assert torch.equal(F.alpha_dropout(z, 0.2, training=False), z)
    layer = nn.Dropout2D(0.5, generator=g())
    layer.eval()
    assert torch.equal(layer(x), x)


# ------------------------------------------------------------ containers

def _linears(ref_cls, n=3):
    paddle.seed(21)
    return [ref_cls(4, 4) for _ in range(n)]


@pytest.mark.parametrize("kind", ["Sequential", "Sequential_named",
                                  "LayerList", "LayerDict",
                                  "ParameterList"])
def test_container_matches_reference(kind):
    x = np.random.RandomState(22).randn(2, 4).astype(np.float32)
    refs = _linears(paddle.nn.Linear)
    ports = [nn.Linear(4, 4, device="cpu") for _ in refs]
    if kind == "Sequential":
        ref, port = paddle.nn.Sequential(*refs), nn.Sequential(*ports)
    elif kind == "Sequential_named":
        names = ["a", "b", "c"]
        ref = paddle.nn.Sequential(*zip(names, refs))
        port = nn.Sequential(collections.OrderedDict(zip(names, ports)))
    elif kind == "LayerList":
        ref, port = paddle.nn.LayerList(refs[:2]), nn.LayerList(ports[:2])
        ref.append(refs[2])
        port.append(ports[2])
    elif kind == "LayerDict":
        ref = paddle.nn.LayerDict({"x": refs[0], "y": refs[1]})
        port = nn.LayerDict({"x": ports[0], "y": ports[1]})
        ref["z"], port["z"] = refs[2], ports[2]
    else:
        ref = paddle.nn.ParameterList([r.weight for r in refs])
        port = nn.ParameterList([p.weight for p in ports])
    assert list(port.state_dict()) == sorted(ref.state_dict(), key=list(
        port.state_dict()).index)
    assert set(port.state_dict()) == set(ref.state_dict())
    _load(port, ref)
    if kind == "ParameterList":
        assert len(port) == 3 and torch.equal(port[1], ports[1].weight)
        np.testing.assert_array_equal(_np(port[2]), _np(ref[2]))
        return
    if kind.startswith("Sequential"):
        np.testing.assert_allclose(_np(port(_t(x))), _np(ref(_t(x))), **EW)
        assert isinstance(port[1:], nn.Sequential) and len(port[1:]) == 2
        return
    members = list(port.values()) if kind == "LayerDict" else list(port)
    ref_members = list(ref.values()) if kind == "LayerDict" else list(ref)
    for m_p, m_r in zip(members, ref_members):
        np.testing.assert_allclose(_np(m_p(_t(x))), _np(m_r(_j(x))), **EW)
    if kind == "LayerList":
        assert port[-1] is ports[2] and len(port[:2]) == 2
        port.insert(0, ports[2])
        assert list(port.state_dict())[:2] == ["0.weight", "0.bias"]


# ----------------------------------------------------------------- clips

@pytest.mark.parametrize("clip", ["ByValue", "ByNorm", "ByGlobalNorm",
                                  "clip_grad_norm_", "clip_grad_norm_inf",
                                  "clip_grad_value_"])
def test_clip_matches_reference(clip):
    rng = np.random.RandomState(23)
    grads = [rng.randn(4, 3).astype(np.float32) * 3,
             rng.randn(5).astype(np.float32)]
    if clip.startswith("By"):
        args = dict(ByValue=(0.5, -0.2), ByNorm=(1.0,),
                    ByGlobalNorm=(2.0,))[clip]
        ref = getattr(paddle.nn, "ClipGrad" + clip)(*args)
        port = getattr(nn, "ClipGrad" + clip)(*args)
        want = ref([(None, _j(g)) for g in grads])
        got = port([(None, _t(g)) for g in grads])
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), **EW)
        return
    ps_r = [paddle.create_parameter(list(g.shape), "float32")
            for g in grads]
    ps_p = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for pr, pp, g in zip(ps_r, ps_p, grads):
        pr._grad = _j(g)
        pp.grad = _t(g)
    if clip == "clip_grad_value_":
        nn.clip_grad_value_(ps_p, 0.7)
        paddle.nn.clip_grad_value_(ps_r, 0.7)
    else:
        p = float("inf") if clip.endswith("inf") else 2.0
        tot_p = nn.clip_grad_norm_(ps_p, 1.5, p)
        tot_r = paddle.nn.clip_grad_norm_(ps_r, 1.5, p)
        np.testing.assert_allclose(_np(tot_p), _np(tot_r), **EW)
    for pr, pp in zip(ps_r, ps_p):
        np.testing.assert_allclose(_np(pp.grad), _np(pr.grad), **EW)


# ---------------------------------------------------------- initializers

DETERMINISTIC = {
    "Constant": (lambda m: m.Constant(0.3), (3, 4)),
    "Assign": (lambda m: m.Assign(np.arange(12.0).reshape(3, 4)), (3, 4)),
    "Dirac": (lambda m: m.Dirac(), (4, 2, 3, 3)),
    "Dirac_groups": (lambda m: m.Dirac(groups=2), (4, 2, 3)),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_initializer_matches_reference(name):
    make, shape = DETERMINISTIC[name]
    want = np.asarray(make(jinit)(shape, "float32"))
    got = make(pinit)(torch.empty(shape))
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("nonlinearity", ["sigmoid", "linear", "conv2d",
                                          "tanh", "relu", "leaky_relu",
                                          "selu"])
def test_calculate_gain_matches_reference(nonlinearity):
    assert pinit.calculate_gain(nonlinearity, 0.2) == \
        jinit.calculate_gain(nonlinearity, 0.2)


RANDOM = {   # initializer, shape, (mean, std) of the draw, bounds
    "Normal": (lambda: pinit.Normal(0.5, 2.0), (200, 200), (0.5, 2.0),
               None),
    "TruncatedNormal": (lambda: pinit.TruncatedNormal(0.0, 1.0, -1.5, 1.5),
                        (200, 200), (0.0, 0.7379), (-1.5, 1.5)),
    "Uniform": (lambda: pinit.Uniform(-0.5, 1.5), (200, 200),
                (0.5, 2 / math.sqrt(12)), (-0.5, 1.5)),
    "XavierNormal": (lambda: pinit.XavierNormal(), (100, 400),
                     (0.0, math.sqrt(2 / 500)), None),
    "XavierUniform": (lambda: pinit.XavierUniform(), (100, 400),
                      (0.0, math.sqrt(2 / 500)), (-math.sqrt(6 / 500),
                                                  math.sqrt(6 / 500))),
    "KaimingNormal": (lambda: pinit.KaimingNormal(), (100, 400),
                      (0.0, math.sqrt(2 / 100)), None),
    "KaimingUniform": (lambda: pinit.KaimingUniform(), (16, 8, 5, 5),
                       (0.0, math.sqrt(2 / 200)), (-math.sqrt(6 / 200),
                                                   math.sqrt(6 / 200))),
    "Orthogonal": (lambda: pinit.Orthogonal(gain=2.0), (60, 90), None,
                   None),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_initializer_shape_bounds_moments_and_seed(name):
    make, shape, moments, bounds = RANDOM[name]
    draws = []
    for _ in range(2):
        with pinit.use_generator(torch.Generator().manual_seed(31)):
            draws.append(make()(torch.empty(shape)))
    a = draws[0]
    assert tuple(a.shape) == shape and torch.equal(a, draws[1])
    if bounds is not None:
        assert float(a.min()) >= bounds[0] and float(a.max()) <= bounds[1]
    if moments is not None:
        mean, std = moments
        assert abs(float(a.mean()) - mean) < 0.02 * max(std, 1.0)
        assert abs(float(a.std()) - std) < 0.03 * std
    else:   # orthonormal rows, scaled by the gain
        gram = a @ a.t()
        assert torch.allclose(gram, 4.0 * torch.eye(60), atol=1e-4)
    # outside any scope: the device's default stream, never the global one
    before = torch.random.get_rng_state()
    make()(torch.empty(shape))
    assert torch.equal(before, torch.random.get_rng_state())
    with pinit.owner_initializes():
        empty = torch.full(shape, 7.0)
        assert torch.equal(make()(empty), torch.full(shape, 7.0))


# ----------------------------------------------------------------- Layer

class _Net(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(3, 2, device="cpu")
        self.norm = nn.LayerNorm(2, device="cpu")
        self.register_buffer("steps", torch.zeros(()), persistable=True)

    def forward(self, x):
        return self.norm(self.fc(x))


def test_layer_hooks_fire_in_paddle_order():
    net, calls = _Net(), []
    h1 = net.register_forward_pre_hook(
        lambda layer, inputs: calls.append("pre1"))
    net.register_forward_pre_hook(
        lambda layer, inputs: (calls.append("pre2"), (inputs[0] * 0,))[1])
    net.register_forward_post_hook(
        lambda layer, inputs, out: calls.append("post1"))
    h4 = net.register_forward_post_hook(
        lambda layer, inputs, out: (calls.append("post2"), out + 1)[1])
    out = net(torch.ones(2, 3))
    assert calls == ["pre1", "pre2", "post1", "post2"]
    assert torch.allclose(out, net.norm(net.fc(torch.zeros(2, 3))) + 1)
    assert isinstance(h1, nn.HookRemoveHelper)
    h1.remove()
    h4.remove()
    calls.clear()
    net(torch.ones(2, 3))
    assert calls == ["pre2", "post1"]


def test_create_parameter_honours_param_attr():
    layer = nn.Layer()
    w = layer.create_parameter(
        [4, 5], attr=nn.ParamAttr(name="w0", initializer=pinit.Constant(
            0.5), learning_rate=0.1, trainable=False), device="cpu")
    assert w.param_name == "w0" and not w.requires_grad
    assert w.optimize_attr == {"learning_rate": 0.1}
    assert torch.equal(w, torch.full((4, 5), 0.5))
    b = layer.create_parameter([5], is_bias=True, device="cpu")
    assert torch.equal(b, torch.zeros(5)) and b.param_name is None
    named = layer.create_parameter([2], attr="bias_x", device="cpu",
                                   default_initializer=pinit.Constant(2.0))
    assert named.param_name == "bias_x" and float(named.sum()) == 4.0
    lin = nn.Linear(3, 3, weight_attr=nn.ParamAttr(
        initializer=pinit.Constant(1.0)), bias_attr=False, device="cpu")
    assert lin.bias is None and torch.equal(lin.weight, torch.ones(3, 3))
    ln = nn.LayerNorm(3, weight_attr=False, bias_attr=False, device="cpu")
    assert ln.weight is None and ln.bias is None
    emb = nn.Embedding(5, 2, padding_idx=-1, device="cpu")
    assert torch.equal(emb.weight[4], torch.zeros(2))


def test_layer_state_dict_round_trip_and_paddle_names():
    a, b = _Net(), _Net()
    with torch.no_grad():
        a.fc.weight.add_(1.0)
        a.steps.fill_(3.0)
    state = {k: v.numpy() for k, v in a.state_dict().items()}
    assert list(state) == ["steps", "fc.weight", "fc.bias", "norm.weight",
                           "norm.bias"]
    missing, unexpected = b.set_state_dict(dict(state, extra=np.ones(1)))
    assert missing == [] and unexpected == ["extra"]
    for k, v in b.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k])
    with pytest.raises(ValueError, match="shape mismatch"):
        b.set_state_dict({"fc.weight": np.ones((2, 2))})
    assert list(a.state_dict(include_sublayers=False)) == ["steps"]
    assert list(a.state_dict(structured_name_prefix="m."))[0] == "m.steps"
    assert len(list(a.parameters(include_sublayers=False))) == 0
    assert [n for n, _ in a.named_sublayers()] == ["fc", "norm"]
    assert a.sublayers(include_self=True)[0] is a
    a.astype("bfloat16")
    assert a.fc.weight.dtype == torch.bfloat16
    a.to(dtype="float32", blocking=True)
    assert a.norm.weight.dtype == torch.float32
    (a(torch.ones(1, 3)).sum()).backward()
    a.clear_gradients()
    assert all(p.grad is None for p in a.parameters())
    assert a.full_name().startswith("_net_")


@pytest.mark.parametrize("family", ["llama", "qwen2", "qwen2_moe",
                                    "deepseek_moe", "gpt"])
def test_port_models_keep_reference_state_dict_keys(family):
    """Every model built on the ``nn`` layers keeps its parameter names
    and shapes, the reference's."""
    import importlib
    names = {"llama": ("LlamaConfig", "LlamaForCausalLM"),
             "qwen2": ("Qwen2Config", "Qwen2ForCausalLM"),
             "qwen2_moe": ("Qwen2MoeConfig", "Qwen2MoeForCausalLM"),
             "deepseek_moe": ("DeepseekMoeConfig", "DeepseekMoeForCausalLM"),
             "gpt": ("GPTConfig", "GPTForCausalLM")}[family]
    ref_mod = importlib.import_module(f"paddle_tpu.models.{family}")
    port_mod = importlib.import_module(f"paddle_tpu_torch.models.{family}")
    ref = getattr(ref_mod, names[1])(getattr(ref_mod, names[0]).tiny())
    port = getattr(port_mod, names[1])(getattr(port_mod, names[0]).tiny(),
                                       device="cpu")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in ref.state_dict().items()}
