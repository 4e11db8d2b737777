"""The port's vision path against the JAX package on the CPU: every
convolution and pooling functional (strides, dilations, groups, every
padding form, channels-last, ``ceil_mode``, ``exclusive``,
``return_mask`` and unpooling, ``unfold`` / ``fold``), the batch,
instance, group and local-response norms (the running statistics after
three updates), the conv and norm layers, and LeNet, ResNet-18 and a
ResNet-50 bottleneck block (outputs, every gradient, the batch-norm
statistics), with ResNet-50's parameter and buffer names and shapes.

Inputs are seeded with numpy; weights (and batch-norm statistics) move
across with ``load_jax_params``. Float32 tolerances: a functional rtol
1e-5, atol 1e-5 (one op in another library, sums in another order);
pooling masks and unpooled tensors exactly; a model's output rtol 1e-5,
atol 1e-5 and every gradient rtol 1e-4, atol 1e-4 (the sums of a
backward in another order); running statistics rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import nn
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.vision import models

FN = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
STATS = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return paddle.to_tensor(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x.numpy())


def _rand(rng, shape):
    return rng.randn(*shape).astype(np.float32)


def _carry(port, ref):
    load_jax_params(port, {k: np.asarray(v.numpy())
                           for k, v in ref.state_dict().items()})


def _perturb(ref, seed):
    """Batch-norm weights near 1, biases near 0, running statistics
    away from their start, other weights as drawn."""
    rng = np.random.RandomState(seed)
    for name, t in list(ref.named_parameters()) + list(ref.named_buffers()):
        a = np.asarray(t.numpy())
        if name.endswith("_variance"):
            a = 0.5 + rng.rand(*a.shape)
        elif name.endswith("_mean") or name.endswith("bias"):
            a = 0.1 * rng.randn(*a.shape)
        elif a.ndim == 1:
            a = 1.0 + 0.1 * rng.randn(*a.shape)
        t.set_value(a.astype(np.float32))


# --------------------------------------------------------------- convs

CONV = {   # name: (function, x shape, weight shape, bias, kwargs)
    "conv2d_s2_p1": ("conv2d", (2, 4, 9, 9), (6, 4, 3, 3), True,
                     dict(stride=2, padding=1)),
    "conv2d_dilation_per_dim": ("conv2d", (2, 4, 9, 9), (6, 4, 3, 3), False,
                                dict(dilation=2, padding=[1, 2])),
    "conv2d_groups": ("conv2d", (2, 4, 9, 9), (6, 2, 3, 3), True,
                      dict(groups=2, padding=1)),
    "conv2d_same_s2": ("conv2d", (2, 4, 9, 9), (6, 4, 3, 3), True,
                       dict(stride=2, padding="SAME")),
    "conv2d_same_dilated": ("conv2d", (2, 4, 9, 9), (6, 4, 3, 3), True,
                            dict(dilation=2, padding="same")),
    "conv2d_valid": ("conv2d", (2, 4, 9, 9), (6, 4, 3, 3), True,
                     dict(stride=2, padding="VALID")),
    "conv2d_pairs": ("conv2d", (2, 4, 9, 9), (6, 4, 3, 3), True,
                     dict(padding=[1, 0, 2, 1])),
    "conv1d_full_rank": ("conv1d", (2, 4, 11), (6, 4, 3), False,
                         dict(padding=[[0, 0], [0, 0], [1, 2]])),
    "conv2d_nhwc": ("conv2d", (2, 9, 9, 4), (6, 4, 3, 3), True,
                    dict(stride=2, padding=1, data_format="NHWC")),
    "conv1d": ("conv1d", (2, 4, 11), (6, 4, 3), True,
               dict(stride=2, padding=1)),
    "conv1d_nlc_same": ("conv1d", (2, 11, 4), (6, 4, 3), True,
                        dict(padding="SAME", data_format="NLC")),
    "conv3d": ("conv3d", (1, 2, 5, 6, 5), (3, 2, 3, 3, 3), True,
               dict(stride=(1, 2, 1), padding=1)),
    "conv3d_ndhwc": ("conv3d", (1, 5, 6, 5, 2), (3, 2, 3, 3, 3), False,
                     dict(padding=1, data_format="NDHWC")),
    "conv2d_transpose_s2_op1": ("conv2d_transpose", (2, 4, 5, 5),
                                (4, 3, 3, 3), True,
                                dict(stride=2, padding=1, output_padding=1)),
    "conv2d_transpose_groups": ("conv2d_transpose", (2, 4, 5, 5),
                                (4, 2, 3, 3), True,
                                dict(stride=2, groups=2)),
    "conv2d_transpose_pairs": ("conv2d_transpose", (2, 4, 5, 5),
                               (4, 3, 3, 3), True,
                               dict(stride=2, padding=[1, 0, 0, 2])),
    "conv2d_transpose_dilated": ("conv2d_transpose", (2, 4, 5, 5),
                                 (4, 3, 3, 3), False,
                                 dict(dilation=2, padding=1)),
    "conv2d_transpose_crop": ("conv2d_transpose", (2, 4, 5, 5),
                              (4, 3, 3, 3), True, dict(padding=3)),
    "conv2d_transpose_op_past_stride": ("conv2d_transpose", (2, 4, 5, 5),
                                        (4, 3, 3, 3), True,
                                        dict(padding=1, output_padding=2)),
    "conv2d_transpose_nhwc": ("conv2d_transpose", (2, 5, 5, 4),
                              (4, 3, 3, 3), True,
                              dict(stride=2, padding=1,
                                   data_format="NHWC")),
    "conv1d_transpose": ("conv1d_transpose", (2, 4, 7), (4, 3, 3), True,
                         dict(stride=2, padding=1, output_padding=1)),
    "conv3d_transpose": ("conv3d_transpose", (1, 2, 3, 4, 3),
                         (2, 3, 3, 3, 3), True, dict(stride=2, padding=1)),
}


@pytest.mark.parametrize("case", sorted(CONV))
def test_conv_matches_reference(case):
    fn, xs, ws, has_bias, kw = CONV[case]
    rng = np.random.RandomState(len(case))
    x, w = _rand(rng, xs), _rand(rng, ws)
    n_out = ws[0] if "transpose" not in fn else \
        ws[1] * kw.get("groups", 1)
    b = _rand(rng, (n_out,)) if has_bias else None
    ref = getattr(JF, fn)(_j(x), _j(w), None if b is None else _j(b), **kw)
    got = getattr(F, fn)(_t(x), _t(w), None if b is None else _t(b), **kw)
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(_np(got), _np(ref), **FN)


def test_transposed_conv_refuses_a_padding_string_as_reference():
    rng = np.random.RandomState(1)
    x, w = _rand(rng, (2, 4, 5, 5)), _rand(rng, (4, 3, 3, 3))
    for mod, wrap in ((JF, _j), (F, _t)):
        with pytest.raises(ValueError):
            mod.conv2d_transpose(wrap(x), wrap(w), stride=2, padding="SAME")


def test_channels_last_conv_reads_and_writes_without_copies():
    """An NHWC conv2d runs on the NCHW view of its input's memory and
    returns an NHWC tensor over a channels-last result."""
    rng = np.random.RandomState(0)
    x = _t(_rand(rng, (2, 9, 9, 4)))
    w = _t(_rand(rng, (6, 4, 3, 3)))
    y = F.conv2d(x, w, padding=1, data_format="NHWC")
    assert tuple(y.shape) == (2, 9, 9, 6) and y.is_contiguous()
    ref = F.conv2d(x.permute(0, 3, 1, 2).contiguous(), w, padding=1)
    np.testing.assert_allclose(_np(y), _np(ref.permute(0, 2, 3, 1)), **FN)


# --------------------------------------------------------------- pools

POOL = {   # name: (function, x shape, args, kwargs)
    "max2d_k3_s2_p1": ("max_pool2d", (2, 3, 9, 9), (3,),
                       dict(stride=2, padding=1)),
    "max2d_k2": ("max_pool2d", (2, 3, 8, 8), (2,), {}),
    "max2d_same": ("max_pool2d", (2, 3, 9, 9), (3,),
                   dict(stride=2, padding="SAME")),
    "max2d_pairs": ("max_pool2d", (2, 3, 8, 8), (2,),
                    dict(stride=2, padding=[0, 1, 1, 0])),
    "max2d_wide_pad": ("max_pool2d", (2, 3, 8, 8), (3,),
                       dict(stride=1, padding=2)),
    "max2d_nhwc": ("max_pool2d", (2, 9, 9, 3), (3,),
                   dict(stride=2, padding=1, data_format="NHWC")),
    "max2d_ceil_mode": ("max_pool2d", (2, 3, 8, 8), (3,),
                        dict(stride=2, ceil_mode=True)),
    "avg2d_exclusive": ("avg_pool2d", (2, 3, 9, 9), (3,),
                        dict(stride=2, padding=1)),
    "avg2d_inclusive": ("avg_pool2d", (2, 3, 9, 9), (3,),
                        dict(stride=2, padding=1, exclusive=False)),
    "avg2d_same": ("avg_pool2d", (2, 3, 9, 9), (3,),
                   dict(stride=2, padding="SAME")),
    "avg2d_pairs": ("avg_pool2d", (2, 3, 8, 8), (2,),
                    dict(stride=1, padding=[0, 1, 1, 0])),
    "avg2d_divisor_override": ("avg_pool2d", (2, 3, 9, 9), (3,),
                               dict(stride=2, padding=1,
                                    divisor_override=3)),
    "avg2d_nhwc": ("avg_pool2d", (2, 9, 9, 3), (3,),
                   dict(stride=2, padding=1, data_format="NHWC")),
    "avg1d_inclusive": ("avg_pool1d", (2, 3, 11), (3,),
                        dict(stride=2, padding=1, exclusive=False)),
    "max1d": ("max_pool1d", (2, 3, 11), (3,), dict(stride=2, padding=1)),
    "avg3d": ("avg_pool3d", (1, 2, 5, 6, 5), (2,),
              dict(stride=2, padding=1)),
    "max3d": ("max_pool3d", (1, 2, 5, 6, 5), (3,),
              dict(stride=2, padding=1)),
    "adaptive_avg2d_1x1": ("adaptive_avg_pool2d", (2, 3, 7, 9), ((1, 1),),
                           {}),
    "adaptive_avg2d_uneven": ("adaptive_avg_pool2d", (2, 3, 7, 9), ((3, 4),),
                              {}),
    "adaptive_avg2d_none": ("adaptive_avg_pool2d", (2, 3, 7, 9),
                            ([None, 2],), {}),
    "adaptive_max2d_uneven": ("adaptive_max_pool2d", (2, 3, 7, 9), ((3, 4),),
                              {}),
    "adaptive_avg1d": ("adaptive_avg_pool1d", (2, 3, 10), (3,), {}),
    "adaptive_max1d": ("adaptive_max_pool1d", (2, 3, 10), (4,), {}),
    "adaptive_avg3d": ("adaptive_avg_pool3d", (1, 2, 5, 6, 5), ((2, 3, 2),),
                       {}),
    "adaptive_max3d": ("adaptive_max_pool3d", (1, 2, 4, 6, 4), (2,), {}),
}


@pytest.mark.parametrize("case", sorted(POOL))
def test_pool_matches_reference(case):
    fn, xs, args, kw = POOL[case]
    x = _rand(np.random.RandomState(len(case)), xs)
    ref = getattr(JF, fn)(_j(x), *args, **kw)
    got = getattr(F, fn)(_t(x), *args, **kw)
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(_np(got), _np(ref), **FN)


MASK = {   # name: (pool, unpool, x shape, kernel, kwargs, unpool kwargs)
    "max2d_k2": ("max_pool2d", "max_unpool2d", (2, 3, 8, 8), 2,
                 dict(stride=2), {}),
    "max2d_k3_p1": ("max_pool2d", "max_unpool2d", (2, 3, 9, 9), 3,
                    dict(stride=2, padding=1), dict(output_size=(9, 9))),
    "max1d": ("max_pool1d", "max_unpool1d", (2, 3, 10), 2, dict(stride=2),
              {}),
    "max3d": ("max_pool3d", "max_unpool3d", (1, 2, 4, 6, 4), 2,
              dict(stride=2), {}),
}


@pytest.mark.parametrize("case", sorted(MASK))
def test_return_mask_and_unpool_match_reference(case):
    pool, unpool, xs, k, kw, ukw = MASK[case]
    x = _rand(np.random.RandomState(len(case)), xs)
    rv, rm = getattr(JF, pool)(_j(x), k, return_mask=True, **kw)
    gv, gm = getattr(F, pool)(_t(x), k, return_mask=True, **kw)
    np.testing.assert_array_equal(_np(gv), _np(rv))
    assert gm.dtype == torch.int32
    np.testing.assert_array_equal(_np(gm), _np(rm))
    ukw = dict(ukw, stride=kw.get("stride"), padding=kw.get("padding", 0))
    ru = getattr(JF, unpool)(rv, rm, k, **ukw)
    gu = getattr(F, unpool)(gv, gm, k, **ukw)
    np.testing.assert_array_equal(_np(gu), _np(ru))


def test_adaptive_max_mask_and_mask_refusals_match_reference():
    x = _rand(np.random.RandomState(3), (2, 3, 8, 8))
    rv, rm = JF.adaptive_max_pool2d(_j(x), 4, return_mask=True)
    gv, gm = F.adaptive_max_pool2d(_t(x), 4, return_mask=True)
    np.testing.assert_array_equal(_np(gv), _np(rv))
    np.testing.assert_array_equal(_np(gm), _np(rm))
    for mod, arg in ((JF, _j(x)), (F, _t(x))):
        with pytest.raises(NotImplementedError):
            mod.max_pool2d(arg, 3, 2, return_mask=True, ceil_mode=True)
        with pytest.raises(NotImplementedError):
            mod.adaptive_max_pool2d(arg, 3, return_mask=True)


@pytest.mark.parametrize("kw", [
    dict(kernel_sizes=3, strides=1, paddings=1),
    dict(kernel_sizes=2, strides=2, dilations=2, paddings=[1, 0, 0, 1]),
    dict(kernel_sizes=[2, 3], strides=[1, 2], paddings=0),
], ids=["k3_p1", "k2_s2_d2_pairs", "k2x3_s1x2"])
def test_unfold_and_fold_match_reference(kw):
    x = _rand(np.random.RandomState(5), (2, 3, 6, 7))
    ref = JF.unfold(_j(x), **kw)
    got = F.unfold(_t(x), **kw)
    np.testing.assert_allclose(_np(got), _np(ref), **FN)
    if "dilations" in kw:
        return
    fkw = dict(kernel_sizes=kw["kernel_sizes"], strides=kw["strides"],
               paddings=kw["paddings"])
    np.testing.assert_allclose(_np(F.fold(got, (6, 7), **fkw)),
                               _np(JF.fold(ref, (6, 7), **fkw)), **FN)


# --------------------------------------------------------------- norms

@pytest.mark.parametrize("layout", ["nchw", "nhwc", "nc", "no_weight"])
def test_batch_norm_training_statistics_match_reference(layout):
    """Three training calls: each output, then the running statistics
    (Paddle's momentum 0.9, biased variance); then eval and
    ``use_global_stats`` read them."""
    rng = np.random.RandomState(7)
    shape = {"nchw": (4, 3, 5, 6), "nhwc": (4, 5, 6, 3), "nc": (16, 3),
             "no_weight": (4, 3, 5, 6)}[layout]
    fmt = "NHWC" if layout == "nhwc" else "NCHW"
    w = None if layout == "no_weight" else 1 + 0.1 * _rand(rng, (3,))
    b = 0.1 * _rand(rng, (3,))
    rm_r, rv_r = _j(np.zeros(3, np.float32)), _j(np.ones(3, np.float32))
    rm_p, rv_p = torch.zeros(3), torch.ones(3)
    for i in range(3):
        x = 2.0 + 3.0 * _rand(rng, shape)
        ref = JF.batch_norm(_j(x), rm_r, rv_r, None if w is None else _j(w),
                            _j(b), training=True, data_format=fmt)
        got = F.batch_norm(_t(x), rm_p, rv_p, None if w is None else _t(w),
                           _t(b), training=True, data_format=fmt)
        np.testing.assert_allclose(_np(got), _np(ref), **FN)
    np.testing.assert_allclose(_np(rm_p), _np(rm_r), **STATS)
    np.testing.assert_allclose(_np(rv_p), _np(rv_r), **STATS)
    for kw in (dict(training=False), dict(training=True,
                                          use_global_stats=True)):
        ref = JF.batch_norm(_j(x), rm_r, rv_r, None if w is None else _j(w),
                            _j(b), data_format=fmt, **kw)
        got = F.batch_norm(_t(x), rm_p, rv_p, None if w is None else _t(w),
                           _t(b), data_format=fmt, **kw)
        np.testing.assert_allclose(_np(got), _np(ref), **FN)


@pytest.mark.parametrize("case", ["instance", "group", "lrn5", "lrn4"])
def test_other_norms_match_reference(case):
    rng = np.random.RandomState(11)
    if case == "instance":
        x, w, b = _rand(rng, (2, 3, 5, 6)), _rand(rng, (3,)), _rand(rng, (3,))
        ref = JF.instance_norm(_j(x), weight=_j(w), bias=_j(b))
        got = F.instance_norm(_t(x), weight=_t(w), bias=_t(b))
    elif case == "group":
        x, w, b = _rand(rng, (2, 6, 4, 5)), _rand(rng, (6,)), _rand(rng, (6,))
        ref = JF.group_norm(_j(x), 3, weight=_j(w), bias=_j(b))
        got = F.group_norm(_t(x), 3, weight=_t(w), bias=_t(b))
    else:
        x = _rand(rng, (2, 7, 4, 5))
        size = int(case[3:])
        ref = JF.local_response_norm(_j(x), size, alpha=0.1)
        got = F.local_response_norm(_t(x), size, alpha=0.1)
    np.testing.assert_allclose(_np(got), _np(ref), **FN)


def test_batchnorm_train_and_eval():
    """The reference's ``test_nn.py`` case on the port's layer."""
    bn = nn.BatchNorm2D(3, device="cpu")
    x = _t((np.random.RandomState(0).rand(4, 3, 5, 5) * 4 + 2)
           .astype(np.float32))
    bn.train()
    y = _np(bn(x))
    np.testing.assert_allclose(y.mean(axis=(0, 2, 3)), 0, atol=1e-4)
    np.testing.assert_allclose(y.std(axis=(0, 2, 3)), 1, atol=1e-2)
    assert not np.allclose(_np(bn._mean), 0)
    assert [n for n, _ in bn.named_buffers()] == ["_mean", "_variance"]
    bn.eval()
    mean = _np(bn._mean).copy()
    assert tuple(bn(x).shape) == (4, 3, 5, 5)
    np.testing.assert_array_equal(_np(bn._mean), mean)


def test_norm_layers_match_reference():
    rng = np.random.RandomState(13)
    x = _rand(rng, (2, 6, 5, 4))
    pairs = [(paddle.nn.InstanceNorm2D(6), nn.InstanceNorm2D(6,
                                                             device="cpu")),
             (paddle.nn.GroupNorm(2, 6), nn.GroupNorm(2, 6, device="cpu")),
             (paddle.nn.LocalResponseNorm(3), nn.LocalResponseNorm(3)),
             (paddle.nn.SyncBatchNorm(6), nn.SyncBatchNorm(6, device="cpu"))]
    for ref, port in pairs:
        _perturb(ref, 1)
        _carry(port, ref)
        np.testing.assert_allclose(_np(port(_t(x))), _np(ref(_j(x))), **FN)
    seq = paddle.nn.Sequential(paddle.nn.Conv2D(6, 6, 1),
                               paddle.nn.BatchNorm2D(6))
    port = nn.Sequential(nn.Conv2D(6, 6, 1, device="cpu"),
                         nn.BatchNorm2D(6, device="cpu"))
    _carry(port, seq)
    conv = nn.SyncBatchNorm.convert_sync_batchnorm(port)
    assert isinstance(conv[1], nn.SyncBatchNorm) and conv[1].weight is \
        port[1].weight
    np.testing.assert_allclose(_np(conv(_t(x))), _np(seq(_j(x))), **FN)


def test_spectral_norm_matches_reference_across_calls():
    rng = np.random.RandomState(17)
    w = _rand(rng, (4, 3, 3, 3))
    ref = paddle.nn.SpectralNorm([4, 3, 3, 3], dim=1, power_iters=2)
    port = nn.SpectralNorm([4, 3, 3, 3], dim=1, power_iters=2, device="cpu")
    for _ in range(2):
        np.testing.assert_allclose(_np(port(_t(w))), _np(ref(_j(w))), **FN)
    np.testing.assert_allclose(_np(port.weight_u), _np(ref.weight_u), **FN)
    assert not port.weight_u.requires_grad


def test_conv_layers_take_reference_layouts_and_init_bounds():
    for ref, port, shape in (
            (paddle.nn.Conv2D(4, 6, 3, groups=2),
             nn.Conv2D(4, 6, 3, groups=2, device="cpu"), (6, 2, 3, 3)),
            (paddle.nn.Conv2DTranspose(4, 6, 3, groups=2),
             nn.Conv2DTranspose(4, 6, 3, groups=2, device="cpu"),
             (4, 3, 3, 3)),
            (paddle.nn.Conv1DTranspose(4, 6, 3),
             nn.Conv1DTranspose(4, 6, 3, device="cpu"), (4, 6, 3)),
            (paddle.nn.Conv3D(2, 3, 3, bias_attr=False),
             nn.Conv3D(2, 3, 3, bias_attr=False, device="cpu"),
             (3, 2, 3, 3, 3))):
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} \
            == {k: tuple(v.shape) for k, v in ref.state_dict().items()}
        assert tuple(port.weight.shape) == shape
        fan_in = (4 // port._groups if shape[0] == 4 and "Transpose"
                  in type(port).__name__ else shape[1]) * int(
            np.prod(shape[2:]))
        bound = 1 / np.sqrt(fan_in)
        for p in port.parameters():
            assert float(p.detach().abs().max()) <= bound
    x = _rand(np.random.RandomState(19), (2, 4, 7, 7))
    ref, port = paddle.nn.Conv2DTranspose(4, 6, 3, stride=2, padding=1), \
        nn.Conv2DTranspose(4, 6, 3, stride=2, padding=1, device="cpu")
    _carry(port, ref)
    np.testing.assert_allclose(_np(port(_t(x))), _np(ref(_j(x))), **FN)
    ref, port = paddle.nn.MaxPool2D(3, 2, 1), nn.MaxPool2D(3, 2, 1)
    np.testing.assert_allclose(_np(port(_t(x))), _np(ref(_j(x))), **FN)


# --------------------------------------------------------------- models

def _held(port, ref, x, train=True):
    """Forward (in training mode unless ``train=False``), then every
    gradient of a weighted sum of the output, then the batch-norm
    statistics."""
    port.train(train)
    ref.train() if train else ref.eval()
    out_r, out_p = ref(_j(x)), port(_t(x))
    np.testing.assert_allclose(_np(out_p), _np(out_r), **FN)
    g = np.random.RandomState(23).randn(*out_p.shape).astype(np.float32)
    (out_r * _j(g)).sum().backward()
    (out_p * _t(g)).sum().backward()
    grads = {n: _np(p.grad) for n, p in ref.named_parameters()}
    for n, p in port.named_parameters():
        np.testing.assert_allclose(_np(p.grad), grads[n], err_msg=n, **GRAD)
    bufs = {n: _np(b) for n, b in ref.named_buffers()}
    for n, b in port.named_buffers():
        np.testing.assert_allclose(_np(b), bufs[n], err_msg=n, **STATS)


def test_lenet_matches_reference():
    ref = jmodels.LeNet()
    port = models.LeNet(device="cpu")
    _carry(port, ref)
    _held(port, ref, _rand(np.random.RandomState(29), (4, 1, 28, 28)))


@pytest.fixture(scope="module")
def resnet50_pair():
    return jmodels.resnet50(), models.resnet50(device="cpu")


def test_resnet50_names_and_shapes_match_reference(resnet50_pair):
    ref, port = resnet50_pair
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert sum(p.numel() for p in port.parameters()) == 25557032
    assert sorted(n for n, _ in port.named_buffers()) == sorted(
        n for n, _ in ref.named_buffers())


def test_bottleneck_block_matches_reference(resnet50_pair):
    ref, port = resnet50_pair
    ref, port = ref.layer1[0], port.layer1[0]      # with its downsample
    _perturb(ref, 43)
    _carry(port, ref)
    _held(port, ref, _rand(np.random.RandomState(47), (2, 64, 8, 8)))


def test_resnet18_matches_reference():
    """In ``eval()``, on perturbed running statistics: at 2 x 3 x 32 x 32
    the last stage is 1 x 1, so in training its batch norms normalise 2
    values a channel and amplify rounding ~1000x (measured: 4e-3 on the
    logits against 2e-7 in eval); the bottleneck block below holds the
    training-mode path."""
    ref = jmodels.resnet18(num_classes=10)
    _perturb(ref, 31)
    port = models.resnet18(num_classes=10, device="cpu")
    _carry(port, ref)
    ref.eval()
    port.eval()
    _held(port, ref, _rand(np.random.RandomState(37), (2, 3, 32, 32)),
          train=False)
