"""The port's high-level training path against the JAX package on the
CPU: ``Model.fit`` / ``evaluate`` / ``predict`` on LeNet (through
``TrainStep`` and through the eager step), its callbacks, checkpoints
across the two packages, ``io``'s datasets, samplers and ``DataLoader``
(with and without a worker process), ``metric``, the vision datasets
and transforms, the batch-norm statistics under ``TrainStep``, and the
two repairs this path needed: ``seed()`` seeds numpy's generator, and
``load_jax_params`` carries a model's buffers.

Inputs are seeded with numpy; weights move across with
``load_jax_params``. Tolerances: LeNet's losses and outputs over a few
Adam steps rtol 1e-4, atol 1e-5 (float32 products and sums in another
order, carried through the update); metrics, batches, datasets and
transforms exactly (the same numpy arithmetic); batch-norm statistics
after three steps rtol 1e-5, atol 1e-6.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.jit import TrainStep

STEP = dict(rtol=1e-4, atol=1e-5)
STATS = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x.numpy())


def _state(layer):
    return {k: np.asarray(_np(v)) for k, v in layer.state_dict().items()}


def _carry(port, ref):
    load_jax_params(port, {k: np.asarray(v.numpy())
                           for k, v in ref.state_dict().items()})


# --------------------------------------------------------------- repairs

def test_seed_seeds_numpy_as_reference():
    paddle.seed(123)
    want = np.random.rand(4)
    pt.seed(123)
    np.testing.assert_array_equal(np.random.rand(4), want)


def test_load_jax_params_carries_buffers_and_checks_names():
    """A batch norm's ``_mean`` / ``_variance`` cross with the
    parameters; a dict of parameters alone still loads (the port's
    models' callers) and leaves the buffers; an unknown name or a shape
    that disagrees raises."""
    ref = paddle.nn.Sequential(paddle.nn.Conv2D(1, 2, 3),
                               paddle.nn.BatchNorm2D(2))
    ref.train()
    ref(paddle.to_tensor(np.random.RandomState(0).rand(4, 1, 6, 6)
                         .astype(np.float32)))
    port = pt.nn.Sequential(pt.nn.Conv2D(1, 2, 3, device="cpu"),
                            pt.nn.BatchNorm2D(2, device="cpu"))
    sd = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    assert {"1._mean", "1._variance"} <= set(sd)
    params = {k: v for k, v in sd.items() if not k.endswith(
        ("_mean", "_variance"))}
    load_jax_params(port, params)
    np.testing.assert_array_equal(_np(port[1]._mean), np.zeros(2))
    load_jax_params(port, sd)
    for k, v in _state(port).items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(port, dict(sd, extra=np.zeros(1, np.float32)))
    with pytest.raises(ValueError, match="1._mean"):
        load_jax_params(port, dict(sd, **{"1._mean": np.zeros(
            3, np.float32)}))


def test_batch_norm_statistics_under_train_step_match_reference():
    """The reference's ``test_bn_buffers_update_under_trainstep``, held
    to the reference: three SGD steps move the running statistics, the
    losses and the statistics equal the reference's."""
    def net(mod, **kw):
        return mod.Sequential(mod.Conv2D(1, 2, 3, padding=1, **kw),
                              mod.BatchNorm2D(2, **kw), mod.Flatten(),
                              mod.Linear(2 * 4 * 4, 2, **kw))
    ref, port = net(paddle.nn), net(pt.nn, device="cpu")
    _carry(port, ref)
    rng = np.random.RandomState(3)
    xs = [rng.rand(4, 1, 4, 4).astype(np.float32) for _ in range(3)]
    y = np.array([0, 1, 0, 1], np.int64)
    loss_r, loss_p = paddle.nn.CrossEntropyLoss(), pt.nn.CrossEntropyLoss()
    step_r = JTrainStep(ref, lambda out, a, k: loss_r(
        out, paddle.Tensor(k["_labels"][0])), paddle.optimizer.SGD(
        0.1, parameters=ref.parameters()))
    step_p = TrainStep(port, lambda out, a, k: loss_p(
        out, k["_labels"][0]), pt.optimizer.SGD(
        0.1, parameters=port.parameters()))
    before = _np(port[1]._mean).copy()
    for x in xs:
        lr = float(step_r(paddle.to_tensor(x),
                          _labels=(paddle.to_tensor(y),)).numpy())
        lp = float(step_p(x, _labels=(y,)))
        np.testing.assert_allclose(lp, lr, **STEP)
    assert not np.allclose(before, _np(port[1]._mean))
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(_np(getattr(port[1], name)),
                                   _np(getattr(ref[1], name)), **STATS)


# --------------------------------------------------------------- Model.fit

def _recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.losses, self.epochs = [], 0

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(np.ravel(logs["loss"])[0]))

        def on_epoch_end(self, epoch, logs=None):
            self.epochs += 1
    return Recorder()


def _fit(pkg, lenet, jit, tmp, seed):
    from importlib import import_module
    io = import_module(pkg.__name__ + ".io")
    ds = import_module(pkg.__name__ + ".vision.datasets")
    cb = import_module(pkg.__name__ + ".hapi.callbacks")
    model = pkg.Model(lenet)
    model.prepare(pkg.optimizer.Adam(1e-3, parameters=model.parameters()),
                  pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy(topk=(1, 2)),
                  jit_compile=jit)
    rec = _recorder(cb.Callback)
    pkg.seed(seed)
    model.fit(io.Subset(ds.MNIST(mode="train"), range(32)),
              io.Subset(ds.MNIST(mode="test"), range(16)), batch_size=16,
              epochs=3, verbose=0,
              callbacks=[rec, cb.EarlyStopping("loss", patience=1,
                                               min_delta=10.0),
                         cb.VisualDL(tmp)])
    test = io.Subset(ds.MNIST(mode="test"), range(32))
    logs = model.evaluate(test, batch_size=16, verbose=0)
    pred = model.predict(test, batch_size=16, stack_outputs=True)
    with open(os.path.join(tmp, "scalars.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return rec, logs, pred[0], lines


@pytest.mark.parametrize("jit", [True, False], ids=["train_step", "eager"])
def test_model_fit_evaluate_predict_match_reference(jit, tmp_path):
    """Shuffled batches (the same numpy draws in both packages, the second
    epoch's after the step's own draw), Adam steps, per-batch losses,
    early stopping after the second evaluation, VisualDL's lines, then
    ``evaluate``'s loss and top-1 / top-2 accuracy and ``predict``'s
    outputs."""
    ref_net = paddle.vision.models.LeNet()
    port_net = pt.vision.models.LeNet(device="cpu")
    _carry(port_net, ref_net)
    rr, rl, rp, rlines = _fit(paddle, ref_net, jit, str(tmp_path / "r"), 9)
    pr, pl, pp, plines = _fit(pt, port_net, jit, str(tmp_path / "p"), 9)
    assert rr.epochs == pr.epochs == 2 and len(pr.losses) == 4
    np.testing.assert_allclose(pr.losses, rr.losses, **STEP)
    assert len(plines) == len(rlines) == 6
    assert [r["mode"] for r in plines] == [r["mode"] for r in rlines]
    assert sorted(pl) == sorted(rl) == ["acc_top1", "acc_top2", "loss"]
    for k in rl:
        np.testing.assert_allclose(np.ravel(pl[k]), np.ravel(rl[k]), **STEP)
    assert pp.shape == (32, 10) and pp.dtype == np.float32
    np.testing.assert_allclose(pp, np.asarray(rp), rtol=1e-4, atol=1e-4)


def test_model_runs_on_its_networks_device_and_refuses_a_missing_gpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.vision.models.LeNet()
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.nn.Conv2D(1, 2, 3)
    net = pt.vision.models.LeNet(num_classes=4, device="cpu")
    model = pt.Model(net)
    assert model.device == torch.device("cpu")
    model.prepare(pt.optimizer.Momentum(0.1, parameters=net.parameters()),
                  pt.nn.CrossEntropyLoss())
    loss = model.train_batch(np.random.rand(2, 1, 28, 28).astype(
        np.float32), np.array([1, 3], np.int64))
    assert np.isfinite(loss[0])
    ref = paddle.Model(paddle.vision.models.LeNet(num_classes=4))
    assert model.summary() == ref.summary()


# --------------------------------------------------------------- checkpoints

def test_checkpoints_cross_both_ways(tmp_path):
    def net(mod, **kw):
        return mod.Sequential(mod.Conv2D(1, 2, 3, **kw),
                              mod.BatchNorm2D(2, **kw))
    ref, port = net(paddle.nn), net(pt.nn, device="cpu")
    ref.train()
    ref(paddle.to_tensor(np.random.RandomState(1).rand(2, 1, 5, 5)
                         .astype(np.float32)))
    path = str(tmp_path / "ref" / "ckpt")
    paddle.Model(ref).save(path, training=False)
    pt.Model(port).load(path)
    want = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    for k, v in _state(port).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    with torch.no_grad():
        for p in port.parameters():
            p.mul_(2.0)
    path = str(tmp_path / "port" / "ckpt")
    pt.Model(port).save(path, training=False)
    paddle.Model(ref).load(path)
    for k, v in ref.state_dict().items():
        np.testing.assert_array_equal(np.asarray(v.numpy()),
                                      _state(port)[k], err_msg=k)
    raw = pt.load(path + ".pdparams", return_numpy=True)
    assert isinstance(raw["1._mean"], np.ndarray)


def test_save_load_round_trips_optimizer_state_and_bfloat16(tmp_path):
    net = pt.nn.Linear(3, 2, device="cpu")
    model = pt.Model(net)
    model.prepare(pt.optimizer.Adam(1e-2, parameters=net.parameters()),
                  pt.nn.MSELoss())
    x, y = np.ones((4, 3), np.float32), np.zeros((4, 2), np.float32)
    model.train_batch(x, y)
    path = str(tmp_path / "m")
    model.save(path)
    after_save = model.train_batch(x, y)
    model.load(path)
    assert model.train_batch(x, y) == after_save
    obj = {"w": torch.ones(2, dtype=torch.bfloat16), "n": [1, (2.0, "a")]}
    pt.save(obj, str(tmp_path / "o.pd"))
    back = pt.load(str(tmp_path / "o.pd"))
    assert back["n"] == [1, (2.0, "a")]
    assert back["w"].dtype == torch.float32 and back["w"].tolist() == [1, 1]


# --------------------------------------------------------------- io

def _batches(pkg, loader_kw, seed, n=37):
    rng = np.random.RandomState(5)
    x = rng.rand(n, 3).astype(np.float32)
    y = rng.randint(0, 5, size=n).astype(np.int64)
    pkg.seed(seed)
    loader = pkg.io.DataLoader(pkg.io.TensorDataset([x, y]), **loader_kw)
    return len(loader), [tuple(_np(t) for t in b) for b in loader]


@pytest.mark.parametrize("case", ["shuffle", "drop_last", "one_worker"])
def test_dataloader_batches_match_reference(case):
    """The port's batches against the reference's in-process loader: with
    a worker process the port's parent still draws the indices, so the
    batches are the in-process ones (the reference's worker draws its
    own)."""
    kw = {"shuffle": dict(batch_size=8, shuffle=True),
          "drop_last": dict(batch_size=8, shuffle=True, drop_last=True),
          "one_worker": dict(batch_size=8, shuffle=True)}[case]
    n_r, want = _batches(paddle, kw, 17)
    port_kw = dict(kw, num_workers=1) if case == "one_worker" else kw
    n_p, got = _batches(pt, port_kw, 17)
    assert n_p == n_r == len(want) == len(got)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gy.dtype == np.int64
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_datasets_samplers_and_splits_match_reference():
    data = np.arange(20).reshape(10, 2)
    for name in ("Subset", "ConcatDataset", "ComposeDataset"):
        r, p = getattr(paddle.io, name), getattr(pt.io, name)
        if name == "Subset":
            r, p = r(data, [3, 1, 7]), p(data, [3, 1, 7])
        else:
            r, p = r([data, data[:4]]), p([data, data[:4]])
        assert len(r) == len(p)
        for i in range(len(r)):
            np.testing.assert_array_equal(np.asarray(p[i]), np.asarray(r[i]))
    chain = [v for v in pt.io.ChainDataset([range(2), range(3)])]
    assert chain == [v for v in paddle.io.ChainDataset([range(2),
                                                         range(3)])]
    for mod in (paddle, pt):
        mod.seed(4)
        out = [[s.indices for s in mod.io.random_split(data, [0.5, 0.3,
                                                               0.2])],
               list(mod.io.WeightedRandomSampler([1, 2, 3], 6)),
               list(mod.io.SubsetRandomSampler([4, 5, 6])),
               list(mod.io.RandomSampler(data, replacement=True,
                                         num_samples=5)),
               list(mod.io.DistributedBatchSampler(data, 3, num_replicas=2,
                                                   rank=1, shuffle=True))]
        if mod is paddle:
            want = out
    assert out == want
    assert pt.io.get_worker_info() is None
    batch = pt.io.default_collate_fn([{"a": 1, "b": (2.5, np.ones(2))}] * 3)
    assert batch["a"].dtype == torch.int64 and batch["b"][0].dtype == \
        torch.float32 and tuple(batch["b"][1].shape) == (3, 2)


class _Shards(pt.io.IterableDataset):
    """Worker ``w`` of ``n`` yields ``w, w + n, ...`` below 10."""

    def __iter__(self):
        info = pt.io.get_worker_info()
        w, n = (info.id, info.num_workers) if info else (0, 1)
        return iter(range(w, 10, n))


def test_iterable_dataset_shards_over_two_workers():
    got = [int(v) for b in pt.io.DataLoader(_Shards(), batch_size=None,
                                             num_workers=2) for v in [b]]
    assert sorted(got) == list(range(10))
    threaded = list(pt.io.DataLoader(_Shards(), batch_size=4, num_workers=2,
                                     use_shared_memory=False))
    assert [b.tolist() for b in threaded] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                              [8, 9]]


# --------------------------------------------------------------- metrics

def test_metrics_match_reference():
    rng = np.random.RandomState(8)
    pred = rng.rand(12, 5).astype(np.float32)
    label = rng.randint(0, 5, size=(12, 1)).astype(np.int64)
    ra, pa = paddle.metric.Accuracy(topk=(1, 3)), \
        pt.metric.Accuracy(topk=(1, 3))
    rc = ra.compute(paddle.to_tensor(pred), paddle.to_tensor(label))
    pc = pa.compute(torch.from_numpy(pred), torch.from_numpy(label))
    np.testing.assert_array_equal(pc, np.asarray(rc))
    assert pa.update(pc) == ra.update(rc)
    assert pa.accumulate() == ra.accumulate() and pa.name() == ra.name()
    prob = rng.rand(40).astype(np.float32)
    lab = rng.randint(0, 2, size=40).astype(np.int64)
    for name in ("Precision", "Recall", "Auc"):
        r, p = getattr(paddle.metric, name)(), getattr(pt.metric, name)()
        r.update(prob, lab)
        p.update(torch.from_numpy(prob), torch.from_numpy(lab))
        assert p.accumulate() == r.accumulate() and p.name() == r.name()
    assert float(pt.metric.accuracy(torch.from_numpy(pred),
                                    torch.from_numpy(label), k=2)) == \
        float(paddle.metric.accuracy(paddle.to_tensor(pred),
                                     paddle.to_tensor(label), k=2).numpy())


# --------------------------------------------------------------- vision data

def test_datasets_match_reference(tmp_path):
    from paddle_tpu.vision import datasets as jds
    from paddle_tpu_torch.vision import datasets as pds
    for name, mode in (("MNIST", "train"), ("FashionMNIST", "test"),
                       ("Cifar10", "test"), ("Flowers", "test")):
        r, p = getattr(jds, name)(mode=mode), getattr(pds, name)(mode=mode)
        assert len(p) == len(r)
        for i in (0, len(r) - 1):
            (ri, rl), (pi, pl) = r[i], p[i]
            np.testing.assert_array_equal(pi, ri)
            assert pl == rl and pl.dtype == np.int64
    for c in ("cat", "dog"):
        os.makedirs(tmp_path / c)
        np.save(tmp_path / c / "a.npy", np.full((2, 2), len(c)))
    r, p = jds.ImageFolder(str(tmp_path)), pds.ImageFolder(str(tmp_path))
    assert p.class_to_idx == r.class_to_idx and len(p) == len(r) == 2
    np.testing.assert_array_equal(p[1][0], r[1][0])


def test_transforms_match_reference():
    import random
    from paddle_tpu.vision import transforms as jt
    from paddle_tpu_torch.vision import transforms as ptr
    img = np.random.RandomState(2).randint(0, 255, (10, 12, 3)) \
        .astype(np.uint8)
    for name, args in (("Resize", ((6, 8),)), ("Resize", (5, "nearest")),
                       ("CenterCrop", (6,)), ("Pad", ([1, 2],)),
                       ("Transpose", ()), ("RandomCrop", (6, 1)),
                       ("RandomHorizontalFlip", (0.5,)),
                       ("RandomVerticalFlip", (0.5,)),
                       ("BrightnessTransform", (0.4,)),
                       ("RandomResizedCrop", (7,))):
        random.seed(3)
        want = getattr(jt, name)(*args)(img)
        random.seed(3)
        got = getattr(ptr, name)(*args)(img)
        np.testing.assert_array_equal(got, want, err_msg=name)
    pipe = [ptr.Compose([ptr.ToTensor(), ptr.Normalize(0.5, 0.25)]),
            jt.Compose([jt.ToTensor(), jt.Normalize(0.5, 0.25)])]
    got, want = pipe[0](img), pipe[1](img)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == (3, 10, 12)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    assert repr(pt.static.InputSpec([None, 3], "float32", "x")) == repr(
        paddle.static.InputSpec([None, 3], "float32", "x"))
