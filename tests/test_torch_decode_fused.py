"""The PyTorch port's fused decode-tick functions (K3a norm_matmul, K3b
matmul_residual), held against the JAX package's Pallas kernels run in
interpret mode, plus the port's own fused == unfused pin.

Tolerances: 1e-5 absolute in float32 against the interpreted kernels
(the same float32 products summed in another order); the fused decoder
layer equals the unfused one BITWISE on the CPU, because the plain
versions are op for op the unfused module path.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import decode_fused as jdf
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import paged_cache as tpc
from paddle_tpu_torch.ops.kernels import decode_fused as df
from paddle_tpu_torch.ops.kernels import launch_counts

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("rows", [2, 6, 24])      # decode/verify/chunk
@pytest.mark.parametrize("widths", [(128,), (128, 64), (128, 64, 64)])
def test_norm_matmul_matches_interpreted_kernel(rows, widths):
    rng = np.random.RandomState(rows + len(widths))
    d = 64
    x = rng.randn(rows, d).astype(np.float32)
    g = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    ws = [(rng.randn(d, n) / 8).astype(np.float32) for n in widths]
    want = jdf.pallas_norm_matmul(
        jnp.asarray(x), jnp.asarray(g), None, [jnp.asarray(w) for w in ws],
        [None] * len(ws), eps=1e-6, kind="rms", interpret=True)
    got = df.norm_matmul(_t(x), _t(g), [_t(w) for w in ws], 1e-6)
    assert len(got) == len(widths)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=ATOL)


@pytest.mark.parametrize("act", [None, "swiglu"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_matmul_residual_matches_interpreted_kernel(act, with_bias):
    rng = np.random.RandomState(3 + with_bias)
    for rows in (2, 24):
        xs = [(rng.randn(rows, 256) / 8).astype(np.float32)
              for _ in range(2 if act else 1)]
        w = (rng.randn(256, 128) / 8).astype(np.float32)
        b = (rng.randn(128) / 8).astype(np.float32) if with_bias else None
        res = rng.randn(rows, 128).astype(np.float32)
        want = jdf.pallas_matmul_residual(
            [jnp.asarray(x) for x in xs], jnp.asarray(w),
            None if b is None else jnp.asarray(b), jnp.asarray(res),
            act=act, interpret=True)
        got = df.matmul_residual([_t(x) for x in xs], _t(w),
                                 None if b is None else _t(b), _t(res),
                                 act=act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=ATOL)


def test_plain_versions_follow_the_reference_recipes():
    """The plain versions restate ``_xla_norm_matmul`` /
    ``_xla_matmul_residual`` (same roundings, same op order)."""
    rng = np.random.RandomState(9)
    x = rng.randn(5, 64).astype(np.float32)
    g = rng.randn(64).astype(np.float32)
    ws = [rng.randn(64, 32).astype(np.float32) for _ in range(3)]
    want = jdf._xla_norm_matmul(jnp.asarray(x), jnp.asarray(g), None,
                                [jnp.asarray(w) for w in ws], [None] * 3,
                                eps=1e-5, kind="rms")
    got = df.plain_norm_matmul(_t(x), _t(g), [_t(w) for w in ws], 1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    gu = [rng.randn(5, 32).astype(np.float32) for _ in range(2)]
    res = rng.randn(5, 64).astype(np.float32)
    w = rng.randn(32, 64).astype(np.float32)
    want = jdf._xla_matmul_residual([jnp.asarray(a) for a in gu],
                                    jnp.asarray(w), None, jnp.asarray(res),
                                    act="swiglu")
    got = df.plain_matmul_residual([_t(a) for a in gu], _t(w), None,
                                   _t(res), act="swiglu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)


def test_unsupported_inputs_raise():
    x = torch.zeros(2, 8)
    with pytest.raises(NotImplementedError, match="swiglu"):
        df.matmul_residual([x], torch.zeros(8, 8), None, x, act="gelu_tanh")
    with pytest.raises(ValueError, match="inputs"):
        df.matmul_residual([x], torch.zeros(8, 8), None, x, act="swiglu")


def _tick(model, seed):
    """One ragged tick over a fresh pool: a 5-row prefill chunk, a
    decode row and an idle slot."""
    cfg = model.config
    rng = np.random.RandomState(seed)
    q_lens = np.asarray([5, 1, 0], np.int64)
    base = np.asarray([0, 9, 0], np.int64)
    bs, mb = 8, 4
    pools = model.init_paged_caches(1 + 3 * mb, bs)
    for kp, vp in pools:
        kp.copy_(torch.from_numpy(rng.randn(*kp.shape).astype(np.float32)))
        vp.copy_(torch.from_numpy(rng.randn(*vp.shape).astype(np.float32)))
    tables = (1 + np.arange(3 * mb, dtype=np.int32)).reshape(3, mb)
    R = int(q_lens.sum())
    row_slot, row_pos, row_starts, last = tpc.ragged_row_meta(
        q_lens, base, R, mb * bs)
    ids = rng.randint(0, cfg.vocab_size, size=R).astype(np.int32)
    meta = (_t(q_lens.astype(np.int32)), _t(row_starts), _t(row_slot),
            _t(row_pos), int(q_lens.max()))
    return (_t(ids), pools, _t(tables), _t(base.astype(np.int32)), meta,
            _t(last))


def test_fused_layer_equals_unfused_bitwise_on_cpu():
    cfg = LlamaConfig.tiny(vocab=128, hidden=256, layers=2, heads=4,
                           kv_heads=2, ffn=256)
    model = LlamaForCausalLM(cfg, device="cpu", seed=3)
    with torch.no_grad():        # norm weights away from 1 for coverage
        for name, p in model.named_parameters():
            if "norm" in name:
                p.normal_(1.0, 0.1, generator=torch.Generator().manual_seed(1))
    outs = {}
    for fused in (True, False):
        ids, pools, tables, base, meta, last = _tick(model, seed=5)
        with torch.no_grad():
            logits, pools = model(ids, caches=pools, block_tables=tables,
                                  cache_lens=base, ragged_meta=meta,
                                  fused=fused)
        outs[fused] = (logits, pools)
    torch.testing.assert_close(outs[True][0], outs[False][0], rtol=0,
                               atol=0)
    for (k1, v1), (k2, v2) in zip(outs[True][1], outs[False][1]):
        assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_wrappers_raise_on_backward_with_grad_enabled():
    """K3a / K3b have no backward: called with gradients enabled on an
    input that requires them, the output's node raises naming the
    kernel (as differentiating a ``pallas_call`` without a VJP fails);
    under ``no_grad`` the output carries no node."""
    rng = np.random.RandomState(5)
    x = _t(rng.randn(3, 16).astype(np.float32)).requires_grad_()
    gamma, w = _t(rng.rand(16).astype(np.float32)), _t(
        rng.randn(16, 16).astype(np.float32))
    calls = {"norm_matmul": lambda: df.norm_matmul(x, gamma, [w], 1e-6)[0],
             "matmul_residual": lambda: df.matmul_residual([x], w, None, x)}
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=name):
            call().sum().backward()
        with torch.no_grad():
            assert call().grad_fn is None
