"""The PyTorch port's fused decode-tick functions (K3a norm_matmul, K3b
matmul_residual), held against the JAX package's Pallas kernels run in
interpret mode in every mode (rms and ln with beta, per-projection
biases, None, swiglu and gelu_tanh), plus the port's own fused ==
unfused pin for Llama and for Qwen2's biased q/k/v, and the bf16 body
rule (``df.body``, ``df.split_config``) on each model's four calls.

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
from paddle_tpu_torch.models.qwen2 import Qwen2Config, Qwen2ForCausalLM
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
    got = df.norm_matmul(_t(x), _t(g), None, [_t(w) for w in ws],
                         [None] * len(ws), eps=1e-6, kind="rms")
    assert len(got) == len(widths)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=ATOL)


# kind, beta, widths, biases present: LayerNorm with beta; RMSNorm with
# some projections biased; Qwen2's biased q/k/v (GQA widths)
NORM_MODES = {
    "ln_beta": ("ln", True, (128, 64), (False, False)),
    "ln_beta_bias": ("ln", True, (192,), (True,)),
    "mixed_bias": ("rms", False, (128, 64, 64), (True, False, True)),
    "qwen2_qkv": ("rms", False, (128, 32, 32), (True, True, True)),
}


@pytest.mark.parametrize("rows", [3, 24])
@pytest.mark.parametrize("mode", list(NORM_MODES))
def test_norm_matmul_modes_match_interpreted_kernel(mode, rows):
    kind, has_beta, widths, has_bias = NORM_MODES[mode]
    rng = np.random.RandomState(rows + len(mode))
    d = 64
    x = (rng.randn(rows, d) + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    beta = (0.1 * rng.randn(d)).astype(np.float32) if has_beta else None
    ws = [(rng.randn(d, n) / 8).astype(np.float32) for n in widths]
    bs = [(rng.randn(n) / 4).astype(np.float32) if hb else None
          for n, hb in zip(widths, has_bias)]
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = jdf.pallas_norm_matmul(
        jnp.asarray(x), jnp.asarray(g), j(beta), [j(w) for w in ws],
        [j(b) for b in bs], eps=1e-5, kind=kind, interpret=True)
    t = lambda a: None if a is None else _t(a)  # noqa: E731
    got = df.norm_matmul(_t(x), _t(g), t(beta), [_t(w) for w in ws],
                         [t(b) for b in bs], eps=1e-5, kind=kind)
    assert len(got) == len(widths)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=ATOL)


@pytest.mark.parametrize("act", [None, "swiglu", "gelu_tanh"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_matmul_residual_matches_interpreted_kernel(act, with_bias):
    rng = np.random.RandomState(3 + with_bias)
    for rows in (2, 24):
        xs = [(rng.randn(rows, 256) / 8).astype(np.float32)
              for _ in range(2 if act == "swiglu" else 1)]
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
    ``_xla_matmul_residual`` (same roundings, same op order) in every
    mode."""
    rng = np.random.RandomState(9)
    x = rng.randn(5, 64).astype(np.float32)
    g = rng.randn(64).astype(np.float32)
    beta = rng.randn(64).astype(np.float32)
    ws = [rng.randn(64, 32).astype(np.float32) for _ in range(3)]
    bs = [rng.randn(32).astype(np.float32), None,
          rng.randn(32).astype(np.float32)]
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else _t(a)  # noqa: E731
    for kind, bt, bias in (("rms", None, [None] * 3), ("ln", beta, bs),
                           ("ln", None, bs), ("rms", None, bs)):
        want = jdf._xla_norm_matmul(jnp.asarray(x), jnp.asarray(g), j(bt),
                                    [jnp.asarray(w) for w in ws],
                                    [j(b) for b in bias], eps=1e-5,
                                    kind=kind)
        got = df.plain_norm_matmul(_t(x), _t(g), t(bt), [_t(w) for w in ws],
                                   [t(b) for b in bias], eps=1e-5,
                                   kind=kind)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)
    gu = [rng.randn(5, 32).astype(np.float32) for _ in range(2)]
    res = rng.randn(5, 64).astype(np.float32)
    w = rng.randn(32, 64).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    for act, xs, bias in (("swiglu", gu, None), ("gelu_tanh", gu[:1], b),
                          ("gelu_tanh", gu[:1], None), (None, gu[:1], b)):
        want = jdf._xla_matmul_residual([jnp.asarray(a) for a in xs],
                                        jnp.asarray(w), j(bias),
                                        jnp.asarray(res), act=act)
        got = df.plain_matmul_residual([_t(a) for a in xs], _t(w), t(bias),
                                       _t(res), act=act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-6)


def test_unsupported_inputs_raise():
    x = torch.zeros(2, 8)
    w = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="gelu_tanh"):
        df.matmul_residual([x], w, None, x, act="relu")
    with pytest.raises(ValueError, match="inputs"):
        df.matmul_residual([x], w, None, x, act="swiglu")
    with pytest.raises(ValueError, match="inputs"):
        df.matmul_residual([x, x], w, None, x, act="gelu_tanh")
    with pytest.raises(ValueError, match="'rms' or 'ln'"):
        df.norm_matmul(x, x[0], None, [w], [None], eps=1e-6, kind="l2")
    with pytest.raises(ValueError, match="beta"):
        df.norm_matmul(x, x[0], x[0], [w], [None], eps=1e-6, kind="rms")
    with pytest.raises(ValueError, match="biases"):
        df.norm_matmul(x, x[0], None, [w, w], [None], eps=1e-6, kind="rms")


# each model's four K3 calls a decoder layer, (K, widths): K3a into
# q/k/v, K3a into gate/up (GPT: fc1), K3b from o_proj, K3b into down (GPT:
# fc2)
K3_CALLS = {
    "gpt": ((1024, [3072]), (1024, [4096]), (1024, [1024]), (4096, [1024])),
    "llama3_8b": ((4096, [4096, 1024, 1024]), (4096, [14336, 14336]),
                  (4096, [4096]), (14336, [4096])),
    "qwen2_7b": ((3584, [3584, 512, 512]), (3584, [18944, 18944]),
                 (3584, [3584]), (18944, [3584]))}


@pytest.mark.parametrize("model", list(K3_CALLS))
def test_body_rule_names_each_models_calls(model):
    """The bf16 body rule, by shape alone: GPT's four calls take the split
    body at generate()'s 4 rows, the pure tick's 8 and the prefill tick's
    136 (128-column tiles: q/k/v over clusters of 4, fc1 of 3, out_proj
    and fc2 of 8; 64-96 blocks), the
    stream-K body past 192 rows; Llama-3-8B's and Qwen2-7B's take the
    stream-K body at every row count."""
    gpt = [(128, 4, 96), (128, 3, 96), (128, 8, 64), (128, 8, 64)]
    for i, (k, widths) in enumerate(K3_CALLS[model]):
        for r in (1, 4, 8, 136, 192):
            assert df.body(r, k, widths) == (
                "split_k" if model == "gpt" else "stream_k")
        assert df.body(193, k, widths) == "stream_k"
        if model == "gpt":
            assert df.split_config(k, widths) == gpt[i]


def test_split_gives_every_cluster_block_a_slice():
    """The split body's split over depths and widths: every block of a
    cluster gets at least one 64-deep slice, a cluster holds at most 8
    blocks, and a split above 1 keeps the call within 96 blocks."""
    for k in (8, 64, 72, 320, 1000, 1024, 1384, 4040, 4096, 14336):
        for widths in ([8], [64], [200], [1024], [3072], [64, 128],
                       [256, 64, 96], [33000]):
            bn, split, blocks = df.split_config(k, widths)
            nk = -(-k // 64)
            per = -(-nk // split)
            assert bn == 128 and 1 <= split <= df.SPLIT_MAX
            assert -(-nk // per) == split, (k, widths)
            tiles = sum(-(-n // bn) for n in widths)
            assert blocks == tiles * split
            assert split == 1 or blocks <= df.SPLIT_BLOCKS


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


def _fused_equals_unfused(model):
    with torch.no_grad():        # norm weights away from 1 for coverage
        for name, p in model.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.normal_(1.0 if "norm" in name else 0.0, 0.1,
                          generator=torch.Generator().manual_seed(1))
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


def test_fused_layer_equals_unfused_bitwise_on_cpu():
    cfg = LlamaConfig.tiny(vocab=128, hidden=256, layers=2, heads=4,
                           kv_heads=2, ffn=256)
    _fused_equals_unfused(LlamaForCausalLM(cfg, device="cpu", seed=3))


def test_biased_fused_layer_equals_unfused_bitwise_on_cpu():
    """Qwen2's q/k/v biases ride K3a's epilogue on the fused path."""
    cfg = Qwen2Config.tiny(vocab=128, hidden=256, layers=2, heads=4,
                           kv_heads=2, ffn=256)
    model = Qwen2ForCausalLM(cfg, device="cpu", seed=3)
    assert model.base.layers[0].self_attn.q_proj.bias is not None
    _fused_equals_unfused(model)


def test_wrappers_raise_on_backward_with_grad_enabled():
    """K3a / K3b have no backward: called with gradients enabled on an
    input that requires them, the output's node raises naming the
    kernel (as differentiating a ``pallas_call`` without a VJP fails);
    under ``no_grad`` the output carries no node."""
    rng = np.random.RandomState(5)
    x = _t(rng.randn(3, 16).astype(np.float32)).requires_grad_()
    gamma, w = _t(rng.rand(16).astype(np.float32)), _t(
        rng.randn(16, 16).astype(np.float32))
    calls = {"norm_matmul": lambda: df.norm_matmul(
                 x, gamma, None, [w], [None], eps=1e-6, kind="rms")[0],
             "matmul_residual": lambda: df.matmul_residual([x], w, None, x)}
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=name):
            call().sum().backward()
        with torch.no_grad():
            assert call().grad_fn is None
