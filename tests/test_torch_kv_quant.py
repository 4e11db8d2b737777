"""The PyTorch port's int8 paged KV cache against the JAX package on the
CPU.

An int8 pool half is ``QuantKV``: int8 data ``[NB, BS, Hkv, D]`` and a
float32 absmax scale ``[NB, BS, Hkv]``. The port must quantize and
dequantize exactly as the reference does (bit for bit, zero rows
included: ``torch.round`` and ``jnp.round`` both round half to even),
store the reference's bytes and scales through every write path, and its
plain K2d, K2v and K2r must match the reference's Pallas kernels run in
interpret mode on int8 pools (rtol = atol = 1e-5: both keep float32
through the products, summed in another order) at GQA groups 1, 2 and 4
and block sizes 8 and 16. On the reference's tiny Llama the port's
engine and ``generate()`` (paged, n-gram speculative) on int8 pools give
the reference's greedy tokens. Inputs come from ``numpy.random`` seeds
and cross between the packages as numpy arrays.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import ServingConfig as JaxServingConfig
from paddle_tpu.inference import ServingEngine as JaxServingEngine
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops import paged_cache as jpc
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.convert import load_jax_params, pool_from_jax
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.models import (DeepseekMoeConfig,
                                     DeepseekMoeForCausalLM, Qwen2Config,
                                     Qwen2ForCausalLM, Qwen2MoeConfig,
                                     Qwen2MoeForCausalLM)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import paged_cache as tpc
from paddle_tpu_torch.ops.kernels import paged_attention as pda
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

TOL = dict(rtol=1e-5, atol=1e-5)
# the reference's tiny Llama of its int8 tests, its engine layout and
# prompts (tests/test_kv_quant.py)
TINY = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128)
ENGINE = dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8)
MATCH_FLOOR = 0.9


@pytest.fixture(autouse=True)
def _no_env_twin(monkeypatch):
    # the reference's PADDLE_TPU_KV_INT8 switch would change its answers
    monkeypatch.delenv("PADDLE_TPU_KV_INT8", raising=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_quantize_and_dequantize_match_reference_bit_for_bit():
    rng = np.random.RandomState(0)
    x = (rng.randn(12, 3, 64) * rng.exponential(size=(12, 3, 1))
         * 10.0 ** rng.uniform(-3, 3, size=(12, 1, 1))).astype(np.float32)
    x[2] = 0.0                                  # zero rows: scale 0
    x[5, 1] = np.arange(64) / 2.0 - 16.0        # halves: ties to even
    qj, sj = jpc.kv_quantize(jnp.asarray(x))
    qt, st = tpc.kv_quantize(_t(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))
    assert float(st[2].abs().max()) == 0.0
    np.testing.assert_array_equal(
        _bits(tpc.kv_dequantize(qt, st).numpy()),
        _bits(jpc.kv_dequantize(qj, sj)))
    assert float(tpc.kv_dequantize(qt, st)[2].abs().max()) == 0.0
    # bfloat16 rows quantize from their float32 values, as the reference
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    qj, sj = jpc.kv_quantize(xb)
    qt, st = tpc.kv_quantize(_t(np.asarray(xb.astype(jnp.float32)))
                             .to(torch.bfloat16))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))


@pytest.mark.parametrize("req", [None, "auto", "int8", "INT8", "fp8",
                                 "float16"])
def test_resolve_kv_cache_dtype_matches_reference(req):
    try:
        want = jpc.resolve_kv_cache_dtype(req)
    except ValueError:
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            tpc.resolve_kv_cache_dtype(req)
        return
    assert tpc.resolve_kv_cache_dtype(req) == want


def test_writes_store_reference_bytes_and_scales():
    """write_prefill (n_real null-routing), write_decode, write_tokens
    (across a block boundary and past the table's reach) and write_rows
    (a pad row at the overflow position) on int8 pools: every live block
    holds the reference's int8 bytes and scales."""
    rng = np.random.RandomState(1)
    S, MB, BS, H, D = 2, 3, 8, 2, 64
    NB = 1 + S * MB
    tables = (1 + np.arange(S * MB, dtype=np.int32)).reshape(S, MB)
    jk, jv = jpc.init_pool(NB, BS, H, D, "int8")
    tk, tv = tpc.init_pool(NB, BS, H, D, "int8", "cpu")
    assert isinstance(tk, tpc.QuantKV) and tk.dtype == torch.int8
    assert tk.shape == jk.shape and tk.ndim == jk.ndim == 4
    assert tk.nbytes == jk.nbytes

    def both(jfn, tfn, *args):
        nonlocal jk, jv
        jk, jv = jfn(jk, jv, *[jnp.asarray(a) for a in args])
        tfn(tk, tv, *[_t(a) for a in args])
        for p, r in ((tk, jk), (tv, jv)):
            np.testing.assert_array_equal(p.data.numpy()[1:],
                                          np.asarray(r.data)[1:])
            np.testing.assert_array_equal(_bits(p.scale.numpy()[1:]),
                                          _bits(np.asarray(r.scale)[1:]))

    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    both(jpc.write_prefill, tpc.write_prefill, tables, f(S, 10, H, D),
         f(S, 10, H, D), np.asarray([10, 3]))
    # the masked prefill tail of slot 1 never reached its blocks
    assert float(tk.scale[1 + MB, 3:].abs().max()) == 0.0
    both(jpc.write_decode, tpc.write_decode, tables,
         np.asarray([10, 5], np.int32), f(S, H, D), f(S, H, D))
    both(jpc.write_tokens, tpc.write_tokens, tables,
         np.asarray([6, MB * BS - 2], np.int32), f(S, 4, H, D),
         f(S, 4, H, D))
    both(jpc.write_rows, tpc.write_rows, tables,
         np.asarray([0, 1, 0], np.int32),
         np.asarray([11, 17, MB * BS], np.int32), f(3, H, D), f(3, H, D))
    # gather_dense reads the pool back dequantized, as the reference
    np.testing.assert_array_equal(
        _bits(tpc.gather_dense(tk, _t(tables)).numpy()),
        _bits(jpc.gather_dense(jk, jnp.asarray(tables))))


def test_pool_bytes_ratio_vs_fp16():
    q = tpc.init_pool(33, 32, 4, 64, "int8", "cpu")
    f = tpc.init_pool(33, 32, 4, 64, torch.float16, "cpu")
    ratio = tpc.pool_bytes([q]) / tpc.pool_bytes([f])
    assert ratio <= 0.55, ratio
    assert tpc.pool_bytes([q]) == jpc.pool_bytes(
        [jpc.init_pool(33, 32, 4, 64, "int8")])


def _quant_pools(rng, NB, BS, Hkv, D):
    """Reference int8 pools quantized from random rows, and the port's
    copies of them."""
    ref = [jpc.QuantKV(*jpc.kv_quantize(jnp.asarray(
        rng.randn(NB, BS, Hkv, D).astype(np.float32)))) for _ in "kv"]
    return ref, [pool_from_jax(p, "cpu") for p in ref]


def _tables(S, MB, seed):
    perm = np.random.RandomState(seed).permutation(S * MB) + 1
    return perm.reshape(S, MB).astype(np.int32)


GROUPS = [(rep, bs) for rep in (1, 2, 4) for bs in (8, 16)]


@pytest.mark.parametrize("rep,bs", GROUPS)
def test_plain_decode_on_int8_pools_matches_interpreted_kernel(rep, bs):
    rng = np.random.RandomState(10 * bs + rep)
    S, MB, Hkv, D = 3, 4, 2, 64
    (jk, jv), (tk, tv) = _quant_pools(rng, 1 + S * MB, bs, Hkv, D)
    tables = _tables(S, MB, rep)
    lens = np.asarray([1, bs + 3, MB * bs], np.int32)
    q = rng.randn(S, Hkv * rep, D).astype(np.float32)
    want = jpa.pallas_paged_attention(jnp.asarray(q), jk, jv,
                                      jnp.asarray(tables),
                                      jnp.asarray(lens), interpret=True)
    got = pda.paged_decode_attention(_t(q), tk, tv, _t(tables), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rep,bs", GROUPS)
def test_plain_verify_on_int8_pools_matches_interpreted_kernel(rep, bs):
    rng = np.random.RandomState(100 + 10 * bs + rep)
    S, MB, Hkv, D, T = 3, 4, 2, 64, 3
    (jk, jv), (tk, tv) = _quant_pools(rng, 1 + S * MB, bs, Hkv, D)
    tables = _tables(S, MB, rep + 1)
    lens = np.asarray([2, bs, MB * bs - T + 1], np.int32)
    q = rng.randn(S, T, Hkv * rep, D).astype(np.float32)
    want = jpa.pallas_paged_verify_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(lens),
        interpret=True)
    got = pda.paged_verify_attention(_t(q), tk, tv, _t(tables), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rep,bs", GROUPS)
def test_plain_ragged_on_int8_pools_matches_interpreted_kernel(rep, bs):
    """A decode row, a verify window and a prefill chunk in one packed
    buffer; live rows only."""
    rng = np.random.RandomState(200 + 10 * bs + rep)
    S, MB, Hkv, D = 3, 4, 2, 64
    (jk, jv), (tk, tv) = _quant_pools(rng, 1 + S * MB, bs, Hkv, D)
    tables = _tables(S, MB, rep + 2)
    q_lens = np.asarray([1, 3, 8], np.int64)
    base = np.asarray([2 * bs + 1, bs - 1, 4], np.int64)
    R, W = 14, 8
    _, _, row_starts, _ = jpc.ragged_row_meta(q_lens, base, R, MB * bs)
    q = rng.randn(R, Hkv * rep, D).astype(np.float32)
    ctx = (base + 1).astype(np.int32)
    want = jpa.pallas_ragged_paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(ctx),
        jnp.asarray(q_lens.astype(np.int32)), jnp.asarray(row_starts),
        w_max=W, interpret=True)
    got = rpa.ragged_paged_attention(
        _t(q), tk, tv, _t(tables), _t(ctx), _t(q_lens.astype(np.int32)),
        _t(row_starts), W)
    for s, n in enumerate(map(int, q_lens)):
        s0 = int(row_starts[s])
        np.testing.assert_allclose(got[s0:s0 + n].numpy(),
                                   np.asarray(want[s0:s0 + n]), **TOL,
                                   err_msg=f"slot {s}")


def test_kernel_wrappers_refuse_mixed_pools():
    rng = np.random.RandomState(4)
    (_, _), (tk, _) = _quant_pools(rng, 5, 8, 2, 64)
    fv = torch.zeros(5, 8, 2, 64)
    q = torch.zeros(1, 2, 64)
    with pytest.raises(TypeError, match="mixed pools"):
        rpa.pool_operands(q, tk, fv)
    with pytest.raises(TypeError, match="mixed pools"):
        rpa.pool_operands(q, fv, tk)


# ------------------------------------------------ the slice as a whole


@pytest.fixture(scope="module")
def tiny_pair():
    paddle.seed(7)
    ref = JaxLlama(JaxLlamaConfig.tiny(**TINY))
    ref.eval()
    port = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    return ref, port


def _prompts(seed=0, vocab=128, lens=(7, 13, 21, 9)):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, (n,)) for n in lens]


def _match_rate(a_list, b_list):
    tot = hit = 0
    for a, b in zip(a_list, b_list):
        tot += len(a)
        hit += int(np.sum(np.asarray(a) == np.asarray(b)))
    return hit / max(tot, 1)


def test_engine_on_int8_pools_gives_reference_tokens(tiny_pair,
                                                     monkeypatch):
    ref, port = tiny_pair
    prompts = _prompts()
    jeng = JaxServingEngine(ref, JaxServingConfig(kv_cache_dtype="int8",
                                                  **ENGINE))
    want = jeng.serve(list(prompts), max_new_tokens=6)
    jst = jeng.stats()
    jeng.shutdown()
    eng = ServingEngine(port, ServingConfig(kv_cache_dtype="int8", **ENGINE),
                        device="cpu")
    assert isinstance(eng._pools[0][0], tpc.QuantKV)
    got = eng.serve(list(prompts), max_new_tokens=6)
    st = eng.stats()
    eng.shutdown()
    for i, (a, b) in enumerate(zip(want, got)):
        assert np.asarray(a).tolist() == np.asarray(b).tolist(), \
            f"request {i} diverged"
    assert st["kv_cache_dtype"] == jst["kv_cache_dtype"] == "int8"
    assert st["kv_pool_bytes"] == jst["kv_pool_bytes"]
    assert st["kv_bytes_per_step"] > 0
    fp = ServingEngine(port, ServingConfig(**ENGINE), device="cpu")
    fp_out = fp.serve(list(prompts), max_new_tokens=6)
    fst = fp.stats()
    fp.shutdown()
    assert fst["kv_cache_dtype"] == "float32"
    assert _match_rate(got, fp_out) >= MATCH_FLOOR
    # int8 data + scales against float32 pools: (D + 4) / 4D at D 16
    assert st["kv_pool_bytes"] / fst["kv_pool_bytes"] == pytest.approx(
        (16 + 4) / (4 * 16))


GENERATE = {"paged": dict(cache_impl="paged"),
            "ngram": dict(num_speculative_tokens=2)}


@pytest.mark.parametrize("case", list(GENERATE))
def test_generate_on_int8_pools_gives_reference_tokens(tiny_pair, case):
    ref, port = tiny_pair
    rng = np.random.RandomState(3)
    motif = rng.randint(0, 128, (2, 6))
    ids = np.tile(motif, (1, 3))[:, :16].astype(np.int64)
    kw = dict(GENERATE[case], max_new_tokens=8, kv_cache_dtype="int8")
    want, want_sc = ref.generate(paddle.to_tensor(ids), **kw)
    got, got_sc = port.generate(torch.from_numpy(ids), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc.numpy()),
                               atol=1e-4, rtol=0)


def test_generate_int8_with_explicit_dense_cache_raises(tiny_pair):
    for i, model in enumerate(tiny_pair):
        ids = np.ones((1, 4), np.int64)
        with pytest.raises(ValueError, match="paged cache"):
            model.generate(paddle.to_tensor(ids) if i == 0
                           else torch.from_numpy(ids), max_new_tokens=2,
                           cache_impl="dense", kv_cache_dtype="int8")


@pytest.mark.parametrize("family", ["qwen2", "qwen2_moe", "deepseek_moe"])
def test_every_family_builds_int8_caches(family):
    model = {"qwen2": lambda: Qwen2ForCausalLM(
                 Qwen2Config.tiny(), device="cpu"),
             "qwen2_moe": lambda: Qwen2MoeForCausalLM(
                 Qwen2MoeConfig.tiny(), device="cpu"),
             "deepseek_moe": lambda: DeepseekMoeForCausalLM(
                 DeepseekMoeConfig.tiny(), device="cpu")}[family]()
    pools = model.init_paged_caches(5, 8, kv_cache_dtype="int8")
    cfg = model.config
    assert len(pools) == cfg.num_hidden_layers
    for kp, vp in pools:
        for p in (kp, vp):
            assert isinstance(p, tpc.QuantKV)
            assert p.data.dtype == torch.int8
            assert p.scale.dtype == torch.float32
            assert tuple(p.shape) == (5, 8, cfg.num_key_value_heads,
                                      cfg.head_dim)
    fp = model.init_paged_caches(5, 8)
    assert fp[0][0].dtype == cfg.torch_dtype
