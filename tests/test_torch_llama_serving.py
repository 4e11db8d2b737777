"""The PyTorch port's Llama model and serving engine against the JAX
package on the CPU — the slice as a whole.

Weights cross from a seeded JAX ``LlamaForCausalLM`` to the port through
``params_from_jax``; one ragged forward must give the reference's
logits (atol 1e-4 in float32: the same model summed in another order),
and the two ``ServingEngine``s must serve the same prompts with
token-identical greedy streams.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import ServingConfig as JaxServingConfig
from paddle_tpu.inference import ServingEngine as JaxServingEngine
from paddle_tpu.jit import _LayerBinder
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops import paged_cache as jpc
from paddle_tpu_torch.convert import load_jax_params, params_from_jax
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import paged_cache as tpc

TINY = dict(vocab=128, hidden=256, layers=2, heads=4, kv_heads=2, ffn=256)
CORE = dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8)


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(7)
    m = JaxLlama(JaxLlamaConfig.tiny(**TINY))
    m.eval()
    return m


@pytest.fixture(scope="module")
def named(jax_model):
    return {k: np.asarray(v) for k, v in jax_model.state_dict().items()}


@pytest.fixture(scope="module")
def port_model(named):
    m = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    load_jax_params(m, named)
    return m


def _prompts():
    rng = np.random.RandomState(0)
    # ragged lengths; 21 > prefill_chunk spans three chunk ticks; four
    # prompts over two slots exercise admission after a retirement
    return [rng.randint(1, 128, size=n).tolist() for n in (5, 21, 3, 12)]


def test_params_from_jax_round_trips_names_shapes_dtypes(named,
                                                         port_model):
    sd = params_from_jax(named, device="cpu")
    assert set(sd) == set(named)
    own = dict(port_model.named_parameters())
    assert set(own) == set(named)
    for k, a in named.items():
        assert tuple(sd[k].shape) == a.shape == tuple(own[k].shape), k
        assert sd[k].dtype == torch.float32
        np.testing.assert_array_equal(sd[k].numpy(), a)
        np.testing.assert_array_equal(own[k].detach().numpy(), a)


def test_load_jax_params_rejects_mismatch(named):
    m = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    bad = dict(named)
    bad.pop("lm_head.weight")
    with pytest.raises(KeyError, match="lm_head"):
        load_jax_params(m, bad)


def test_ragged_forward_matches_reference_logits(jax_model, port_model):
    """One packed tick — a 6-row prefill chunk starting mid-prompt, a
    decode row and an idle slot — through both models over identical
    pools."""
    rng = np.random.RandomState(4)
    bs, mb, S = 8, 4, 3
    q_lens = np.asarray([6, 1, 0])
    base = np.asarray([8, 13, 0])
    R = int(q_lens.sum()) + 2                    # two pad rows
    row_slot, row_pos, row_starts, last = jpc.ragged_row_meta(
        q_lens, base, R, mb * bs)
    ids = rng.randint(0, 128, size=R).astype(np.int32)
    tables = (1 + np.arange(S * mb, dtype=np.int32)).reshape(S, mb)
    nb = 1 + S * mb
    shape = (nb, bs, 2, 64)
    pools = [(rng.randn(*shape).astype(np.float32),
              rng.randn(*shape).astype(np.float32)) for _ in range(2)]

    binder = _LayerBinder(jax_model)
    step = jax_model._build_model_step(binder, binder.buffer_arrays())
    meta = tuple(jnp.asarray(a) for a in (q_lens, row_starts, row_slot,
                                          row_pos)) \
        + (jnp.arange(1, dtype=jnp.int32), jnp.arange(8, dtype=jnp.int32))
    want, _ = step(binder.param_arrays(), jnp.asarray(ids)[None],
                   [(jnp.asarray(k), jnp.asarray(v)) for k, v in pools],
                   None, block_tables=jnp.asarray(tables),
                   cache_lens=jnp.asarray(base.astype(np.int32)),
                   ragged_meta=meta)
    want = np.asarray(want)[0]

    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tmeta = (t(q_lens.astype(np.int32)), t(row_starts), t(row_slot),
             t(row_pos), int(q_lens.max()))
    tpools = [(t(k), t(v)) for k, v in pools]
    with torch.no_grad():
        got, _ = port_model(t(ids), caches=tpools, block_tables=t(tables),
                            cache_lens=t(base.astype(np.int32)),
                            ragged_meta=tmeta)
        got_last, _ = port_model(
            t(ids), caches=[(t(k), t(v)) for k, v in pools],
            block_tables=t(tables), cache_lens=t(base.astype(np.int32)),
            ragged_meta=tmeta, last_rows=t(last))
    live = [r for s in range(S)
            for r in range(row_starts[s], row_starts[s] + q_lens[s])]
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=1e-4,
                               rtol=1e-4)
    # the LM head on last_rows only gives the same rows
    np.testing.assert_allclose(got_last.numpy()[:2], want[last[:2]],
                               atol=1e-4, rtol=1e-4)


def _serve_jax(model, prompts, max_new, **kw):
    eng = JaxServingEngine(model, JaxServingConfig(
        **CORE, **kw, enable_prefix_cache=False, enable_preemption=False,
        health=False, async_depth=0))
    out = eng.serve(prompts, max_new_tokens=max_new)
    eng.shutdown()
    return out


def _serve_port(model, prompts, max_new, **kw):
    eng = ServingEngine(model, ServingConfig(
        **CORE, **kw, enable_prefix_cache=False, enable_preemption=False),
        device="cpu")
    out = eng.serve(prompts, max_new_tokens=max_new)
    st = eng.stats()
    eng.shutdown()
    return out, st


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y,
                                      err_msg=f"request {i} diverged")


@pytest.mark.parametrize("fused", [True, False])
def test_engine_greedy_streams_match_reference(jax_model, port_model,
                                               fused):
    prompts = _prompts()
    want = _serve_jax(jax_model, prompts, 8)
    got, st = _serve_port(port_model, prompts, 8, fused_decode=fused)
    _assert_streams_equal(got, want)
    assert st["requests_completed"] == 4 and st["tokens_total"] == 32
    # 21 prompt tokens at chunk 8 -> three chunk ticks for that request
    assert st["prefill_chunks"] >= 3 + 3


def test_engine_eos_retires_like_reference(jax_model, port_model):
    prompts = _prompts()
    free_run = _serve_jax(jax_model, prompts, 8)
    eos = int(free_run[0][2])            # a token request 0 emits
    want = _serve_jax(jax_model, prompts, 8, eos_token_id=eos)
    got, st = _serve_port(port_model, prompts, 8, eos_token_id=eos)
    _assert_streams_equal(got, want)
    assert len(got[0]) <= 3 and got[0][-1] == eos
    assert st["tokens_total"] < 32


def test_sampling_top_k_one_is_greedy(port_model):
    prompts = _prompts()
    greedy, _ = _serve_port(port_model, prompts, 6)
    sampled, _ = _serve_port(port_model, prompts, 6,
                             decode_strategy="sampling", top_k=1,
                             temperature=0.7, seed=3)
    _assert_streams_equal(sampled, greedy)


def test_sampling_is_seeded(port_model):
    prompts = _prompts()[:2]
    a, _ = _serve_port(port_model, prompts, 6, decode_strategy="sampling",
                       temperature=1.5, seed=11)
    b, _ = _serve_port(port_model, prompts, 6, decode_strategy="sampling",
                       temperature=1.5, seed=11)
    _assert_streams_equal(a, b)


def test_submit_validation(port_model):
    eng = ServingEngine(port_model, ServingConfig(**CORE), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        eng.submit([])
    with pytest.raises(ValueError, match="max_model_len"):
        eng.submit([1] * 90, max_new_tokens=10)
    with pytest.raises(ValueError, match="sampling"):
        eng.submit([1, 2], 4, temperature=0.5)
    # priorities and queue-wait budgets are ported: the engine takes them,
    # and only what the reference refuses raises
    assert eng.submit([1, 2], 4, priority=1, max_queue_wait_ms=50.0) == 0
    with pytest.raises(ValueError, match="priority"):
        eng.submit([1, 2], 4, priority="high")
    # multi-LoRA is ported: an engine without it refuses an adapter as
    # the reference's does, naming lora_rank
    with pytest.raises(ValueError, match="lora_rank"):
        eng.submit([1, 2], 4, adapter_id=3)
    eng.shutdown()


@pytest.mark.parametrize("field,value", [
    ("enable_prefix_cache", True), ("num_speculative_tokens", 2),
    ("kv_cache_dtype", "int8"), ("enable_preemption", True),
    ("async_depth", 1), ("lora_rank", 8), ("tp_degree", 2),
    ("health", True), ("ragged_batch", False), ("role", "prefill")])
def test_later_slice_features_raise(field, value):
    if field == "num_speculative_tokens":
        # speculation is ported: the config takes it, and only what the
        # reference refuses raises
        cfg = ServingConfig(**{field: value})
        assert cfg.num_speculative_tokens == value and cfg.drafter == "ngram"
        with pytest.raises(ValueError, match="num_speculative_tokens"):
            ServingConfig(num_speculative_tokens=-1)
        return
    if field == "kv_cache_dtype":
        # int8 pools are ported: the config takes them, and only a pool
        # dtype the engine does not know raises
        assert ServingConfig(**{field: value}).kv_cache_dtype == value
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            ServingConfig(kv_cache_dtype="fp8")
        return
    if field in ("enable_prefix_cache", "enable_preemption"):
        # the prefix cache and preemption are ported and on by default, as
        # in the reference; only what the reference refuses raises
        assert getattr(ServingConfig(), field) is True
        assert getattr(ServingConfig(**{field: False}), field) is False
        with pytest.raises(ValueError, match="preempt_resume"):
            ServingConfig(**{field: value}, preempt_resume="maybe")
        return
    if field == "lora_rank":
        # multi-LoRA is ported: the config takes a rank, and only what the
        # reference refuses raises
        assert ServingConfig(**{field: value}).lora_rank == value
        with pytest.raises(ValueError, match="lora_rank"):
            ServingConfig(lora_rank=-1)
        return
    if field == "async_depth":
        # the async pipeline is ported: the config takes depth 1, and only
        # what the reference refuses raises
        assert ServingConfig(**{field: value}).async_depth == value
        with pytest.raises(ValueError, match="async_depth"):
            ServingConfig(async_depth=2)
        return
    if field == "health":
        # the health engine is ported and on by default, as in the
        # reference; its ten fields take the reference's defaults, and
        # the values the reference refuses raise its messages
        cfg = ServingConfig()
        assert cfg.health is True
        assert ServingConfig(health=False).health is False
        assert (cfg.health_slo_ttft_ms, cfg.health_slo_itl_ms,
                cfg.health_slo_target, cfg.health_burn_fast_s,
                cfg.health_burn_slow_s, cfg.health_burn_threshold,
                cfg.health_burn_min_requests, cfg.health_watchdog_mult,
                cfg.health_watchdog_floor_s, cfg.health_profile_ticks) == (
            2000.0, 500.0, 0.99, 5.0, 60.0, 2.0, 8, 50.0, 5.0, 0)
        for kw, msg in ((dict(health_slo_target=1.5), "health_slo_target"),
                        (dict(health_slo_target=0.0), "health_slo_target"),
                        (dict(health_burn_fast_s=60.0,
                              health_burn_slow_s=5.0), "health_burn_fast_s"),
                        (dict(health_watchdog_floor_s=0.0),
                         "health_watchdog_floor_s"),
                        (dict(health_watchdog_mult=0.5),
                         "health_watchdog_mult")):
            with pytest.raises(ValueError, match=msg):
                ServingConfig(**kw)
        return
    with pytest.raises(NotImplementedError, match="later slice"):
        ServingConfig(**{field: value})


def test_draft_model_raises(port_model):
    # the reference's rule: a draft model needs speculation with
    # drafter='model', and drafter='model' needs a draft model
    with pytest.raises(ValueError, match="draft_model requires"):
        ServingEngine(port_model, ServingConfig(**CORE), device="cpu",
                      draft_model=port_model)
    with pytest.raises(ValueError, match="draft_model requires"):
        ServingEngine(port_model, ServingConfig(
            **CORE, num_speculative_tokens=2), device="cpu",
            draft_model=port_model)
    with pytest.raises(ValueError, match="requires a draft_model"):
        ServingEngine(port_model, ServingConfig(
            **CORE, num_speculative_tokens=2, drafter="model"),
            device="cpu")


def test_allocator_drains_after_serving(port_model):
    eng = ServingEngine(port_model, ServingConfig(**CORE), device="cpu")
    eng.serve(_prompts(), max_new_tokens=4)
    st = eng.stats()
    assert st["reserved_blocks"] == 0 and st["active"] == 0
    assert st["free_blocks"] == 1 + 2 * 12 - 1
    assert eng.shutdown()
    assert tpc.blocks_for(96, 8) == 12
