"""The PyTorch port's async tick pipeline (``async_depth=1``) against its
own synchronous engine and against the JAX package's async engine, on
the CPU (where every tick runs eagerly: the CUDA graphs of the pure
ticks are held to the eager ticks by ``tests/test_torch_graphs_gpu.py``
on the card).

The reference's ``tests/test_async_tick.py`` cases that the port has
features for, on its fixtures' tiny models, with weights crossed from a
seeded reference model by ``params_from_jax``: greedy streams with the
pipeline on equal those with it off and the reference's with it on
(Llama on float and int8 pools, n-gram speculation at gamma 2, the tree
(0, 1), GPT on float32 pools, dropless DeepSeek-MoE), staggered
admission flushes and stays token-exact, an EOS that lands while the
next tick is in flight drops its overrun token, the pipelined dispatch
runs (a count, and the host-gap digest), growth for the pipelined tick
cannot run dry in a pool sized to the reservations and flushes in an
overcommitted one that does, a preemption storm and a cancel
mid-pipeline stay token-exact, a sampling engine draws the same tokens either way,
``async_depth`` is validated as the reference validates it, the stats
keys are present on a synchronous engine, and the port's copy of the
P-squared digest and ``stats()["spec_accept_len"]`` equal the
reference's. Two pieces the graphs need are pinned too: the capturable
sampler draws ``torch.multinomial``'s tokens, and the MoE telemetry's
row mask counts the kept rows only.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingConfig as JaxServingConfig
from paddle_tpu.inference import ServingEngine as JaxServingEngine
from paddle_tpu.models.deepseek_moe import \
    DeepseekMoeConfig as JaxDeepseekConfig
from paddle_tpu.models.deepseek_moe import \
    DeepseekMoeForCausalLM as JaxDeepseek
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.monitor.digest import LatencyDigest as JaxDigest
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.models import (DeepseekMoeConfig,
                                     DeepseekMoeForCausalLM, GPTConfig,
                                     GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.monitor import LatencyDigest

# the reference fixtures' shapes (tests/test_async_tick.py) and engine
LLAMA = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128)
GPT = dict(vocab=96, hidden=64, layers=2, heads=4)
MOE = dict(vocab=128, hidden=64, layers=3, heads=4, kv_heads=4, moe_ffn=32,
           dense_ffn=48, experts=8, shared=2, topk=2)
CORE = dict(num_slots=2, block_size=8, max_model_len=64, prefill_chunk=8)
# the reference's features the port has no slice for yet, off; the
# prefix cache and preemption off in both engines of a pair
REF_OFF = dict(enable_prefix_cache=False, enable_preemption=False,
               health=False, min_prefill_bucket=8)
PORT_OFF = dict(enable_prefix_cache=False, enable_preemption=False)


def _pair(jcfg_cls, jcls, tcfg_cls, tcls, shape, seed, **cfg_kw):
    paddle.seed(seed)
    jcfg = jcfg_cls.tiny(**shape)
    tcfg = tcfg_cls.tiny(**shape)
    for k, v in cfg_kw.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    ref = jcls(jcfg)
    ref.eval()
    port = tcls(tcfg, device="cpu")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    return ref, port.eval()


@pytest.fixture(scope="module")
def llama():
    return _pair(JaxLlamaConfig, JaxLlama, LlamaConfig, LlamaForCausalLM,
                 LLAMA, 7)


@pytest.fixture(scope="module")
def gpt():
    return _pair(JaxGPTConfig, JaxGPT, GPTConfig, GPTForCausalLM, GPT, 11)


@pytest.fixture(scope="module")
def moe():
    return _pair(JaxDeepseekConfig, JaxDeepseek, DeepseekMoeConfig,
                 DeepseekMoeForCausalLM, MOE, 7, dropless=True)


def _prompts(vocab=128, lens=(9, 5, 12), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, (n,)).astype(np.int64) for n in lens]


def _lora_weights():
    """The reference's ``test_parity_lora`` adapter: q_proj and o_proj
    (square on the kv_heads=2 tiny), N(0, 0.3) at rank 4."""
    rng = np.random.RandomState(101)
    return {n: (rng.normal(0, 0.3, (64, 4)).astype(np.float32),
                rng.normal(0, 0.3, (4, 64)).astype(np.float32))
            for n in ("q_proj", "o_proj")}


def _serve_on(eng, prompts, max_new):
    """Serve ``prompts``; a LoRA engine loads adapter 1 and serves them
    under adapters (1, None, 1), as the reference's ``test_parity_lora``."""
    aids = [None] * len(prompts)
    if eng.stats()["lora_enabled"]:
        eng.load_adapter(1, _lora_weights())
        aids = [(1, None, 1)[k % 3] for k in range(len(prompts))]
    rids = [eng.submit(p.copy(), max_new, adapter_id=a)
            for p, a in zip(prompts, aids)]
    done = eng.run()
    st = eng.stats()
    assert eng.shutdown()
    return [done[r] for r in rids], st


def _serve_ref(model, prompts, depth, max_new=8, **kw):
    return _serve_on(JaxServingEngine(model, JaxServingConfig(
        **CORE, **REF_OFF, async_depth=depth, **kw)), prompts, max_new)


def _serve(model, prompts, depth, max_new=8, **kw):
    return _serve_on(ServingEngine(model, ServingConfig(
        **dict(CORE, **PORT_OFF, **kw), async_depth=depth), device="cpu"),
        prompts, max_new)


def _assert_equal(a, b, tag):
    assert len(a) == len(b), tag
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{tag} request {i}")


CASES = {"llama": ("llama", {}),
         "llama_int8": ("llama", dict(kv_cache_dtype="int8")),
         "llama_ngram": ("llama", dict(num_speculative_tokens=2)),
         "llama_tree": ("llama", dict(num_speculative_tokens=2,
                                      spec_tree=(0, 1))),
         "gpt": ("gpt", {}),
         "deepseek_moe": ("moe", {}),
         # the per-slot adapter row rides the carry unchanged
         "llama_lora": ("llama", dict(lora_rank=4, max_adapters=2))}


@pytest.mark.parametrize("case", list(CASES))
def test_async_streams_equal_sync_and_reference(request, case):
    fixture, kw = CASES[case]
    ref, port = request.getfixturevalue(fixture)
    prompts = _prompts(vocab=ref.config.vocab_size)
    on, st_on = _serve(port, prompts, 1, **kw)
    off, st_off = _serve(port, prompts, 0, **kw)
    want, _ = _serve_ref(ref, prompts, 1, **kw)
    _assert_equal(off, on, f"{case} async on/off")
    _assert_equal(want, on, f"{case} port vs reference")
    assert st_on["async_depth"] == 1 and st_off["async_depth"] == 0
    assert st_on["tokens_total"] == st_off["tokens_total"]
    # the CPU runs every tick eagerly: no graph
    assert st_on["executables_compiled"] == st_off["executables_compiled"] \
        == 0
    if not kw.get("num_speculative_tokens"):
        # a decode engine pipelines its pure ticks; the reference's
        # speculating engine dispatches then blocks, and so does the port
        assert st_on["pipelined_ticks"] > 0
        assert st_on["host_gap_ms"]["count"] > 0
    else:
        assert st_on["pipelined_ticks"] == 0


def test_flush_on_staggered_admission(llama):
    """A request arriving mid-pipeline flushes it before its admission
    tick, so every tick sees the composition the synchronous engine's
    does: token-exact against both engines."""
    ref, port = llama
    p0, p1 = _prompts(lens=(9, 7))

    def run(make, depth):
        eng = make(depth)
        rids = [eng.submit(p0.copy(), 10)]
        for _ in range(4):
            eng.step()
        rids.append(eng.submit(p1.copy(), 8))
        done = eng.run()
        st = eng.stats()
        eng.shutdown()
        return [done[r] for r in rids], st

    on, st_on = run(lambda d: ServingEngine(port, ServingConfig(
        **CORE, **PORT_OFF, async_depth=d), device="cpu"), 1)
    off, _ = run(lambda d: ServingEngine(port, ServingConfig(
        **CORE, **PORT_OFF, async_depth=d), device="cpu"), 0)
    want, _ = run(lambda d: JaxServingEngine(ref, JaxServingConfig(
        **CORE, **REF_OFF, async_depth=d)), 1)
    _assert_equal(off, on, "staggered admission async on/off")
    _assert_equal(want, on, "staggered admission port vs reference")
    assert st_on["pipeline_flushes"] >= 1 and st_on["pipelined_ticks"] > 0


def test_eos_overrun_token_dropped_exactly(llama):
    """An EOS that lands while the next tick is in flight: that tick's
    token for the retired slot is dropped at commit, so the streams and
    the token count equal the synchronous engine's."""
    _, port = llama
    base, _ = _serve(port, _prompts(lens=(9,)), 0, max_new=10)
    eos = int(np.asarray(base[0])[4])
    on, st_on = _serve(port, _prompts(lens=(9,)), 1, max_new=10,
                       eos_token_id=eos)
    off, st_off = _serve(port, _prompts(lens=(9,)), 0, max_new=10,
                         eos_token_id=eos)
    _assert_equal(off, on, "eos overrun async on/off")
    assert len(np.asarray(on[0])) < 10
    assert st_on["tokens_total"] == st_off["tokens_total"]
    assert st_on["pipelined_ticks"] > 0


def test_pipelined_growth_cannot_run_dry(llama):
    """Admission reserves each request's worst-case blocks, so growing
    blocks for the pipelined tick's write never finds the pool dry: a
    pool of exactly the two requests' reservations serves them with
    pipelined ticks crossing block boundaries, as the sync engine does,
    and drains."""
    _, port = llama
    prompts = _prompts(lens=(7, 5))
    worst = sum(-(-(p.size + 20) // CORE["block_size"]) for p in prompts)
    outs = []
    for depth in (0, 1):
        eng = ServingEngine(port, ServingConfig(
            **dict(CORE, num_blocks=1 + worst), async_depth=depth),
            device="cpu")
        outs.append(eng.serve([p.copy() for p in prompts], 20))
        st = eng.stats()
        assert st["reserved_blocks"] == 0 and st["free_blocks"] == worst
        assert eng.shutdown()
    _assert_equal(outs[0], outs[1], "reserved pool async on/off")
    assert st["pipelined_ticks"] >= 2 * CORE["block_size"] // 2


def test_pipelined_growth_in_a_dry_pool_flushes(llama):
    """An overcommitted pool (watermark admission) can run dry under the
    pipelined tick's growth: the growth then takes no victim, the pipeline
    flushes, and the synchronous path grows with preemption, so the
    streams equal the synchronous engine's and the pool drains clean."""
    _, port = llama
    prompts = _prompts(lens=(7, 5))
    grown = []
    outs, stats = [], []
    for depth in (0, 1):
        eng = ServingEngine(port, ServingConfig(
            **dict(CORE, num_blocks=1 + 6), async_depth=depth),
            device="cpu")
        if depth:
            grow = eng._pipe_grow
            eng._pipe_grow = lambda pipe: grown.append(grow(pipe)) \
                or grown[-1]
        outs.append(eng.serve([p.copy() for p in prompts], 40))
        stats.append(eng.stats())
        assert eng.shutdown()
    _assert_equal(outs[0], outs[1], "dry pool async on/off")
    assert False in grown and True in grown
    for st in stats:
        assert st["preemptions"] >= 1 and st["reserved_blocks"] == 0
    assert stats[0]["preemptions"] == stats[1]["preemptions"]
    assert stats[1]["pipelined_ticks"] > 0


def test_prefix_hits_async_on_equals_off(llama):
    """Prompts served twice hit the prefix cache the second time (one row
    of a full hit recomputed after its block is copied): async on equals
    off and the reference's async engine, with its cache counters."""
    ref, port = llama
    rng = np.random.RandomState(11)
    sysp = rng.randint(1, 128, (16,))
    prompts = [sysp, np.concatenate([sysp, rng.randint(1, 128, (5,))])]

    def run(eng):
        out = eng.serve([p.copy() for p in prompts], 8)
        out += eng.serve([p.copy() for p in prompts], 8)
        st = eng.stats()
        eng.shutdown()
        return out, st

    on, st_on = run(ServingEngine(port, ServingConfig(**CORE, async_depth=1),
                                  device="cpu"))
    off, _ = run(ServingEngine(port, ServingConfig(**CORE, async_depth=0),
                               device="cpu"))
    want, st_want = run(JaxServingEngine(ref, JaxServingConfig(
        **CORE, health=False, min_prefill_bucket=8, async_depth=1)))
    _assert_equal(off, on, "prefix hits async on/off")
    _assert_equal(want, on, "prefix hits port vs reference")
    keys = ("prefix_tokens_reused", "prefix_blocks_reused", "cow_copies")
    assert {k: st_on[k] for k in keys} == {k: st_want[k] for k in keys}
    assert st_on["cow_copies"] >= 1 and st_on["pipelined_ticks"] > 0


def _storm(make):
    """The reference's preemption workload on a two-slot engine: one long
    low-priority request, then two high-priority arrivals."""
    eng = make()
    rng = np.random.RandomState(3)
    lo = rng.randint(1, 128, (20,))
    h1, h2 = rng.randint(1, 128, (9,)), rng.randint(1, 128, (7,))
    rids = [eng.submit(lo.copy(), 12, priority=0)]
    for _ in range(4):
        eng.step()
    rids.append(eng.submit(h1.copy(), 12, priority=2))
    rids.append(eng.submit(h2.copy(), 12, priority=2))
    done = eng.run()
    st = eng.stats()
    eng.shutdown()
    return [done[r] for r in rids], st


def test_flush_on_preemption_storm(llama):
    """A preemption flushes the pipeline first: async on equals off and
    the reference's async engine, with its preemption counters."""
    ref, port = llama
    cfg = dict(CORE, max_model_len=96)
    on, st_on = _storm(lambda: ServingEngine(port, ServingConfig(
        **cfg, async_depth=1), device="cpu"))
    off, st_off = _storm(lambda: ServingEngine(port, ServingConfig(
        **cfg, async_depth=0), device="cpu"))
    want, st_want = _storm(lambda: JaxServingEngine(ref, JaxServingConfig(
        **cfg, health=False, min_prefill_bucket=8, async_depth=1)))
    _assert_equal(off, on, "preemption storm async on/off")
    _assert_equal(want, on, "preemption storm port vs reference")
    keys = ("preemptions", "kv_blocks_spilled", "kv_blocks_restored",
            "preempt_swap_resumes", "preempt_recompute_resumes")
    assert {k: st_on[k] for k in keys} == {k: st_off[k] for k in keys}
    assert st_on["preemptions"] >= 1 and st_on["pipeline_flushes"] >= 1
    assert st_on["pipelined_ticks"] > 0


def test_cancel_mid_pipeline(llama):
    """``cancel()`` commits the in-flight tick before it retires the slot:
    the cancelled request's partial stream and the survivor's stream
    equal the synchronous engine's and the reference's."""
    ref, port = llama

    def run(make):
        eng = make()
        p0, p1 = _prompts(lens=(9, 7))
        r0 = eng.submit(p0.copy(), 12)
        r1 = eng.submit(p1.copy(), 12)
        for _ in range(4):
            eng.step()
        assert eng.cancel(r0)
        done = eng.run()
        st = eng.stats()
        eng.shutdown()
        assert done[r0].size < 12
        return [done[r0], done[r1]], st

    on, st_on = run(lambda: ServingEngine(port, ServingConfig(
        **CORE, async_depth=1), device="cpu"))
    off, _ = run(lambda: ServingEngine(port, ServingConfig(
        **CORE, async_depth=0), device="cpu"))
    want, _ = run(lambda: JaxServingEngine(ref, JaxServingConfig(
        **CORE, health=False, min_prefill_bucket=8, async_depth=1)))
    _assert_equal(off, on, "cancel partial + survivor async on/off")
    _assert_equal(want, on, "cancel port vs reference")
    assert st_on["pipeline_flushes"] >= 1
    assert st_on["requests_cancelled"] == 1


@pytest.mark.parametrize("kw", [{}, dict(num_speculative_tokens=2)])
def test_sampling_async_on_equals_off(llama, kw):
    _, port = llama
    samp = dict(decode_strategy="sampling", temperature=0.9, top_k=20,
                seed=5, **kw)
    on, st = _serve(port, _prompts(), 1, **samp)
    off, _ = _serve(port, _prompts(), 0, **samp)
    _assert_equal(off, on, "sampling async on/off")
    if not kw:
        assert st["pipelined_ticks"] > 0


def test_async_depth_validation(llama):
    for bad in (2, -1, True, 1.0):
        with pytest.raises(ValueError, match="async_depth"):
            ServingConfig(**CORE, async_depth=bad)
        with pytest.raises(ValueError, match="async_depth"):
            JaxServingConfig(**CORE, async_depth=bad)
    with pytest.raises(NotImplementedError, match="async"):
        ServingConfig(**CORE, async_depth=1, ragged_batch=False)
    for ok in (None, 0, 1):
        assert ServingConfig(**CORE, async_depth=ok).async_depth == ok


def test_stats_keys_always_present(llama):
    _, port = llama
    eng = ServingEngine(port, ServingConfig(**CORE), device="cpu")
    st = eng.stats()
    assert st["async_depth"] == 0 and st["pipeline_flushes"] == 0
    assert st["executables_compiled"] == 0 and st["pipelined_ticks"] == 0
    assert st["host_gap_ms"]["count"] == 0
    assert set(st["host_gap_ms"]) == set(JaxDigest().summary())
    assert st["spec_accept_len"] == JaxDigest().summary()
    eng.serve(_prompts(), 4)
    st = eng.stats()
    # a sync engine's gap includes its blocking read-back
    assert st["host_gap_ms"]["count"] == st["ticks"] - 1 > 0
    assert st["pure_ticks"] > 0 and st["pipeline_flushes"] == 0
    eng.shutdown()


def test_latency_digest_matches_reference():
    rng = np.random.RandomState(3)
    xs = np.concatenate([rng.exponential(2.0, 500), rng.normal(5, 1, 300),
                         [0.0, 1e3]])
    mine, want = LatencyDigest(), JaxDigest()
    assert mine.summary() == want.summary()
    for n, x in enumerate(xs):
        mine.observe(x)
        want.observe(x)
        if n in (0, 3, 4, 50):
            assert mine.summary() == want.summary()
    assert mine.summary() == want.summary()
    assert mine.quantiles() == want.quantiles() and mine.count == want.count


def test_spec_accept_len_matches_reference(llama):
    ref, port = llama
    kw = dict(num_speculative_tokens=2)
    _, st = _serve(port, _prompts(), 0, **kw)
    _, want = _serve_ref(ref, _prompts(), 0, **kw)
    assert st["spec_accept_len"]["count"] > 0
    assert st["spec_accept_len"] == want["spec_accept_len"]


def test_categorical_draws_multinomials_tokens():
    """The tick's sampler (no read-back, so a graph can hold it) draws
    what ``torch.multinomial`` draws from the same generator state, and
    leaves the generator where multinomial does."""
    from paddle_tpu_torch.generation import categorical
    probs = torch.softmax(torch.randn(6, 257) * 3, -1)
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    for _ in range(3):
        want = torch.multinomial(probs, 1, generator=g1)[:, 0]
        np.testing.assert_array_equal(categorical(probs, g2), want)
    assert torch.equal(g1.get_state(), g2.get_state())


def test_serving_rows_mask_counts_kept_rows_only():
    """A pipelined tick's parked rows route through the MoE dispatch but
    are no traffic: under ``serving_rows_mask`` the tapped counts are
    those of the kept rows, and the output is unchanged."""
    from paddle_tpu_torch.distributed import moe
    rng = np.random.RandomState(2)
    s, d, f, e, k = 6, 16, 8, 4, 2
    x = torch.from_numpy(rng.randn(s, d).astype(np.float32))
    logits = torch.from_numpy(rng.randn(s, e).astype(np.float32))
    gu = torch.from_numpy(rng.randn(e, d, 2 * f).astype(np.float32))
    dn = torch.from_numpy(rng.randn(e, f, d).astype(np.float32))
    keep = torch.tensor([True, False, True, True, False, True])
    full, masked = [], []
    with moe.serving_stats_tap(full):
        y0, _ = moe.moe_dispatch_combine_dropless(x, logits, e, k, gu, dn)
    with moe.serving_stats_tap(masked), moe.serving_rows_mask(keep):
        y1, _ = moe.moe_dispatch_combine_dropless(x, logits, e, k, gu, dn)
    torch.testing.assert_close(y0, y1, rtol=0, atol=0)
    top = torch.topk(torch.softmax(logits, -1), k, -1).indices
    want = torch.bincount(top[keep].reshape(-1), minlength=e)
    np.testing.assert_array_equal(masked[0], want)
    np.testing.assert_array_equal(full[0], torch.bincount(
        top.reshape(-1), minlength=e))
