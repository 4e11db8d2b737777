"""The PyTorch port's per-width serving engine (``ragged_batch=False``)
and bucketed prefill (``chunked_prefill=False``) against the JAX
package on the CPU.

With weights crossed from a seeded reference model by
``load_jax_params``, the port's engine serves the reference's traffic
under the same ``ServingConfig`` as the reference engine does: greedy
tokens equal and the scheduler's counters equal (``decode_steps``,
``prefill_chunks``, ``prefill_compiles`` and the
``serving_prefill_compiles`` labels, ``decode_compiles``, preemptions,
blocks), for Llama with synchronous, interleaved
(``max_prefill_chunks_per_step=1``) and bucketed prefill, n-gram and
draft-model speculation, int8 pools, GPT, a bucketed ragged engine and
one preemption resumed by recompute. The per-width engine gives the
ragged engine's greedy tokens (the reference's
``test_ragged_kill_switch_restores_zoo``, by tokens, not bitwise). The
plain K2v at the chunk window (T = 8 and 33) matches the reference's
kernel interpreted at ``t_q = T``; the fused paged layer is bitwise the
unfused one on the CPU, armed only inside the engine's scope, so
``generate()``'s paged steps never reach K3.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import monitor as jmonitor
from paddle_tpu.inference import ServingConfig as JaxServingConfig
from paddle_tpu.inference import ServingEngine as JaxServingEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch import monitor
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.ops import paged_cache as tpc
from paddle_tpu_torch.ops.kernels import decode_fused as df
from paddle_tpu_torch.ops.kernels import paged_attention as pda

LLAMA = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128)
GPT = dict(vocab=96, hidden=64, layers=2, heads=4)
CORE = dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8)
REF_ONLY = dict(health=False, async_depth=0)
COUNTERS = ("decode_steps", "prefill_chunks", "prefill_compiles",
            "decode_compiles", "preemptions", "preempt_recompute_resumes",
            "preempt_swap_resumes", "tokens_total", "requests_completed",
            "free_blocks", "reserved_blocks", "prefix_blocks_reused",
            "prefix_tokens_reused", "cow_copies", "ragged_batch",
            "chunked_prefill", "prefix_cache_enabled", "preemption_enabled")
SPEC = ("spec_tokens_proposed", "spec_tokens_accepted")


def _pair(jcfg_cls, jcls, tcfg_cls, tcls, shape, seed):
    paddle.seed(seed)
    ref = jcls(jcfg_cls.tiny(**shape))
    ref.eval()
    port = tcls(tcfg_cls.tiny(**shape), device="cpu")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    return ref, port.eval()


@pytest.fixture(scope="module")
def models():
    return {
        "llama": _pair(JaxLlamaConfig, JaxLlama, LlamaConfig,
                       LlamaForCausalLM, LLAMA, 7),
        "gpt": _pair(JaxGPTConfig, JaxGPT, GPTConfig, GPTForCausalLM, GPT,
                     3),
        "draft": _pair(JaxLlamaConfig, JaxLlama, LlamaConfig,
                       LlamaForCausalLM, dict(LLAMA, layers=1), 13),
    }


def _prompts(vocab, seed=0, lens=(5, 19, 11, 30, 7)):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=n) for n in lens]


def _labels(mon):
    """A registry's ``serving_prefill_compiles`` by bucket label."""
    fam = mon.counter("serving_prefill_compiles", labels=("bucket",))
    return {r["labels"]["bucket"]: r["value"] for r in fam.collect()}


def _serve(pair, jax, kw, prompts, max_new, draft=None):
    model = pair[0] if jax else pair[1]
    dm = None if draft is None else (draft[0] if jax else draft[1])
    if jax:
        eng = JaxServingEngine(model, JaxServingConfig(
            **dict(CORE, **kw), **REF_ONLY), draft_model=dm)
    else:
        eng = ServingEngine(model, ServingConfig(**dict(CORE, **kw)),
                            device="cpu", draft_model=dm)
    mon = jmonitor if jax else monitor
    before = _labels(mon)
    out = eng.serve([p.copy() for p in prompts], max_new_tokens=max_new)
    st = eng.stats()
    assert eng.shutdown()
    after = _labels(mon)
    grown = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    return out, st, grown


def _assert_equal(a, b, tag):
    assert len(a) == len(b), tag
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{tag} request {i}")


PW = dict(ragged_batch=False)
CASES = {
    # model, config, draft model, max_new
    "sync": ("llama", PW, None, 6),
    "interleaved": ("llama", dict(PW, max_prefill_chunks_per_step=1), None,
                    5),
    "bucketed": ("llama", dict(PW, chunked_prefill=False,
                               min_prefill_bucket=8), None, 6),
    "ragged_bucketed": ("llama", dict(chunked_prefill=False,
                                      min_prefill_bucket=8), None, 6),
    "ngram": ("llama", dict(PW, num_speculative_tokens=2), None, 8),
    "draft_model": ("llama", dict(PW, num_speculative_tokens=2,
                                  drafter="model"), "draft", 6),
    "int8": ("llama", dict(PW, block_size=16, kv_cache_dtype="int8"), None,
             6),
    "gpt": ("gpt", PW, None, 6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_per_width_matches_reference(models, case):
    """Tokens, the scheduler's counters and the prefill steps' bucket
    labels of the port's engine equal the reference engine's under the
    same config (the ragged bucketed engine's tick captures no graph on
    the CPU, so its decode_compiles is left out there)."""
    name, kw, draft, max_new = CASES[case]
    pair = models[name]
    prompts = _prompts(pair[0].config.vocab_size, seed=len(case))
    dm = None if draft is None else models[draft]
    got, st, lab = _serve(pair, False, kw, prompts, max_new, dm)
    want, st_want, lab_want = _serve(pair, True, kw, prompts, max_new, dm)
    _assert_equal(want, got, f"{case} port vs reference")
    keys = [k for k in COUNTERS
            if not (case == "ragged_bucketed" and k == "decode_compiles")]
    keys += list(SPEC) if kw.get("num_speculative_tokens") else []
    assert {k: st[k] for k in keys} == {k: st_want[k] for k in keys}
    assert lab == lab_want
    assert st["ragged_batch"] is kw.get("ragged_batch", True)
    if case == "interleaved":
        assert st["prefill_chunks"] >= sum(-(-len(p) // 8) for p in prompts)


def test_recompute_resume_matches_reference(models):
    """A low-priority request on the per-width engine, preempted by two
    high-priority arrivals, resumes by re-prefilling through the chunk
    steps: its stream equals the never-preempted run's and the
    reference's, with the reference's counters."""
    pair = models["llama"]
    rng = np.random.RandomState(3)
    prompts = (rng.randint(1, 128, (20,)), rng.randint(1, 128, (9,)),
               rng.randint(1, 128, (7,)))
    kw = dict(PW, preempt_resume="recompute")
    runs = []
    for jax in (False, True):
        model = pair[0] if jax else pair[1]
        eng = JaxServingEngine(model, JaxServingConfig(**CORE, **kw,
                                                       **REF_ONLY)) \
            if jax else ServingEngine(model, ServingConfig(**CORE, **kw),
                                      device="cpu")
        rids = [eng.submit(prompts[0].copy(), 12, priority=0)]
        for _ in range(4):
            eng.step()
        rids += [eng.submit(p.copy(), 12, priority=2) for p in prompts[1:]]
        done = eng.run()
        runs.append(([done[r] for r in rids], eng.stats()))
        assert eng.shutdown()
    never, _, _ = _serve(pair, False, dict(PW, num_slots=4), list(prompts),
                         12)
    (got, st), (want, st_want) = runs
    _assert_equal(never, got, "preempted vs never preempted")
    _assert_equal(want, got, "port vs reference")
    assert st["preempt_recompute_resumes"] >= 1
    assert {k: st[k] for k in COUNTERS} == {k: st_want[k] for k in COUNTERS}


@pytest.mark.parametrize("kw", [dict(), dict(chunked_prefill=False,
                                              min_prefill_bucket=8),
                                dict(num_speculative_tokens=2)],
                         ids=["chunked", "bucketed", "ngram"])
def test_per_width_gives_the_ragged_tokens(models, kw):
    """The per-width engine's greedy streams are the ragged engine's
    (the math is the same; bits may differ, as the reference's own
    bitwise test of the two paths does)."""
    pair = models["llama"]
    prompts = _prompts(128, seed=7, lens=(5, 12, 21))
    ragged, _, _ = _serve(pair, False, dict(kw), prompts, 5)
    per, st, _ = _serve(pair, False, dict(kw, ragged_batch=False), prompts,
                        5)
    _assert_equal(ragged, per, "ragged vs per-width")
    assert st["ragged_batch"] is False and st["decode_steps"] > 0


@pytest.mark.parametrize("T", [8, 33])
def test_plain_k2v_chunk_window_matches_interpreted_kernel(T):
    """The chunk step's K2v at T = prefill_chunk rows (one slot, a
    context crossing blocks; another whose window starts on a block
    boundary), against the reference's kernel interpreted at t_q = T."""
    rng = np.random.RandomState(T)
    bs, mb, hkv, rep, d = 8, 12, 2, 2, 64
    lens = [13, 16]
    tables = np.zeros((2, mb), np.int32)
    alloc = tpc.BlockAllocator(1 + 2 * mb)
    for s, n in enumerate(lens):
        k = tpc.blocks_for(n + T - 1, bs)
        tables[s, :k] = alloc.alloc(k)
    q = rng.randn(2, T, hkv * rep, d).astype(np.float32)
    kp = rng.randn(1 + 2 * mb, bs, hkv, d).astype(np.float32)
    vp = rng.randn(1 + 2 * mb, bs, hkv, d).astype(np.float32)
    ln = np.asarray(lens, np.int32)
    want = jpa.pallas_paged_verify_attention(
        *map(jnp.asarray, (q, kp, vp, tables, ln)), interpret=True)
    got = pda.paged_verify_attention(*map(torch.from_numpy,
                                          (q, kp, vp, tables, ln)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["llama", "gpt"])
def test_fused_paged_layer_is_bitwise_unfused(models, name):
    """Inside ``paged_fused_scope`` the paged path (a chunk of T rows and
    a one-token step) runs the fused layer (plain K3 on the CPU) around
    K2v / K2d, bitwise the unfused layer; outside it, and with
    ``fused=False``, the fused layer never runs."""
    port = models[name][1]
    layers = port.base.layers if name == "llama" else port.gpt.h
    calls = []
    orig = type(layers[0]).forward_decode_fused

    def spy(self, *a, **k):
        calls.append(1)
        return orig(self, *a, **k)

    ids = torch.from_numpy(np.random.RandomState(1).randint(1, 90, (2, 9)))
    tables = torch.arange(1, 9, dtype=torch.int32).view(2, 4)
    lens = torch.tensor([0, 5], dtype=torch.int32)
    outs = {}
    for tag, armed, fused in (("off", False, True), ("on", True, True),
                              ("flag", True, False)):
        pools = port.init_paged_caches(9, 8)
        n0 = len(calls)
        scope = df.paged_fused_scope() if armed \
            else contextlib.nullcontext()
        with torch.no_grad(), scope:
            setattr(type(layers[0]), "forward_decode_fused", spy)
            try:
                a, pools = port(ids, caches=pools, block_tables=tables,
                                cache_lens=lens, fused=fused)
                b, pools = port(ids[:, :1], caches=pools,
                                block_tables=tables, cache_lens=lens + 9,
                                fused=fused)
            finally:
                setattr(type(layers[0]), "forward_decode_fused", orig)
        outs[tag] = (a, b, [t.clone() for kv in pools for t in kv])
        assert (len(calls) > n0) == (tag == "on")
    for tag in ("on", "flag"):
        for x, y in zip(outs["off"][:2] + tuple(outs["off"][2]),
                        outs[tag][:2] + tuple(outs[tag][2])):
            assert torch.equal(x, y), tag


def test_generate_paged_steps_stay_unfused(models):
    """The reference's ``generate()`` runs outside the engine's fused
    scope: the port's paged and speculative steps never reach K3, while
    the per-width engine's steps do."""
    port = models["llama"][1]
    calls = []
    orig = df.norm_matmul

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    ids = torch.from_numpy(_prompts(128, lens=(9,))[0][None])
    import paddle_tpu_torch.models.llama as tl
    tl._df.norm_matmul = spy
    try:
        port.generate(ids, max_new_tokens=4, cache_impl="paged")
        port.generate(ids, max_new_tokens=4, cache_impl="paged",
                      num_speculative_tokens=2)
        assert not calls
        eng = ServingEngine(port, ServingConfig(**CORE, **PW), device="cpu")
        eng.serve([ids[0].numpy()], 3)
        eng.shutdown()
        assert calls
    finally:
        tl._df.norm_matmul = orig


def test_config_fields_and_refusals(models):
    """The reference's defaults, and what it refuses with the per-width
    engine: a tree, the async pipeline and multi-LoRA; the chunk step's
    window bound; stats() reports the real paths."""
    cfg = ServingConfig()
    assert (cfg.min_prefill_bucket, cfg.max_prefill_chunks_per_step,
            cfg.ragged_batch, cfg.chunked_prefill) == (16, 0, True, True)
    assert (JaxServingConfig().min_prefill_bucket,
            JaxServingConfig().max_prefill_chunks_per_step) == (16, 0)
    port = models["llama"][1]
    with pytest.raises(NotImplementedError, match="spec_tree"):
        ServingEngine(port, ServingConfig(**CORE, **PW,
                                          num_speculative_tokens=2,
                                          spec_tree=(0, 0)), device="cpu")
    with pytest.raises(NotImplementedError, match="async"):
        ServingConfig(**CORE, **PW, async_depth=1)
    for kw, msg in ((PW, "ragged"), (dict(chunked_prefill=False),
                                     "chunked")):
        with pytest.raises(NotImplementedError, match=msg):
            ServingEngine(port, ServingConfig(**CORE, **kw, lora_rank=8),
                          device="cpu")
    with pytest.raises(ValueError, match="window"):
        ServingEngine(port, ServingConfig(
            **dict(CORE, max_model_len=2048, prefill_chunk=2048), **PW),
            device="cpu")
    eng = ServingEngine(port, ServingConfig(**CORE, chunked_prefill=False),
                        device="cpu")
    st = eng.stats()
    assert (st["ragged_batch"], st["chunked_prefill"],
            st["prefix_cache_enabled"], st["preemption_enabled"]) == (
        True, False, False, False)
    eng.shutdown()
