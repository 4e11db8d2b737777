"""The PyTorch port's preemptive scheduler, host KV tier and request
lifecycle against the JAX package on the CPU.

The reference's ``tests/test_preemption.py`` cases, on its fixtures'
tiny models with weights crossed from a seeded reference model by
``load_jax_params``: a low-priority request preempted by two
high-priority arrivals resumes by swap (its blocks imported back from the
host tier) and by recompute (re-prefilled over the prefix cache), and
every stream equals the never-preempted run's and the reference engine's
under the same schedule, with the reference's preemption, spill, restore
and resume counters (Llama on float32 and int8 pools, GPT, n-gram
speculation, a draft model); a request preempted again mid-re-prefill
keeps its continuation; higher classes reach their first token first; a
storm in an overcommitted pool leaks nothing; queue-wait timeouts,
shedding and cancel behave as the reference's; an evicted published
block comes back from the host tier; the config and ``submit`` validate
as the reference's. Every move of pool bytes lands in place.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import QueueShedError as JaxQueueShedError
from paddle_tpu.inference import ServingConfig as JaxServingConfig
from paddle_tpu.inference import ServingEngine as JaxServingEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.inference import (QueueShedError, ServingConfig,
                                        ServingEngine)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)

LLAMA = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128)
GPT = dict(vocab=96, hidden=64, layers=2, heads=4)
CORE = dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8)
REF_ONLY = dict(health=False, min_prefill_bucket=8, async_depth=0)
COUNTERS = ("preemptions", "kv_blocks_spilled", "kv_blocks_restored",
            "preempt_swap_resumes", "preempt_recompute_resumes",
            "prefix_blocks_reused", "prefix_tokens_reused", "cow_copies",
            "cache_evictions", "cached_blocks", "free_blocks",
            "reserved_blocks", "host_tier_bytes", "tokens_total",
            "requests_completed", "requests_cancelled",
            "requests_timed_out", "requests_shed")


def _pair(jcfg_cls, jcls, tcfg_cls, tcls, shape, seed):
    paddle.seed(seed)
    ref = jcls(jcfg_cls.tiny(**shape))
    ref.eval()
    port = tcls(tcfg_cls.tiny(**shape), device="cpu")
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
def draft():
    """A one-layer draft model beside the Llama pair."""
    return _pair(JaxLlamaConfig, JaxLlama, LlamaConfig, LlamaForCausalLM,
                 dict(LLAMA, layers=1), 13)


def _engine(model, jax=False, draft=None, stream=None, **kw):
    if jax:
        return JaxServingEngine(model, JaxServingConfig(
            **dict(CORE, **kw), **REF_ONLY), draft_model=draft,
            stream_callback=stream)
    return ServingEngine(model, ServingConfig(**dict(CORE, **kw)),
                         device="cpu", draft_model=draft,
                         stream_callback=stream)


def _wl(rng, vocab=128):
    """One long low-priority request and two short high-priority ones:
    the reference's preemption workload."""
    return (rng.randint(1, vocab, (20,)), rng.randint(1, vocab, (9,)),
            rng.randint(1, vocab, (7,)))


def _reference(model, prompts, max_new=12, draft=None, **kw):
    """Never preempted: a slot for every request."""
    eng = _engine(model, draft=draft, **dict(kw,
                                             num_slots=len(prompts) + 1))
    out = eng.serve([p.copy() for p in prompts], max_new_tokens=max_new)
    st = eng.stats()
    assert eng.shutdown()
    return out, st


def _preempt_run(model, prompts, jax=False, max_new=12, warm_ticks=4,
                 draft=None, **kw):
    """The low-priority request decodes alone for a few ticks, then two
    high-priority arrivals preempt it. Returns (streams in prompt order,
    stats, the first pools' storage pointers before and after)."""
    eng = _engine(model, jax=jax, draft=draft, **kw)
    ptrs = None if jax else [p.data_ptr() for p in _tensors(eng._pools)]
    lo, h1, h2 = prompts
    rids = [eng.submit(lo.copy(), max_new, priority=0)]
    for _ in range(warm_ticks):
        eng.step()
    rids.append(eng.submit(h1.copy(), max_new, priority=2))
    rids.append(eng.submit(h2.copy(), max_new, priority=2))
    done = eng.run()
    st = eng.stats()
    assert eng.shutdown()
    after = None if jax else [p.data_ptr() for p in _tensors(eng._pools)]
    return [done[r] for r in rids], st, (ptrs, after)


def _tensors(pools):
    for pair in pools:
        for p in pair:
            yield from ((p.data, p.scale) if hasattr(p, "scale") else (p,))


def _assert_equal(a, b, tag):
    assert len(a) == len(b), tag
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{tag} request {i}")


def _assert_counters(got, want, keys=COUNTERS):
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


# ------------------------------------------- preempted == never preempted

RESUME_CASES = {
    # fixture, policy, config, workload seed (the reference's
    # test_preempt_resume_token_exact_* cases)
    "llama_swap": ("llama", "swap", {}, 3),
    "llama_recompute": ("llama", "recompute", {}, 3),
    "gpt_swap": ("gpt", "swap", {}, 5),
    "gpt_recompute": ("gpt", "recompute", {}, 5),
    "int8_swap": ("llama", "swap", dict(block_size=32,
                                        kv_cache_dtype="int8"), 9),
    "ngram_swap": ("llama", "swap", dict(num_speculative_tokens=2), 13),
    "ngram_recompute": ("llama", "recompute",
                        dict(num_speculative_tokens=2), 13),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_preempt_resume_matches_reference(request, case):
    fixture, policy, kw, seed = RESUME_CASES[case]
    ref, port = request.getfixturevalue(fixture)
    prompts = _wl(np.random.RandomState(seed), ref.config.vocab_size)
    never, _ = _reference(port, prompts, **kw)
    got, st, (p0, p1) = _preempt_run(port, prompts, preempt_resume=policy,
                                     **kw)
    want, st_want, _ = _preempt_run(ref, prompts, jax=True,
                                    preempt_resume=policy, **kw)
    _assert_equal(never, got, f"{case} preempted vs never preempted")
    _assert_equal(want, got, f"{case} port vs reference")
    _assert_counters(st, st_want)
    assert st["preemptions"] >= 1 and st["kv_blocks_spilled"] >= 1
    if policy == "swap":
        assert st["preempt_swap_resumes"] >= 1
        assert st["kv_blocks_restored"] >= 1
    else:
        assert st["preempt_recompute_resumes"] >= 1
    # the import and every other pool write land in place
    assert p0 == p1
    if kw.get("num_speculative_tokens"):
        keys = ("spec_tokens_proposed", "spec_tokens_accepted")
        assert {k: st[k] for k in keys} == {k: st_want[k] for k in keys}


def test_auto_resume_is_token_exact(llama):
    ref, port = llama
    prompts = _wl(np.random.RandomState(3))
    never, _ = _reference(port, prompts)
    got, st, _ = _preempt_run(port, prompts, preempt_resume="auto")
    _assert_equal(never, got, "auto preempted vs never preempted")
    assert st["preemptions"] >= 1
    assert st["preempt_swap_resumes"] + st["preempt_recompute_resumes"] \
        >= 1
    assert st["host_xfer_bytes_per_s_est"] > 0
    assert st["prefill_rows_per_s_est"] > 0


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_draft_model_resume_and_its_stale_pools(llama, draft, policy):
    """A swap (and a host-tier restore) moves the target's pools only, as
    in the reference: the draft model then drafts from stale K/V, and
    verification keeps the tokens exact. The port's speculation counters
    equal the reference's on both paths."""
    (ref, port), (jdraft, tdraft) = llama, draft
    kw = dict(num_speculative_tokens=2, drafter="model",
              preempt_resume=policy)
    prompts = _wl(np.random.RandomState(3))
    never, _ = _reference(port, prompts, draft=tdraft,
                          num_speculative_tokens=2, drafter="model")
    got, st, _ = _preempt_run(port, prompts, draft=tdraft, **kw)
    want, st_want, _ = _preempt_run(ref, prompts, jax=True, draft=jdraft,
                                    **kw)
    _assert_equal(never, got, f"draft {policy} vs never preempted")
    _assert_equal(want, got, f"draft {policy} port vs reference")
    keys = COUNTERS + ("spec_tokens_proposed", "spec_tokens_accepted")
    _assert_counters(st, st_want, keys)
    assert st["preemptions"] >= 1


def test_self_draft_swap_drafts_from_stale_pools(llama):
    """The target drafting for itself accepts every draft while its draft
    pools hold the target's K/V. After a swap resume they hold another
    request's bytes at the resumed blocks, so drafts are rejected, while
    the tokens stay the never-preempted ones: the reference's quirk."""
    _, port = llama
    prompts = _wl(np.random.RandomState(3))
    kw = dict(num_speculative_tokens=2, drafter="model")
    never, st_never = _reference(port, prompts, draft=port, **kw)
    rates = {}
    for policy in ("swap", "recompute"):
        got, st, _ = _preempt_run(port, prompts, draft=port,
                                  preempt_resume=policy, **kw)
        _assert_equal(never, got, f"self-draft {policy}")
        rates[policy] = st["spec_acceptance_rate"]
    assert st_never["spec_acceptance_rate"] == 1.0
    assert rates["recompute"] == 1.0
    assert rates["swap"] < 1.0


# ------------------------------------------------------ scheduling policy


def test_double_preemption_mid_reprefill_keeps_continuation(llama):
    ref, port = llama
    rng = np.random.RandomState(61)
    lo = rng.randint(1, 128, (24,))
    his = [rng.randint(1, 128, (9,)) for _ in range(4)]
    never, _ = _reference(port, [lo] + his, max_new=10)
    kw = dict(ragged_prefill_rows=4, preempt_resume="recompute",
              enable_prefix_cache=False)

    def run(jax):
        eng = _engine(ref if jax else port, jax=jax, **kw)
        rids = [eng.submit(lo.copy(), 10, priority=0)]
        for _ in range(9):
            eng.step()
        rids.append(eng.submit(his[0].copy(), 10, priority=2))
        rids.append(eng.submit(his[1].copy(), 10, priority=2))
        n_re = 0
        for _ in range(300):
            eng.step()
            s = [s for s in eng._slots if s is not None and s.rid == rids[0]]
            if s and s[0].pend_pos is not None \
                    and s[0].resume is not None and n_re < 2:
                n_re += 1
                rids.append(eng.submit(his[1 + n_re].copy(), 10,
                                       priority=2))
            if not eng._queue and eng.num_active == 0:
                break
        done = eng.run()
        st = eng.stats()
        assert eng.shutdown()
        return [done[r] for r in rids], st, n_re

    got, st, n_re = run(False)
    want, st_want, _ = run(True)
    assert n_re >= 1, "never caught the slot mid-re-prefill"
    assert st["preemptions"] >= 2
    assert got[0].size == 10            # not n_emitted + max_new
    np.testing.assert_array_equal(got[0], never[0])
    assert all(x.size == 10 for x in got)
    _assert_equal(want, got, "double preemption port vs reference")
    _assert_counters(st, st_want)


def test_priority_ordering_matches_reference(llama):
    """Under slot pressure every request completes once with its whole
    budget, higher classes reach their first token first, and the order
    of first tokens is the reference's."""
    ref, port = llama

    def run(jax):
        rng = np.random.RandomState(25)
        first, order = {}, []

        def cb(rid, tok):
            if rid not in first:
                first[rid] = len(order)
                order.append(rid)

        eng = _engine(ref if jax else port, jax=jax, stream=cb)
        rids, prios = [], {}
        for j in range(8):
            p = (0, 0, 1, 2)[j % 4]
            r = eng.submit(rng.randint(1, 128, (6 + 3 * (j % 3),)), 6,
                           priority=p)
            rids.append(r)
            prios[r] = p
        done = eng.run()
        st = eng.stats()
        assert eng.shutdown()
        return rids, prios, first, order, done, st

    rids, prios, first, order, done, st = run(False)
    _, _, _, jorder, jdone, st_want = run(True)
    assert sorted(done) == sorted(rids)
    assert all(done[r].size == 6 for r in rids)
    hi = [first[r] for r in rids if prios[r] == 2]
    lo = [first[r] for r in rids if prios[r] == 0]
    assert np.mean(hi) < np.mean(lo)
    assert order == jorder
    _assert_equal([jdone[r] for r in rids], [done[r] for r in rids],
                  "priority ordering port vs reference")
    _assert_counters(st, st_want)


def _storm(eng, rng):
    rids = []
    for j in range(9):
        rids.append(eng.submit(rng.randint(1, 128, (12 + 4 * (j % 2),)), 8,
                               priority=j % 3))
        eng.step()
        eng.step()
    return rids


def test_preemption_storm_leaks_nothing(llama):
    ref, port = llama
    kw = dict(num_slots=3, num_blocks=1 + 8, admission_watermark_blocks=1)
    eng, jeng = _engine(port, **kw), _engine(ref, jax=True, **kw)
    rids = _storm(eng, np.random.RandomState(29))
    jrids = _storm(jeng, np.random.RandomState(29))
    done, jdone = eng.run(), jeng.run()
    st, st_want = eng.stats(), jeng.stats()
    assert sorted(done) == sorted(rids)
    assert all(done[r].size == 8 for r in rids)
    assert st["preemptions"] >= 1
    _assert_equal([jdone[r] for r in jrids], [done[r] for r in rids],
                  "storm port vs reference")
    _assert_counters(st, st_want)
    assert eng.shutdown()           # the leak sweep
    assert not any(k[0] == "victim" for k in eng._host_tier._items)


def test_preemption_off_ignores_priorities(llama):
    """``enable_preemption=False``: FIFO with worst-case reservations,
    priorities ignored, nothing spilled; the reference's tokens."""
    ref, port = llama
    prompts = _wl(np.random.RandomState(37))

    def run(eng):
        lo, h1, h2 = prompts
        rids = [eng.submit(lo.copy(), 8, priority=0)]
        eng.step()
        rids.append(eng.submit(h1.copy(), 8, priority=5))
        rids.append(eng.submit(h2.copy(), 8, priority=5))
        done = eng.run()
        st = eng.stats()
        assert eng.shutdown()
        return [done[r] for r in rids], st

    got, st = run(_engine(port, enable_preemption=False))
    want, _ = run(_engine(ref, jax=True, enable_preemption=False))
    _assert_equal(want, got, "preemption off port vs reference")
    assert st["preemption_enabled"] is False and st["preemptions"] == 0
    assert st["kv_blocks_spilled"] == 0
    assert st["host_tier_capacity_bytes"] == 0


# --------------------------------------------- timeouts, shedding, cancel


def test_queue_timeout(llama):
    _, port = llama
    rng = np.random.RandomState(41)
    eng = _engine(port, num_slots=1)
    r0 = eng.submit(rng.randint(1, 128, (20,)), 20)
    eng.step()
    r1 = eng.submit(rng.randint(1, 128, (6,)), 4, max_queue_wait_ms=1.0)
    time.sleep(0.01)
    done = eng.run()
    st = eng.stats()
    assert st["requests_timed_out"] == 1
    assert done[r1].size == 0           # never started
    assert done[r0].size == 20
    assert r1 not in eng._submit_t
    assert eng.shutdown()


def test_shed_queue_depth(llama):
    ref, port = llama
    for jax in (False, True):
        rng = np.random.RandomState(45)
        eng = _engine(ref if jax else port, jax=jax, num_slots=1,
                      shed_queue_depth=1)
        eng.submit(rng.randint(1, 128, (8,)), 4)
        eng.step()                          # seats it
        eng.submit(rng.randint(1, 128, (8,)), 4)    # queued: depth 1
        err = JaxQueueShedError if jax else QueueShedError
        with pytest.raises(err, match="shed threshold"):
            eng.submit(rng.randint(1, 128, (8,)), 4)
        assert eng.stats()["requests_shed"] == 1
        assert eng.queue_depth() == 2
        assert len(eng.run()) == 2
        assert eng.shutdown()


def test_cancel_in_flight_and_queued(llama):
    ref, port = llama

    def run(jax):
        rng = np.random.RandomState(49)
        eng = _engine(ref if jax else port, jax=jax, num_slots=1)
        r0 = eng.submit(rng.randint(1, 128, (12,)), 20)
        r1 = eng.submit(rng.randint(1, 128, (10,)), 6)
        for _ in range(3):
            eng.step()
        free0 = eng.stats()["free_blocks"]
        assert eng.cancel(r0) is True
        st = eng.stats()
        assert st["free_blocks"] > free0    # freed mid-decode
        assert st["requests_cancelled"] == 1
        assert st["cached_blocks"] == 0     # freed unpublished
        r2 = eng.submit(rng.randint(1, 128, (5,)), 4)
        assert eng.cancel(r2) is True       # still queued
        done = eng.run()
        assert eng.cancel(r0) is False and eng.cancel(99) is False
        st = eng.stats()
        assert eng.shutdown()
        return done, (r0, r1, r2), st

    done, (r0, r1, r2), st = run(False)
    jdone, _, st_want = run(True)
    assert 1 <= done[r0].size < 20          # the partial stream
    assert r2 not in done                   # never started
    assert sorted(done) == sorted(jdone)
    for r in done:
        np.testing.assert_array_equal(done[r], jdone[r])
    _assert_counters(st, st_want)


def test_retain_results_off_holds_nothing(llama):
    _, port = llama
    seen = []
    eng = _engine(port, retain_results=False,
                  stream=lambda rid, t: seen.append(t))
    out = eng.submit(np.arange(1, 10), 5)
    assert eng.run() == {} and len(seen) == 5 and out == 0
    assert eng.shutdown()


# ------------------------------------------- evicted block, host restore


def test_evicted_published_block_restores_from_host_tier(llama):
    ref, port = llama

    def run(jax):
        rng = np.random.RandomState(57)
        eng = _engine(ref if jax else port, jax=jax, num_slots=1,
                      max_model_len=48, num_blocks=5)
        ptrs = None if jax else [p.data_ptr() for p in _tensors(eng._pools)]
        pa = rng.randint(1, 128, (16,))     # two full blocks
        out = eng.serve([pa.copy()], max_new_tokens=6)
        out += eng.serve([rng.randint(1, 128, (16,))], max_new_tokens=6)
        st1 = eng.stats()
        out += eng.serve([pa.copy()], max_new_tokens=6)
        st2 = eng.stats()
        assert eng.shutdown()
        if not jax:
            assert [p.data_ptr() for p in _tensors(eng._pools)] == ptrs
        return out, st1, st2

    got, st1, st2 = run(False)
    want, jst1, jst2 = run(True)
    assert st1["cache_evictions"] >= 1 and st1["kv_blocks_spilled"] >= 1
    assert st1["host_tier_bytes"] > 0
    assert st2["kv_blocks_restored"] >= 1
    np.testing.assert_array_equal(got[2], got[0])
    _assert_equal(want, got, "host-tier restore port vs reference")
    _assert_counters(st1, jst1)
    _assert_counters(st2, jst2)


# ------------------------------------------------------------- validation


def test_config_validation_matches_reference():
    for cfg in (ServingConfig, JaxServingConfig):
        with pytest.raises(ValueError, match="preempt_resume"):
            cfg(preempt_resume="maybe")
        with pytest.raises(ValueError, match="host_kv_tier_bytes"):
            cfg(host_kv_tier_bytes=-1)
        with pytest.raises(ValueError, match="shed_queue_depth"):
            cfg(shed_queue_depth=0)
    mine, want = ServingConfig(), JaxServingConfig()
    for f in ("enable_prefix_cache", "enable_preemption",
              "admission_watermark_blocks", "host_kv_tier_bytes",
              "preempt_resume", "shed_queue_depth", "max_queue_wait_ms",
              "retain_results"):
        assert getattr(mine, f) == getattr(want, f), f


def test_submit_validation_and_stats_keys(llama):
    ref, port = llama
    eng = _engine(port)
    with pytest.raises(ValueError, match="priority"):
        eng.submit(np.arange(1, 9), 4, priority="high")
    with pytest.raises(ValueError, match="max_queue_wait_ms"):
        eng.submit(np.arange(1, 9), 4, max_queue_wait_ms=0)
    # an engine without multi-LoRA refuses an adapter, naming lora_rank
    with pytest.raises(ValueError, match="lora_rank"):
        eng.submit(np.arange(1, 9), 4, adapter_id=1)
    jst = _engine(ref, jax=True).stats()
    st = eng.stats()
    for k in ("prefix_cache_enabled", "prefix_blocks_reused",
              "prefix_tokens_reused", "prefix_hit_rate", "cow_copies",
              "cache_evictions", "cached_blocks", "preemption_enabled",
              "preemptions", "kv_blocks_spilled", "kv_blocks_restored",
              "host_tier_bytes", "host_tier_capacity_bytes",
              "preempt_swap_resumes", "preempt_recompute_resumes",
              "prefill_rows_per_s_est", "host_xfer_bytes_per_s_est",
              "requests_shed", "requests_timed_out", "requests_cancelled"):
        assert k in st and st[k] == jst[k], k
    # lower-priority work counts a quarter against a higher arrival
    eng.submit(np.arange(1, 9), 4, priority=0)
    assert eng.queue_depth() == 1
    assert eng.queue_depth(priority=1) == 0.25
    assert eng.queue_depth(priority=0) == 1.0
    eng.run()
    assert eng.shutdown()
    assert torch.is_grad_enabled()
