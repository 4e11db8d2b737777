"""The PyTorch port's batched multi-LoRA serving against the JAX package on
the CPU.

``AdapterPool`` runs the reference pool's lifecycle beside the
reference's (rows, refcounts, swaps, refusals, messages), its int8 rows
equal the reference's bit for bit, and the rank padding the device stacks
carry (to a multiple of 8, K4's narrowest width) shows nowhere else:
shapes and messages at the adapter's rank, ``host_tier_bytes``, zero
padded columns. ``tag_modules`` stacks the reference's modules in the
reference's order for every family under both target sets. The per-row
delta through K4's wrappers (their plain versions here) equals the
reference's stacked-gather einsum, and its interpreted Pallas K4 within
1e-5 (the reference's own bitwise test of the two fails). The engine,
with weights crossed from a seeded reference model by
``load_jax_params`` and adapters drawn as the reference's tests draw
them (N(0, 0.3) on its fixtures' tiny models), gives the reference
engine's streams and ``lora_*`` counters for Llama (``attn`` and ``all``,
the down projection's module path), Qwen2 (biased q/k/v), GPT
(``qkv_proj`` / ``out_proj``), int8 KV pools, n-gram speculation,
``lora_quant`` and a preemption resumed under its adapter, and the fused
decode tick equals the module path. Port-only: a mixed batch equals solo
runs, churn through two resident rows reseats an evicted adapter
exactly, ``evict`` is refused mid-request, the validation, and the stats
keys of an engine without LoRA. The prefix cache keys blocks by adapter
and by its weights' generation, where the reference reuses one adapter's
K/V under another: the test pins both sides.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

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
from paddle_tpu.models.qwen2 import Qwen2Config as JaxQwen2Config
from paddle_tpu.models.qwen2 import Qwen2ForCausalLM as JaxQwen2
from paddle_tpu.models.qwen2_moe import Qwen2MoeConfig as JaxQwen2MoeConfig
from paddle_tpu.models.qwen2_moe import \
    Qwen2MoeForCausalLM as JaxQwen2Moe
from paddle_tpu.ops import lora as jlora
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.models import (DeepseekMoeConfig,
                                     DeepseekMoeForCausalLM, GPTConfig,
                                     GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, Qwen2Config,
                                     Qwen2ForCausalLM, Qwen2MoeConfig,
                                     Qwen2MoeForCausalLM)
from paddle_tpu_torch.ops import lora

# the reference fixtures' shapes (tests/test_lora.py; Qwen2 at Llama's
# with kv_heads 2) and engine
LLAMA = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=4, ffn=128)
QWEN2 = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128)
GPT = dict(vocab=96, hidden=64, layers=2, heads=4)
SCFG = dict(num_slots=4, block_size=8, max_model_len=64, prefill_chunk=8,
            lora_rank=4, max_adapters=4, eos_token_id=None)
# the reference's features the port has no slice for yet, off
REF_ONLY = dict(health=False, min_prefill_bucket=8, async_depth=0)
ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
COUNTERS = ("lora_enabled", "lora_adapters_resident", "lora_adapter_swaps",
            "lora_host_tier_bytes", "tokens_total", "requests_completed",
            "prefix_blocks_reused", "preemptions")
# K4's float32 delta against the interpreted Pallas K4: the same float32
# products summed in another order. An output sums ~1000 products and is
# up to ~130 here, so one that cancels keeps its terms' rounding in
# absolute terms (readings: 3.9e-5 at rank 8, 1.2e-5 on an output of 3e-3)
DELTA_TOL = dict(rtol=1e-5, atol=1e-4)


def _pair(jcfg_cls, jcls, tcfg_cls, tcls, shape, seed, biases=False):
    paddle.seed(seed)
    ref = jcls(jcfg_cls.tiny(**shape))
    ref.eval()
    if biases:          # Qwen2's q/k/v biases drawn away from zero
        rng = np.random.RandomState(seed)
        for name, p in ref.named_parameters():
            if name.endswith("bias"):
                p.set_value((0.5 * rng.randn(*p.shape)).astype(np.float32))
    port = tcls(tcfg_cls.tiny(**shape), device="cpu")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    return ref, port.eval()


@pytest.fixture(scope="module")
def llama():
    return _pair(JaxLlamaConfig, JaxLlama, LlamaConfig, LlamaForCausalLM,
                 LLAMA, 7)


@pytest.fixture(scope="module")
def qwen2():
    return _pair(JaxQwen2Config, JaxQwen2, Qwen2Config, Qwen2ForCausalLM,
                 QWEN2, 5, biases=True)


@pytest.fixture(scope="module")
def gpt():
    return _pair(JaxGPTConfig, JaxGPT, GPTConfig, GPTForCausalLM, GPT, 11)


def _prompts(vocab=128, lens=(9, 11, 7), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, (n,)).astype(np.int64) for n in lens]


def _widths(port):
    """``{leaf: (d_in, d_out)}`` of the port model's target projections
    (read without tagging: an engine's stamps stay as they are)."""
    return {q.rsplit(".", 1)[-1]: tuple(m.weight.shape)
            for q, m in port.named_modules()
            if q.rsplit(".", 1)[-1] in lora.ATTN_TARGETS + lora.MLP_TARGETS}


def _weights(port, names, seed, rank=4, scale=0.3):
    """Leaf-name adapter weights (every layer's module of that name), drawn
    N(0, scale) at the widths of the port model's modules, in ``names``'
    order, as the reference's ``_w``."""
    widths = _widths(port)
    rng = np.random.RandomState(seed)
    out = {}
    for n in names:
        d, o = widths[n]
        out[n] = (rng.normal(0, scale, (d, rank)).astype(np.float32),
                  rng.normal(0, scale, (rank, o)).astype(np.float32))
    return out


def _engine(pair, names, port=True, **kw):
    """An engine of SCFG (``kw`` on top) over the pair's port model (or,
    ``port=False``, its reference model) with adapters 1 and 2 of
    ``names`` loaded."""
    ref, model = pair
    if port:
        eng = ServingEngine(model, ServingConfig(**dict(SCFG, **kw)),
                            device="cpu")
    else:
        eng = JaxServingEngine(ref, JaxServingConfig(**dict(SCFG, **kw),
                                                     **REF_ONLY))
    for aid in (1, 2):
        eng.load_adapter(aid, _weights(model, names, 100 * aid + 1,
                                       rank=kw.get("lora_rank", 4)))
    return eng


def _batched(eng, prompts, aids, max_new=6):
    rids = [eng.submit(p.copy(), max_new, adapter_id=a)
            for p, a in zip(prompts, aids)]
    done = eng.run()
    st = eng.stats()
    eng.shutdown()
    return [done[r] for r in rids], st


def _assert_equal(a, b, tag):
    assert len(a) == len(b), tag
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{tag} request {i}")


# ------------------------------------------------------------- the pool


def _pool_pair(rank=2, quant=False, d=8, out=8, max_resident=2):
    specs = [("m.q_proj", "q_proj", d, out)]
    return (jlora.AdapterPool(specs, rank, max_resident=max_resident,
                              quant=quant),
            lora.AdapterPool(specs, rank, max_resident=max_resident,
                             quant=quant, device="cpu"))


def test_pool_lifecycle_matches_reference():
    """The reference's lifecycle (LRU rows, refcount pins, the refusals,
    swaps, residency, host-tier bytes) step by step on both pools."""
    pools = _pool_pair()
    w = {"q_proj": (np.ones((8, 2), np.float32),
                    np.ones((2, 8), np.float32))}

    def both(fn):
        out = []
        for p in pools:
            try:
                out.append(("ok", fn(p)))
            except (KeyError, ValueError) as e:
                out.append((type(e).__name__, str(e)))
        assert out[0] == out[1], out
        return out[1]

    for aid in (1, 2, 3):
        both(lambda p: p.register(aid, w))
    steps = [lambda p: (p.known(1), p.known(9), p.n_resident,
                        p.host_tier_bytes),
             lambda p: p.acquire(1), lambda p: p.acquire(2),
             lambda p: p.acquire(3), lambda p: p.evict(1),
             lambda p: p.release(1), lambda p: p.acquire(3),
             lambda p: (p.swaps, p.resident(1), p.resident(3),
                        p.host_tier_bytes),
             lambda p: p.acquire(2), lambda p: p.refcount(2),
             lambda p: p.release(2), lambda p: p.release(2),
             lambda p: p.evict(2),
             lambda p: (p.swaps, p.resident(2), p.n_resident,
                        p.host_tier_bytes),
             lambda p: p.acquire(9)]
    got = [both(f) for f in steps]
    assert got[3] == ("ok", None) and got[4][0] == "ValueError" \
        and "pinned" in got[4][1] and got[-1][0] == "KeyError" \
        and "unknown adapter_id" in got[-1][1]


def test_pool_validation_and_hot_reload_match_reference():
    pools = _pool_pair()
    for bad in ({"q_proj": (np.ones((4, 2), np.float32),
                            np.ones((2, 8), np.float32))},
                {"nope": (np.ones((8, 2), np.float32),
                          np.ones((2, 8), np.float32))}):
        errs = []
        for p in pools:
            with pytest.raises(ValueError) as e:
                p.register(1, bad)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    assert "expects A (8, 2)" in errs[0] or "no target module" in errs[0]
    rows = []
    for p in pools:
        p.register(1, {"q_proj": (np.ones((8, 2), np.float32),
                                  np.ones((2, 8), np.float32))})
        rows.append(p.acquire(1))
        v0, g0 = p.version, getattr(p, "generation", lambda a: 0)(1)
        p.register(1, {"q_proj": (2 * np.ones((8, 2), np.float32),
                                  np.ones((2, 8), np.float32))})
        assert p.version > v0
    assert rows[0] == rows[1]
    port = pools[1]
    assert port.generation(1) == g0 + 1 == 2
    np.testing.assert_array_equal(
        np.asarray(pools[0].operand()[0][0][rows[0]]),
        port.operand()[0][0][rows[1]][:, :2].numpy())


def test_pool_int8_rows_equal_reference_bitwise():
    rng = np.random.RandomState(0)
    pools = _pool_pair(quant=True, d=16, out=24)
    w = {"q_proj": (rng.randn(16, 2).astype(np.float32),
                    rng.randn(2, 24).astype(np.float32))}
    rows = []
    for p in pools:
        p.register(1, w)
        rows.append(p.acquire(1))
    (aq, asc, bq, bsc), (taq, tasc, tbq, tbsc) = \
        pools[0].operand()[0], pools[1].operand()[0]
    r, tr = rows
    np.testing.assert_array_equal(aq[r], taq[tr][:, :2].numpy())
    np.testing.assert_array_equal(bq[r], tbq[tr][:2].numpy())
    np.testing.assert_array_equal(asc[r], tasc[tr].numpy())
    np.testing.assert_array_equal(bsc[r], tbsc[tr].numpy())
    assert taq.dtype == tbq.dtype == torch.int8
    assert not taq[0].any() and not tbq[0].any()   # the null row
    assert not taq[tr][:, 2:].any() and not tbq[tr][2:].any()


def test_rank_padding_is_invisible_but_to_the_stacks():
    """Rank 4 is stored at 8 (zero columns of A, zero rows of B): the
    shapes register checks, its messages and ``host_tier_bytes`` stay at
    rank 4, and the padded delta is the unpadded one (the zero terms are
    exact; the CPU's matmul may sum the rest in another order, so within
    DELTA_TOL)."""
    ref, port = _pool_pair(rank=4, d=16, out=24)
    assert lora.padded_rank(4) == 8 and lora.padded_rank(8) == 8 \
        and lora.padded_rank(9) == 16
    assert port.rank == 4 and port.rank_padded == 8
    a_stack, b_stack = port.operand()[0]
    assert tuple(a_stack.shape) == (3, 16, 8) \
        and tuple(b_stack.shape) == (3, 8, 24)
    rng = np.random.RandomState(1)
    w = {"q_proj": (rng.randn(16, 4).astype(np.float32),
                    rng.randn(4, 24).astype(np.float32))}
    for p in (ref, port):
        p.register(1, w)
    assert port.host_tier_bytes == ref.host_tier_bytes == (16 + 24) * 4 * 4
    msgs = []
    for p in (ref, port):
        with pytest.raises(ValueError) as e:
            p.register(2, {"q_proj": (np.ones((16, 8), np.float32),
                                      np.ones((8, 24), np.float32))})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "(16, 4)" in msgs[1]
    row = port.acquire(1)
    assert not a_stack[row, :, 4:].any() and not b_stack[row, 4:].any()
    x = torch.from_numpy(rng.randn(5, 16).astype(np.float32))
    ra = torch.tensor([row, 0, row, 0, row])
    padded = lora.ragged_delta(x, ra, a_stack, b_stack)
    plain = lora.plain_ragged_delta(x, ra, a_stack[:, :, :4],
                                    b_stack[:, :4])
    torch.testing.assert_close(padded, plain, **DELTA_TOL)
    assert not padded[1].any() and not padded[3].any()


# ------------------------------------------------------ modules and delta


FAMILIES = {
    "llama": (JaxLlamaConfig, JaxLlama, LlamaConfig, LlamaForCausalLM),
    "qwen2": (JaxQwen2Config, JaxQwen2, Qwen2Config, Qwen2ForCausalLM),
    "gpt": (JaxGPTConfig, JaxGPT, GPTConfig, GPTForCausalLM),
    "qwen2_moe": (JaxQwen2MoeConfig, JaxQwen2Moe, Qwen2MoeConfig,
                  Qwen2MoeForCausalLM),
    "deepseek_moe": (JaxDeepseekConfig, JaxDeepseek, DeepseekMoeConfig,
                     DeepseekMoeForCausalLM)}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tag_modules_specs_equal_reference(family):
    jcfg, jcls, tcfg, tcls = FAMILIES[family]
    ref, port = jcls(jcfg.tiny()), tcls(tcfg.tiny(), device="cpu")
    specs = {}
    for targets in ("all", "attn"):
        want = jlora.tag_modules(ref, targets)
        specs[targets] = lora.tag_modules(port, targets)
        assert specs[targets] == want, targets
    # "attn" after "all": the MLP projections' stamps cleared
    mlp = [m for q, m in port.named_modules()
           if q.rsplit(".", 1)[-1] in lora.MLP_TARGETS]
    assert mlp and all(m._lora_slot is None for m in mlp)
    assert len(specs["all"]) > len(specs["attn"]) > 0
    with pytest.raises(ValueError, match="lora_targets"):
        lora.tag_modules(port, "mlp")


@pytest.mark.parametrize("rank", [4, 8])
def test_ragged_delta_matches_reference_einsum_and_interpreted_k4(rank):
    """The delta through K4's wrappers (plain versions here) at the
    stacks' padded rank: the reference's einsum, and its interpreted
    Pallas K4 within DELTA_TOL."""
    rng = np.random.RandomState(3)
    rows = rng.randn(8, 128).astype(np.float32)
    ra = np.array([0, 2, 1, 1, 0, 2, 2, 1], np.int32)
    A = rng.randn(3, 128, rank).astype(np.float32)
    B = rng.randn(3, rank, 128).astype(np.float32)
    j = [jnp.asarray(v) for v in (rows, ra, A, B)]
    ein = np.asarray(jlora._ragged_delta(*j, False))
    itp = np.asarray(jlora._ragged_delta(*j, "interpret"))
    rp = lora.padded_rank(rank)
    Ap = np.zeros((3, 128, rp), np.float32)
    Ap[:, :, :rank] = A
    Bp = np.zeros((3, rp, 128), np.float32)
    Bp[:, :rank] = B
    got = lora.ragged_delta(torch.from_numpy(rows), torch.from_numpy(ra),
                            torch.from_numpy(Ap), torch.from_numpy(Bp))
    np.testing.assert_allclose(got.numpy(), ein, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), itp, **DELTA_TOL)
    plain = lora.plain_ragged_delta(*(torch.from_numpy(v)
                                      for v in (rows, ra, A, B)))
    np.testing.assert_allclose(plain.numpy(), ein, rtol=1e-6, atol=1e-5)


def test_apply_is_a_no_op_outside_the_tick():
    """Untagged modules, no scope, and activations that are not the
    scope's packed rows (a draft model's, another width) pass unchanged;
    the tick's rows get ``y + delta * scale``."""
    pool = lora.AdapterPool([("m", "q_proj", 8, 8)], 2, alpha=4.0,
                            device="cpu")
    mod = torch.nn.Linear(8, 8)
    x, y = torch.randn(3, 8), torch.randn(3, 8)
    assert lora.apply(mod, x, y) is y
    mod._lora_slot = 0
    assert lora.apply(mod, x, y) is y and not lora.armed(mod)
    rng = np.random.RandomState(0)
    pool.register(1, {"q_proj": (rng.randn(8, 2).astype(np.float32),
                                 rng.randn(2, 8).astype(np.float32))})
    row = pool.acquire(1)
    ra = torch.tensor([row, 0, row])
    with lora.serving_lora_scope(pool.operand(), ra, pool.scaling):
        assert lora.armed(mod)
        assert lora.apply(mod, torch.randn(4, 8), y) is y
        assert lora.apply(mod, x[:, :4], y) is y
        got = lora.apply(mod, x, y)
    a_stack, b_stack = pool.operand()[0]
    A, B = a_stack[:, :, :2], b_stack[:, :2]
    want = y + lora.plain_ragged_delta(x, ra, A, B) * 2.0
    torch.testing.assert_close(got, want)
    assert torch.equal(got[1], y[1])


# ----------------------------------------------- the engine vs the reference


def _all_names():
    return ("q_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


CASES = {"llama_attn": ("llama", ATTN, (1, 2, None), {}),
         "llama_all": ("llama", _all_names(), (1, 2),
                       dict(lora_targets="all")),
         "qwen2": ("qwen2", ATTN, (1, 2, None), {}),
         "gpt": ("gpt", ("qkv_proj", "out_proj"), (1, 2), {}),
         "llama_int8": ("llama", ATTN, (1, 2), dict(kv_cache_dtype="int8")),
         "llama_ngram": ("llama", ATTN, (1, 2, None),
                         dict(num_speculative_tokens=2)),
         "llama_quant": ("llama", ATTN, (1, 2), dict(lora_quant=True))}


@pytest.mark.parametrize("case", list(CASES))
def test_streams_and_counters_equal_reference_and_solo(request, case):
    """One mixed batch (tenants 1 and 2, a base rider where the
    reference's test has one) on both engines: the port's streams and
    counters are the reference's, and each stream is the port's solo
    run of its request."""
    fixture, names, aids, kw = CASES[case]
    pair = request.getfixturevalue(fixture)
    prompts = _prompts(vocab=pair[0].config.vocab_size, lens=(9, 11, 7)[
        :len(aids)])
    want, st_want = _batched(_engine(pair, names, port=False, **kw),
                             prompts, aids)
    got, st = _batched(_engine(pair, names, **kw), prompts, aids)
    _assert_equal(want, got, f"{case} port vs reference")
    assert {k: st[k] for k in COUNTERS} == {k: st_want[k] for k in COUNTERS}
    assert st["lora_enabled"] and st["lora_adapters_resident"] == 2
    for i, (p, a) in enumerate(zip(prompts, aids)):
        solo, _ = _batched(_engine(pair, names, **kw), [p], [a])
        _assert_equal(solo, got[i:i + 1], f"{case} batched vs solo {i}")
    if case == "llama_attn":
        # the adapters move the streams: each differs from the base run
        base, _ = _batched(_engine(pair, names, **kw), prompts, (None,) * 3)
        assert not np.array_equal(base[0], got[0]) \
            and not np.array_equal(base[1], got[1])
        np.testing.assert_array_equal(base[2], got[2])


def test_fused_decode_equals_the_module_path(llama):
    """The fused tick composes per module (an armed o_proj / down_proj
    leaves K3b; q/k/v and gate/up add their delta off the recomputed
    norm): its streams equal the module path's under both target sets."""
    prompts = _prompts()
    for targets, names in (("attn", ATTN), ("all", _all_names())):
        outs = [_batched(_engine(llama, names, lora_targets=targets,
                                 fused_decode=fused), prompts,
                         (1, 2, None))[0] for fused in (True, False)]
        _assert_equal(outs[1], outs[0], f"{targets} fused on vs off")


def test_preempt_resume_under_an_adapter_matches_reference(llama):
    """The reference's schedule (tests/test_lora.py): a low-priority
    request under adapter 1 streams alone, two high-priority arrivals
    preempt it; it resumes under its adapter (unpinned at preemption,
    pinned again at readmission) token for token as on a roomy engine,
    and as the reference engine does under the same schedule."""
    rng = np.random.RandomState(5)
    lo = rng.randint(1, 128, (20,)).astype(np.int64)
    h1 = rng.randint(1, 128, (9,)).astype(np.int64)
    h2 = rng.randint(1, 128, (7,)).astype(np.int64)
    plan = ((lo, 1, 0), (h1, 2, 2), (h2, None, 2))

    def contention(is_port):
        eng = _engine(llama, ATTN, port=is_port, num_slots=2,
                      max_model_len=96)
        rids = [eng.submit(lo.copy(), 12, adapter_id=1, priority=0)]
        for _ in range(4):
            eng.step()
        rids += [eng.submit(p.copy(), 12, adapter_id=a, priority=pr)
                 for p, a, pr in plan[1:]]
        done = eng.run()
        st = eng.stats()
        eng.shutdown()
        return [done[r] for r in rids], st

    got, st = contention(True)
    want, st_want = contention(False)
    roomy = _engine(llama, ATTN, num_slots=4, max_model_len=96)
    rids = [roomy.submit(p.copy(), 12, adapter_id=a, priority=pr)
            for p, a, pr in plan]
    never = roomy.run()
    assert st["preemptions"] >= 1
    _assert_equal(want, got, "preempted port vs reference")
    _assert_equal([never[r] for r in rids], got, "preempted vs never")
    assert {k: st[k] for k in COUNTERS} == {k: st_want[k] for k in COUNTERS}
    assert st["lora_adapters_resident"] == 2


# ------------------------------------------------------ the prefix keys


def test_prefix_blocks_are_never_shared_across_adapters(llama):
    """The same prompt twice on the base model, then under adapter 1,
    adapter 2, adapter 1 hot-reloaded and adapter 1 again, on one engine.
    The reference keys blocks by the model alone, so each adapter reuses
    K/V computed without it or under another (its fault, pinned here).
    The port reuses no block across adapters nor across a reload, and
    each run equals its solo run; base requests keep the reference's
    keys, and an adapter reuses its own blocks."""
    (p,) = _prompts(lens=(19,), seed=9)       # two full blocks of 8
    reloaded = _weights(llama[1], ATTN, 999)

    def run(eng, plan):
        outs, reused = [], []
        for aid, reload in plan:
            if reload:
                eng.load_adapter(aid, reloaded)
            r0 = eng.stats()["prefix_blocks_reused"]
            rid = eng.submit(p.copy(), 6, adapter_id=aid)
            outs.append(eng.run()[rid])
            reused.append(eng.stats()["prefix_blocks_reused"] - r0)
        eng.shutdown()
        return outs, reused

    plan = ((None, False), (None, False), (1, False), (2, False), (1, True),
            (1, False))
    want, want_reused = run(_engine(llama, ATTN, port=False), plan)
    got, reused = run(_engine(llama, ATTN), plan)
    assert want_reused[2] > 0 and want_reused[3] > 0   # the reference's fault
    assert reused == [0, 2, 0, 0, 0, 2]
    # base requests: the reference's keys and streams
    assert want_reused[:2] == reused[:2]
    _assert_equal(want[:2], got[:2], "base runs port vs reference")
    solo = [_batched(_engine(llama, ATTN), [p], [a])[0][0]
            for a in (1, 2)]
    eng = _engine(llama, ATTN)
    eng.load_adapter(1, reloaded)
    solo.append(_batched(eng, [p], [1])[0][0])
    _assert_equal(solo, got[2:5], "adapter runs vs solo")
    np.testing.assert_array_equal(got[5], got[4])
    assert not np.array_equal(got[2], got[4])     # the reload moved it


# --------------------------------------------------------- port-only cases


def test_churn_through_two_rows_reseats_an_evicted_adapter_exactly(llama):
    """Four adapters through a two-row window: rows swap, the host tier
    holds the evicted, distinct adapters decode distinct continuations,
    and the first adapter, evicted and seated again, gives its first
    tokens."""
    _, port = llama
    eng = ServingEngine(port, ServingConfig(**dict(SCFG, max_adapters=2)),
                        device="cpu")
    for aid in (1, 2, 3, 4):
        eng.load_adapter(aid, _weights(port, ATTN, 100 + aid))
    (p,) = _prompts(lens=(9,))
    first = {}
    for aid in (1, 2, 3, 4):
        rid = eng.submit(p.copy(), 6, adapter_id=aid)
        first[aid] = eng.run()[rid]
    st = eng.stats()
    assert st["lora_adapter_swaps"] >= 2 and st["lora_host_tier_bytes"] > 0
    assert not eng.adapter_resident(1) and eng.adapter_resident(4)
    rid = eng.submit(p.copy(), 6, adapter_id=1)
    np.testing.assert_array_equal(eng.run()[rid], first[1])
    assert eng.adapter_resident(1)
    assert len({tuple(v.tolist()) for v in first.values()}) > 1
    assert eng.shutdown()


def test_evict_is_refused_mid_request(llama):
    eng = _engine(llama, ATTN)
    eng.submit(_prompts()[0], 8, adapter_id=1)
    for _ in range(3):
        eng.step()
    assert eng._lora.refcount(1) == 1
    with pytest.raises(ValueError, match="pinned"):
        eng._lora.evict(1)
    eng.run()
    assert eng._lora.refcount(1) == 0 and eng.adapter_resident(1)
    eng._lora.evict(1)
    assert not eng.adapter_resident(1)
    assert eng.shutdown()


def test_admission_waits_for_a_free_adapter_row(llama):
    """With one resident row pinned by adapter 1, a request under adapter
    2 stays queued (a base request passes it) until adapter 1's request
    retires; then it seats and equals its solo run."""
    _, port = llama
    eng = ServingEngine(port, ServingConfig(**dict(SCFG, max_adapters=1)),
                        device="cpu")
    for aid in (1, 2):
        eng.load_adapter(aid, _weights(port, ATTN, 100 * aid + 1))
    prompts = _prompts()
    rids = [eng.submit(p.copy(), 6, adapter_id=a)
            for p, a in zip(prompts, (1, 2, None))]
    eng.step()
    assert eng.num_active == 1 and eng.num_queued == 2
    done = eng.run()
    solo, _ = _batched(_engine(llama, ATTN), [prompts[1]], [2])
    np.testing.assert_array_equal(done[rids[1]], solo[0])
    assert eng.stats()["lora_adapter_swaps"] == 1


def test_validation_and_stats_keys(llama):
    _, port = llama
    for bad, match in ((dict(lora_rank=-1), "lora_rank"),
                       (dict(lora_rank=True), "lora_rank"),
                       (dict(max_adapters=0), "max_adapters"),
                       (dict(lora_targets="mlp"), "lora_targets"),
                       (dict(lora_alpha=0.0), "lora_alpha")):
        with pytest.raises(ValueError, match=match):
            ServingConfig(**dict(SCFG, **bad))
    eng = _engine(llama, ATTN)
    with pytest.raises(ValueError, match="unknown adapter_id"):
        eng.submit(_prompts()[0], 4, adapter_id=7)
    assert eng.stats()["lora_host_tier_bytes"] > 0
    base = ServingEngine(port, ServingConfig(**dict(SCFG, lora_rank=0)),
                         device="cpu")
    with pytest.raises(ValueError, match="lora_rank"):
        base.submit(_prompts()[0], 4, adapter_id=1)
    with pytest.raises(ValueError, match="lora_rank"):
        base.load_adapter(1, _weights(port, ATTN, 1))
    st = base.stats()
    assert (st["lora_enabled"], st["lora_adapters_resident"],
            st["lora_adapter_swaps"], st["lora_host_tier_bytes"]) \
        == (False, 0, 0, 0)
    assert not base.adapter_resident(1)
