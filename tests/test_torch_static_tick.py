"""The PyTorch port's ticks with prefill rows at the reference's static
width, and ``generate()``'s decode loop with its all-done flag read one
step late, against the JAX package on the CPU (where every tick and step
runs eagerly: their CUDA graphs are held to the eager ones by
``tests/test_torch_graphs_gpu.py`` on the card).

The engine's static width (``_rows``, ``_wmax``, the overflow position)
equals the reference engine's for the same config; every tick with
prefill rows of a staggered schedule packs that width with one layout a
count of verifying slots (a graph's key on the card); staggered
admissions stay token-exact against the reference engine for Llama on
float and int8 pools, the model drafting for itself (its prime now in
the tick body), a token tree, draft heads, dropless DeepSeek-MoE and GPT
on float32 pools; the MoE telemetry of ticks with pad rows equals the
reference's (pad rows masked); and the decode loop with an EOS emits the
reference's tokens and scores, running at most one step past the one on
which every row was done.
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
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.generation import _decode_loop
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.models import (DeepseekMoeConfig,
                                     DeepseekMoeForCausalLM, GPTConfig,
                                     GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)

# the reference fixtures' tiny shapes (tests/test_async_tick.py)
LLAMA = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128)
GPT = dict(vocab=96, hidden=64, layers=2, heads=4)
MOE = dict(vocab=128, hidden=64, layers=3, heads=4, kv_heads=4, moe_ffn=32,
           dense_ffn=48, experts=8, shared=2, topk=2)
CORE = dict(num_slots=2, block_size=8, max_model_len=64, prefill_chunk=8)
REF_OFF = dict(enable_prefix_cache=False, enable_preemption=False,
               health=False, min_prefill_bucket=8, async_depth=0)
# the prefix cache and preemption off in the port's engine of a pair too
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


def _prompts(vocab=128, lens=(13, 5, 11, 3), seed=0):
    """A repeated motif and a random tail, so prompt lookup finds drafts;
    13 and 11 tokens span two 8-row chunks."""
    rng = np.random.RandomState(seed)
    motif = rng.randint(1, vocab, 4).tolist()
    return [np.asarray((motif * 3)[:max(0, n - 2)]
                       + rng.randint(1, vocab, min(n, 2)).tolist(),
                       np.int64) for n in lens]


def _staggered(eng, prompts, max_new, every=2):
    """Submit prompt k before tick ``every * k`` and run dry; the streams
    in submission order."""
    rids, t = [], 0
    while len(rids) < len(prompts) or eng.num_active or eng.num_queued:
        while len(rids) < len(prompts) and t >= every * len(rids):
            rids.append(eng.submit(prompts[len(rids)].copy(), max_new))
        eng.step()
        t += 1
    done = eng.run()
    return [np.asarray(done[r]) for r in rids]


STATIC = {"plain": {},
          "gamma4": dict(num_speculative_tokens=4),
          "tree": dict(num_speculative_tokens=3, spec_tree=(0, 0, 1)),
          "prefill_rows": dict(ragged_prefill_rows=12, prefill_chunk=6)}


@pytest.mark.parametrize("case", list(STATIC))
def test_static_width_equals_reference(llama, case):
    ref, port = llama
    kw = dict(CORE, **STATIC[case])
    want = JaxServingEngine(ref, JaxServingConfig(**kw, **REF_OFF))
    got = ServingEngine(port, ServingConfig(**kw, **PORT_OFF),
                        device="cpu")
    assert (got._rows, got._wmax, got._overflow) == \
        (want._rows, want._wmax, want._overflow)


LAYOUTS = {"decode": ({}, False),
           "ngram": (dict(num_speculative_tokens=2), False),
           "tree": (dict(num_speculative_tokens=3, spec_tree=(0, 0, 1)),
                    False),
           "self_draft": (dict(num_speculative_tokens=2, drafter="model"),
                          True),
           "async": (dict(async_depth=1), False)}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_mixed_ticks_pack_the_static_layout(llama, case):
    """Every tick with prefill rows of a staggered schedule (3 slots, so
    one, two or no slot verifies beside the prompts) runs a layout of
    the static width, one layout a count of verifying slots (one without
    speculation); a pure tick packs its live rows."""
    _, port = llama
    kw, self_draft = LAYOUTS[case]
    eng = ServingEngine(port, ServingConfig(**dict(CORE, num_slots=3),
                                            **kw), device="cpu",
                        draft_model=port if self_draft else None)
    seen = []
    run = eng._run

    def record(lay, pack=None, carry=None):
        seen.append((lay, None if pack is None else pack.size))
        return run(lay, pack=pack, carry=carry)

    eng._run = record
    _staggered(eng, _prompts(lens=(13, 5, 11, 3, 9)), 6)
    mixed = {lay for lay, _ in seen if not lay.pure}
    assert mixed and all(lay.rows == eng._rows and lay.w_max == eng._wmax
                         for lay in mixed)
    assert len(mixed) == len({lay.active for lay in mixed})
    if not kw.get("num_speculative_tokens"):
        assert len(mixed) == 1
    assert len({(lay, n) for lay, n in seen if not lay.pure}) == len(mixed)
    g = int(kw.get("num_speculative_tokens", 0))
    assert all(lay.rows % (g + 1) == 0 and lay.rows < eng._rows
               for lay, _ in seen if lay.pure)


STREAMS = {"llama": ("llama", {}, 10),
           "llama_int8": ("llama", dict(kv_cache_dtype="int8"), 10),
           "self_draft": ("llama", dict(num_speculative_tokens=3,
                                        drafter="model"), 10),
           "tree": ("llama", dict(num_speculative_tokens=3,
                                  spec_tree=(0, 0, 1)), 10),
           "heads": ("llama", dict(num_speculative_tokens=4,
                                   spec_tree=(0, 0, 1, 1),
                                   drafter="heads"), 10),
           "deepseek_moe": ("moe", {}, 8),
           "gpt": ("gpt", {}, 8)}


@pytest.mark.parametrize("case", list(STREAMS))
def test_staggered_streams_match_reference(request, case):
    fixture, kw, new = STREAMS[case]
    ref, port = request.getfixturevalue(fixture)
    self_draft = kw.get("drafter") == "model"
    prompts = _prompts(vocab=ref.config.vocab_size)
    want = _staggered(JaxServingEngine(
        ref, JaxServingConfig(**CORE, **REF_OFF, **kw),
        draft_model=ref if self_draft else None), prompts, new)
    got = _staggered(ServingEngine(
        port, ServingConfig(**CORE, **PORT_OFF, **kw), device="cpu",
        draft_model=port if self_draft else None), prompts, new)
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(x, y, err_msg=f"{case} request {i}")


def test_moe_telemetry_of_padded_ticks_matches_reference(moe):
    """Ticks with prefill rows carry pad rows (a 5-token prompt in a
    10-row tick), which route through the MoE dispatch but are masked out
    of the telemetry: after each tick the routing entropy and the
    largest expert load equal the reference's."""
    ref, port = moe
    p0, p1 = _prompts(lens=(5, 11))
    engines = [JaxServingEngine(ref, JaxServingConfig(**CORE, **REF_OFF)),
               ServingEngine(port, ServingConfig(**CORE, **PORT_OFF),
                             device="cpu")]
    for e in engines:
        e.submit(p0.copy(), 4)
        e.submit(p1.copy(), 4)
    for tick in range(5):
        st = []
        for e in engines:
            e.step()
            st.append(e.stats())
        assert st[1]["moe_dispatches"] > 0
        for key in ("moe_routing_entropy", "moe_expert_load_max"):
            assert st[1][key] == pytest.approx(st[0][key], abs=1e-6), \
                (tick, key)
    for e in engines:
        e.run()


def test_paged_generate_eos_matches_reference(llama):
    """A paged generate() whose rows reach EOS at different steps: the
    reference's tokens (pads after each EOS) and scores."""
    ref, port = llama
    ids = np.stack(_prompts(lens=(9, 9), seed=3))
    base, _ = port.generate(torch.from_numpy(ids), max_new_tokens=10,
                            cache_impl="paged")
    eos = int(base[0, 2])
    out, sc = port.generate(torch.from_numpy(ids), max_new_tokens=10,
                            cache_impl="paged", eos_token_id=eos)
    want, want_sc = ref.generate(paddle.to_tensor(ids), max_new_tokens=10,
                                 cache_impl="paged", eos_token_id=eos)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want.numpy()))
    np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc.numpy()),
                               atol=1e-4, rtol=0)


def test_decode_loop_reads_done_one_step_late():
    """Rows that emit EOS at steps 2 and 4 of 10: the loop's tokens and
    scores equal an immediate exit's, and it runs step 5 (one past the
    step on which every row was done) and no further."""
    eos, pad, b, v = 7, 0, 2, 11
    done_at = [2, 4]
    calls = []

    def step(i, tok, caches):
        calls.append(i)
        logits = torch.full((b, 1, v), -1.0)
        for r in range(b):
            logits[r, 0, eos if i == done_at[r] else 1 + (i + r) % 5] = 1.0
        return logits, caches

    def select(lg):
        lp = torch.log_softmax(lg.float(), -1)
        tok = torch.argmax(lg, -1)
        return tok, torch.gather(lp, -1, tok[:, None])[:, 0]

    first = (torch.tensor([3, 4]), torch.tensor([-0.5, -0.25]))
    out, score = _decode_loop(step, first, None, 10, select, eos, pad)
    assert calls == [1, 2, 3, 4, 5]
    want = np.full((b, 10), pad)
    want[:, 0] = [3, 4]
    sc = np.asarray([-0.5, -0.25], np.float32)
    lp_hit = float(torch.log_softmax(torch.tensor(
        [-1.0] * (v - 1) + [1.0]), -1)[-1])
    for r in range(b):
        for i in range(1, done_at[r] + 1):
            want[r, i] = eos if i == done_at[r] else 1 + (i + r) % 5
            sc[r] += np.float32(lp_hit)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_allclose(score.numpy(), sc, rtol=1e-6)
