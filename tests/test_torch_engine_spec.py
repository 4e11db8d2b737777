"""The PyTorch port's speculative ServingEngine and K2r's per-slot tree
mask against the JAX package on the CPU.

The plain K2r tree mode (``tree_anc`` + ``tree_slots``) must match the
reference's interpreted Pallas ``_ragged_kernel`` and its gather fallback
``_xla_ragged_paged`` on a mixed tick (flagged verify windows beside an
unflagged prefill chunk and trickle rows) at rtol = atol = 1e-5 in float32
and on int8 pools (one softmax a row over the same float32 scores, summed
in another order) and 2e-2 in bfloat16 (the K2 bf16 parity tolerance: the
reference rounds P to bfloat16, the plain version does not), over GQA
groups 1 and 2 and block sizes 8 and 16; a chain tree equals linear K2r
bit for bit. The speculative engine, with weights crossed from a seeded
reference Llama by ``params_from_jax``, must stream the reference
engine's greedy tokens for every drafter (linear n-gram under slot and
block pressure, a draft model, chain and branching trees, draft heads
with seeded and given weights, int8 pools) with the reference's
speculation counters.
"""
import gc
import weakref

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
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaDecoderLayer,
                                           LlamaForCausalLM)
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import paged_cache as tpc
from paddle_tpu_torch.ops.kernels import launch_counts
from paddle_tpu_torch.ops.kernels import paged_attention as pda
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# the reference's tiny Llama of its tree tests
TINY = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128)
CORE = dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8)
BRANCHY = (0, 0, 1, 2, 3, 4, 5)       # spine 1-3-5-7, branch 2-4-6


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------- the plain K2r tree mask


def _tick(rng, tree, rep, BS, D=32, Hkv=2, MB=6):
    """A mixed ragged tick: two flagged tree windows of T rows, an
    unflagged 12-row prefill chunk and an unflagged trickle slot of T
    rows, each slot at its own context, over a random pool."""
    T = len(tree) + 1
    q_lens = np.asarray([T, 12, T, T], np.int32)
    base = np.asarray([BS * 3 - 2, 5, 17, BS * (MB - 1) - T], np.int64)
    flags = np.asarray([1, 0, 1, 0], np.int32)
    S = len(q_lens)
    NB = 1 + S * MB
    tables = np.zeros((S, MB), np.int32)
    alloc = tpc.BlockAllocator(NB)
    for s in range(S):
        n = tpc.blocks_for(int(base[s]) + int(q_lens[s]), BS)
        tables[s, :n] = alloc.alloc(n)
    R = int(q_lens.sum())
    row_slot, _, row_starts, _ = tpc.ragged_row_meta(q_lens, base, R,
                                                     MB * BS)
    return dict(q=rng.randn(R, Hkv * rep, D).astype(np.float32),
                kp=rng.randn(NB, BS, Hkv, D).astype(np.float32),
                vp=rng.randn(NB, BS, Hkv, D).astype(np.float32),
                tables=tables, ctx=(base + 1).astype(np.int32),
                q_lens=q_lens, row_starts=row_starts, row_slot=row_slot,
                flags=flags, T=T, w_max=int(q_lens.max()))


def _operands(b, pool):
    """(jax q, k, v) and (port q, k, v) of one tick in ``pool``'s type."""
    if pool == "int8":
        jk, jv = (jpc.QuantKV(*jpc.kv_quantize(jnp.asarray(x)))
                  for x in (b["kp"], b["vp"]))
        return ((jnp.asarray(b["q"]), jk, jv),
                (_t(b["q"]), pool_from_jax(jk, "cpu"),
                 pool_from_jax(jv, "cpu")))
    if pool == "bfloat16":
        j = tuple(jnp.asarray(b[k]).astype(jnp.bfloat16)
                  for k in ("q", "kp", "vp"))
        return j, tuple(_t(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16) for x in j)
    return (tuple(jnp.asarray(b[k]) for k in ("q", "kp", "vp")),
            tuple(_t(b[k]) for k in ("q", "kp", "vp")))


def _live(b):
    return np.concatenate([np.arange(s0, s0 + n) for s0, n in
                           zip(b["row_starts"], b["q_lens"])])


@pytest.mark.parametrize("pool", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("block_size", [8, 16])
def test_plain_ragged_tree_matches_reference(pool, rep, block_size):
    rng = np.random.RandomState(10 * rep + block_size)
    tree = BRANCHY if block_size == 8 else (0, 0, 1, 3)
    b = _tick(rng, tree, rep, block_size)
    (jq, jk, jv), (tq, tk, tv) = _operands(b, pool)
    meta = [jnp.asarray(b[k]) for k in ("tables", "ctx", "q_lens",
                                        "row_starts")]
    jflags = jnp.asarray(b["flags"])
    want_k = jpa.pallas_ragged_paged_attention(
        jq, jk, jv, *meta, w_max=b["w_max"], interpret=True,
        tree_anc=tree, tree_slots=jflags)
    want_x = jpa._xla_ragged_paged(
        jq, jk, jv, *meta, jnp.asarray(b["row_slot"]), b["T"], b["w_max"],
        tree_anc=tree, tree_slots=jflags)
    n0 = dict(launch_counts)
    args = (tq, tk, tv) + tuple(_t(b[k]) for k in (
        "tables", "ctx", "q_lens", "row_starts"))
    got = rpa.ragged_paged_attention(*args, b["w_max"], tree_anc=tree,
                                     tree_slots=_t(b["flags"]))
    assert launch_counts == n0          # CPU tensors: the plain version
    live = _live(b)
    tol = BF16_TOL if pool == "bfloat16" else TOL
    for want in (want_k, want_x):
        np.testing.assert_allclose(
            got.float().numpy()[live],
            np.asarray(want).astype(np.float32)[live], **tol)
    # the flagged windows are masked, the unflagged slots are linear
    lin = rpa.ragged_paged_attention(*args, b["w_max"])
    for s, (s0, n) in enumerate(zip(b["row_starts"], b["q_lens"])):
        same = torch.equal(got[s0:s0 + n], lin[s0:s0 + n])
        assert same == (not b["flags"][s]), s


@pytest.mark.parametrize("pool", ["float32", "int8", "bfloat16"])
def test_chain_tree_equals_linear_ragged_bitwise(pool):
    rng = np.random.RandomState(5)
    b = _tick(rng, (0, 1, 2, 3), 2, 8)
    _, (tq, tk, tv) = _operands(b, pool)
    args = (tq, tk, tv) + tuple(_t(b[k]) for k in (
        "tables", "ctx", "q_lens", "row_starts")) + (b["w_max"],)
    lin = rpa.ragged_paged_attention(*args)
    chain = rpa.ragged_paged_attention(*args, tree_anc=(0, 1, 2, 3),
                                       tree_slots=_t(b["flags"]))
    assert torch.equal(chain, lin)


def test_ragged_tree_refusals():
    rng = np.random.RandomState(6)
    b = _tick(rng, (0, 0, 1), 1, 8)
    args = tuple(_t(b[k]) for k in ("q", "kp", "vp", "tables", "ctx",
                                    "q_lens", "row_starts")) + (b["w_max"],)
    # a flagged slot whose rows outnumber the tree's nodes: the chunk
    with pytest.raises(ValueError, match="tree slot has 12 rows"):
        rpa.ragged_paged_attention(*args, tree_anc=(0, 0, 1),
                                   tree_slots=_t([1, 1, 0, 0]))
    # no flags: every slot is a tree slot, the chunk too
    with pytest.raises(ValueError, match="tree slot"):
        rpa.ragged_paged_attention(*args, tree_anc=(0, 0, 1))
    with pytest.raises(ValueError, match="31 draft nodes"):
        rpa.ragged_paged_attention(*args, tree_anc=tuple(range(32)),
                                   tree_slots=_t(b["flags"]))
    # a declared bound of the flagged rows past the tree's nodes
    with pytest.raises(ValueError, match="tree slot has 5 rows"):
        rpa.ragged_paged_attention(*args, tree_anc=(0, 0, 1),
                                   tree_slots=_t(b["flags"]), tree_rows=5)


def test_ambient_scope_reaches_the_ragged_step():
    """Inside ``spec_tree_scope(tree, flags, rows)`` the ragged attention
    step masks the flagged slots' windows, and the wrapper checks the
    bound ``rows``; explicit arguments win; outside, the bound is
    linear."""
    rng = np.random.RandomState(7)
    tree = (0, 0, 1, 3)
    b = _tick(rng, tree, 2, 8)
    tables, q_lens, starts = (_t(b[k]) for k in ("tables", "q_lens",
                                                 "row_starts"))
    base = _t(b["ctx"] - 1)
    R = b["q"].shape[0]
    row_slot, row_pos, _, _ = tpc.ragged_row_meta(
        b["q_lens"], b["ctx"] - 1, R, 6 * 8)
    kh = _t(rng.randn(R, 2, 32).astype(np.float32))

    def step(**kw):
        kp, vp = _t(b["kp"]), _t(b["vp"])
        out, _, _ = tpa.ragged_attention_step(
            _t(b["q"]), kh, kh, kp, vp, tables, base, q_lens, starts,
            _t(row_slot), _t(row_pos), b["w_max"], **kw)
        return out

    lin = step()
    flags = _t(b["flags"])
    want = step(tree_anc=tree, tree_slots=flags)
    assert not torch.equal(want, lin)
    with pda.spec_tree_scope(tree, flags):
        assert torch.equal(step(), want)
        assert torch.equal(step(tree_anc=None), lin)
    with pda.spec_tree_scope(tree, flags, b["T"]):
        assert torch.equal(step(), want)
    # the scope's bound of the flagged rows reaches the wrapper
    with pda.spec_tree_scope(tree, flags, b["T"] + 1):
        with pytest.raises(ValueError, match="tree slot"):
            step()
    assert torch.equal(step(), lin)


# ----------------------------------------------------------- the engines


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    ref = JaxLlama(JaxLlamaConfig.tiny(**TINY))
    ref.eval()
    paddle.seed(11)
    ref_draft = JaxLlama(JaxLlamaConfig.tiny(**dict(TINY, layers=1)))
    ref_draft.eval()
    pair = []
    for m, layers in ((ref, 2), (ref_draft, 1)):
        p = LlamaForCausalLM(LlamaConfig.tiny(**dict(TINY, layers=layers)),
                             device="cpu")
        load_jax_params(p, {k: np.asarray(v)
                            for k, v in m.state_dict().items()})
        pair.append(p)
    return ref, ref_draft, pair[0], pair[1]


def _prompts(n=(2, 9, 1, 13, 4)):
    """Mixed lengths around a repeated motif, so the n-gram drafter finds
    continuations; 21+ tokens at chunk 8 span several chunk ticks."""
    rng = np.random.RandomState(0)
    motif = rng.randint(1, 128, 6).tolist()
    return [motif * 3 + rng.randint(1, 128, k).tolist() for k in n]


SPEC_KEYS = ("spec_tokens_proposed", "spec_tokens_accepted",
             "spec_acceptance_rate", "spec_mean_accepted_len",
             "spec_tree_nodes")


def _serve_jax(model, prompts, max_new, draft=None, heads=None, **kw):
    eng = JaxServingEngine(model, JaxServingConfig(
        **dict(CORE, **kw), enable_prefix_cache=False,
        enable_preemption=False, health=False, async_depth=0),
        draft_model=draft, spec_heads=heads)
    out = eng.serve(prompts, max_new_tokens=max_new)
    st = eng.stats()
    eng.shutdown()
    return out, st


def _serve_port(model, prompts, max_new, draft=None, heads=None,
                stream=None, **kw):
    eng = ServingEngine(model, ServingConfig(
        **dict(CORE, **kw), enable_prefix_cache=False,
        enable_preemption=False), device="cpu", draft_model=draft,
        spec_heads=heads, stream_callback=stream)
    out = eng.serve(prompts, max_new_tokens=max_new)
    st = eng.stats()
    assert st["reserved_blocks"] == 0 and st["active"] == 0
    assert eng.shutdown()
    return out, st


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i} diverged")


def _assert_same_run(want, got):
    _assert_streams_equal(got[0], want[0])
    for k in SPEC_KEYS:
        assert got[1][k] == pytest.approx(want[1][k]), k


RUNS = {
    # slot and block pressure: 2 slots, a pool of 11 blocks, where two of
    # the longer requests (6 blocks each, window included) do not fit
    "ngram": dict(num_speculative_tokens=3, num_blocks=12),
    "ngram_gamma1": dict(num_speculative_tokens=1, spec_ngram_max=2),
    "draft": dict(num_speculative_tokens=3, drafter="model"),
    "self_draft": dict(num_speculative_tokens=4, drafter="model"),
    "chain": dict(num_speculative_tokens=3, spec_tree=(0, 1, 2)),
    # 30 new tokens: the tiny model's greedy streams repeat, so drafts are
    # accepted, off the spine too (the accepted path's K/V moved)
    "branching": dict(num_speculative_tokens=7, spec_tree=BRANCHY),
    "heads": dict(num_speculative_tokens=4, spec_tree=(0, 0, 1, 1),
                  drafter="heads"),
    "ngram_int8": dict(num_speculative_tokens=3, kv_cache_dtype="int8"),
    "tree_int8": dict(num_speculative_tokens=4, spec_tree=(0, 0, 1, 3),
                      kv_cache_dtype="int8"),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_engine_greedy_streams_match_reference(models, run, monkeypatch):
    ref, ref_draft, port, port_draft = models
    kw = RUNS[run]
    jd = {"draft": ref_draft, "self_draft": ref}.get(run)
    pd = {"draft": port_draft, "self_draft": port}.get(run)
    prompts = _prompts()
    new = 30 if run in ("branching", "tree_int8") else 10
    want = _serve_jax(ref, prompts, new, draft=jd, **kw)
    calls = _spy_fused(monkeypatch)
    got = _serve_port(port, prompts, new, draft=pd, **kw)
    _assert_same_run(want, got)
    assert calls["ragged"] > 0
    if pd is not None:
        # the draft loop runs the fused layer on its paged steps, as the
        # reference traces its ragged draft step in its fused scope:
        # gamma + 1 steps a verifying tick, each through every draft layer
        per = (kw["num_speculative_tokens"] + 1) \
            * pd.config.num_hidden_layers
        assert calls["paged"] > 0 and calls["paged"] % per == 0, calls
    else:
        assert calls["paged"] == 0
    if run == "branching":
        assert got[1]["spec_tokens_accepted"] > 10
    if run == "self_draft":
        # the target drafting for itself: every draft is its own greedy
        # token, so windows are accepted whole (up to max_new)
        assert got[1]["spec_mean_accepted_len"] > 2.0


def _spy_fused(monkeypatch):
    """Count ``forward_decode_fused`` calls on the ragged tick and on the
    paged path (the draft loop's steps)."""
    calls = {"paged": 0, "ragged": 0}
    fused = LlamaDecoderLayer.forward_decode_fused

    def spy(self, h, cos, sin, kv_cache, block_tables, cache_lens,
            ragged_meta):
        calls["ragged" if ragged_meta is not None else "paged"] += 1
        return fused(self, h, cos, sin, kv_cache, block_tables, cache_lens,
                     ragged_meta)

    monkeypatch.setattr(LlamaDecoderLayer, "forward_decode_fused", spy)
    return calls


def test_ragged_draft_loop_stays_unfused_with_fused_decode_off(
        models, monkeypatch):
    """``fused_decode=False`` keeps the draft loop (and the tick) on the
    module path; with it on, ``test_engine_greedy_streams_match_reference
    [draft|self_draft]`` sees every draft step fused."""
    port = models[2]
    calls = _spy_fused(monkeypatch)
    _serve_port(port, _prompts((5, 11, 3)), 6, draft=port,
                num_speculative_tokens=3, drafter="model",
                fused_decode=False)
    assert calls == {"paged": 0, "ragged": 0}


def test_chain_tree_engine_equals_linear_engine(models):
    port = models[2]
    prompts = _prompts()
    lin = _serve_port(port, prompts, 10, num_speculative_tokens=3)
    chain = _serve_port(port, prompts, 10, num_speculative_tokens=3,
                        spec_tree=(0, 1, 2))
    _assert_streams_equal(chain[0], lin[0])
    for k in SPEC_KEYS[:-1]:
        assert chain[1][k] == lin[1][k], k
    assert chain[1]["ticks"] == lin[1]["ticks"]
    assert (chain[1]["spec_tree_nodes"], lin[1]["spec_tree_nodes"]) == (4, 0)


def test_heads_given_weights_match_reference(models):
    ref, _, port, _ = models
    rng = np.random.RandomState(3)
    heads = [rng.randn(64, 128).astype(np.float32) for _ in range(2)]
    kw = dict(num_speculative_tokens=3, spec_tree=(0, 0, 1),
              drafter="heads")
    prompts = _prompts()[:3]
    want = _serve_jax(ref, prompts, 8, heads=heads, **kw)
    got = _serve_port(port, prompts, 8, heads=heads, **kw)
    _assert_same_run(want, got)
    # other weights draft other trees: the same tokens (greedy), other
    # proposals
    seeded = _serve_port(port, prompts, 8, **kw)
    _assert_streams_equal(seeded[0], got[0])


def test_seeded_heads_blocked_draw_equals_one_draw():
    """The engine draws its default heads in blocks of 256 rows; at a
    hidden width of three blocks (the last one short) they equal the
    reference's one draw of the whole array, bit for bit."""
    from paddle_tpu_torch.inference.serving import _seeded_heads
    hidden, vocab = 600, 40
    got = _seeded_heads(2, hidden, vocab, "cpu")
    for d in range(2):
        want = np.random.default_rng(0x5EED + d).standard_normal(
            (hidden, vocab)).astype(np.float32) * 0.02
        assert want.dtype == np.float32
        np.testing.assert_array_equal(got[d].numpy(), want)


def test_engine_eos_and_budget_cut_the_window_like_reference(models):
    """A self-drafting engine accepts whole windows, so EOS and the
    token budget fall inside them."""
    ref, _, port, _ = models
    prompts = _prompts()
    kw = dict(num_speculative_tokens=4, drafter="model")
    free = _serve_port(port, prompts, 9, draft=port, **kw)[0]
    eos = int(free[1][3])
    want = _serve_jax(ref, prompts, 9, draft=ref, eos_token_id=eos, **kw)
    got = _serve_port(port, prompts, 9, draft=port, eos_token_id=eos, **kw)
    _assert_same_run(want, got)
    assert got[0][1][-1] == eos and len(got[0][1]) <= 4
    assert all(len(x) <= 9 for x in got[0])


def test_streamed_tokens_equal_returned(models):
    port = models[2]
    seen = {}
    eng = ServingEngine(port, ServingConfig(**CORE,
                                            num_speculative_tokens=7,
                                            spec_tree=BRANCHY),
                        device="cpu",
                        stream_callback=lambda r, t: seen.setdefault(
                            r, []).append(t))
    rids = [eng.submit(p, 10) for p in _prompts()]
    done = eng.run()
    for r in rids:
        assert seen[r] == done[r].tolist()
    assert sum(map(len, seen.values())) == eng.stats()["tokens_total"]
    eng.shutdown()


@pytest.mark.parametrize("run", ["draft", "self_draft", "ngram", "heads"])
def test_dropped_engine_frees_its_pools_without_the_collector(models, run):
    """An engine is in no reference cycle (a drafting engine's draft loop
    closes over the draft model, not the engine): once the caller drops
    it, it and its pools, the draft's too, go at once, with the cyclic
    collector off, so a card's memory comes back without ``gc``."""
    port, port_draft = models[2], models[3]
    eng = ServingEngine(port, ServingConfig(**CORE, **RUNS[run]),
                        device="cpu", draft_model={
                            "draft": port_draft, "self_draft": port}.get(run))
    eng.serve(_prompts(), max_new_tokens=6)
    assert eng.shutdown()
    held = [weakref.ref(eng), weakref.ref(eng._pools[0][0])]
    if eng._dpools is not None:
        held.append(weakref.ref(eng._dpools[0][0]))
    assert len(held) == (3 if "draft" in run else 2)
    gc.collect()
    gc.disable()
    try:
        del eng
        assert [r() is None for r in held] == [True] * len(held)
    finally:
        gc.enable()


def test_sampling_engines_are_seeded_and_counts_consistent(models):
    _, _, port, port_draft = models
    prompts = _prompts()[:3]
    for kw in (dict(num_speculative_tokens=3),
               dict(num_speculative_tokens=3, drafter="model"),
               dict(num_speculative_tokens=4, spec_tree=(0, 0, 1, 1),
                    drafter="heads")):
        draft = port_draft if kw.get("drafter") == "model" else None
        runs = [_serve_port(port, prompts, 8, draft=draft,
                            decode_strategy="sampling", temperature=0.9,
                            top_k=20, seed=5, **kw) for _ in range(2)]
        _assert_streams_equal(runs[0][0], runs[1][0])
        st = runs[0][1]
        assert 0 <= st["spec_tokens_accepted"] <= st["spec_tokens_proposed"]
        verifies = st["spec_tokens_proposed"] // kw["num_speculative_tokens"]
        emitted = st["tokens_total"] - len(prompts)   # first tokens aside
        assert st["spec_mean_accepted_len"] == pytest.approx(
            emitted / verifies)
        assert emitted <= verifies + st["spec_tokens_accepted"]
        for out in runs[0][0]:
            assert len(out) == 8 and out.min() >= 0 and out.max() < 128
    # per-request knobs: top_k 1 is greedy, whatever the drafter
    greedy = _serve_port(port, prompts, 8, num_speculative_tokens=3)[0]
    eng = ServingEngine(port, ServingConfig(
        **CORE, num_speculative_tokens=3, decode_strategy="sampling",
        temperature=1.3, seed=2), device="cpu")
    rids = [eng.submit(p, 8, top_k=1) for p in prompts]
    done = eng.run()
    _assert_streams_equal([done[r] for r in rids], greedy)


@pytest.mark.parametrize("kw,err,match", [
    (dict(num_speculative_tokens=-1), ValueError, "num_speculative"),
    (dict(num_speculative_tokens=2, spec_tree=(0,)), ValueError,
     "non-root nodes"),
    (dict(num_speculative_tokens=0, spec_tree=()), ValueError,
     "non-root nodes"),
    (dict(num_speculative_tokens=2, spec_tree=(0, 2)), ValueError,
     "parent"),
    (dict(num_speculative_tokens=32, spec_tree=tuple(range(32))),
     ValueError, "31 draft nodes"),
    (dict(num_speculative_tokens=2, spec_tree=(0, 0), drafter="model"),
     ValueError, "one chain"),
    (dict(num_speculative_tokens=2, drafter="heads"), ValueError,
     "requires spec_tree"),
    (dict(num_speculative_tokens=2, drafter="beam"), ValueError,
     "drafter"),
])
def test_config_refusals_match_reference(models, kw, err, match):
    ref = models[0]
    with pytest.raises(err):
        JaxServingEngine(ref, JaxServingConfig(**CORE, **kw))
    with pytest.raises(err, match=match):
        ServingConfig(**CORE, **kw)


def test_engine_refusals_match_reference(models):
    ref, ref_draft, port, port_draft = models
    cases = [
        # a draft model without drafter='model', or without speculation
        (dict(num_speculative_tokens=2), dict(draft=True), ValueError,
         "draft_model requires"),
        (dict(), dict(draft=True), ValueError, "draft_model requires"),
        (dict(num_speculative_tokens=2, drafter="model"), {}, ValueError,
         "requires a draft_model"),
        (dict(num_speculative_tokens=2), dict(heads=True), ValueError,
         "spec_heads requires"),
        (dict(num_speculative_tokens=2, spec_tree=(0, 0), drafter="heads"),
         dict(heads="bad"), ValueError, "spec_heads must be"),
        (dict(num_speculative_tokens=4, max_model_len=2046), {}, ValueError,
         "speculative window"),
    ]
    for kw, extra, err, match in cases:
        heads = extra.get("heads")
        jh = th = None
        if heads is True:
            jh = th = [np.zeros((64, 128), np.float32)]
        elif heads == "bad":
            jh = th = [np.zeros((64, 127), np.float32)]
        with pytest.raises(err):
            JaxServingEngine(ref, JaxServingConfig(**dict(CORE, **kw)),
                             draft_model=ref_draft if extra.get("draft")
                             else None, spec_heads=jh)
        with pytest.raises(err, match=match):
            ServingEngine(port, ServingConfig(**dict(CORE, **kw)),
                          device="cpu",
                          draft_model=port_draft if extra.get("draft")
                          else None, spec_heads=th)
    # a draft model of another vocabulary cannot draft
    other = LlamaForCausalLM(LlamaConfig.tiny(**dict(TINY, vocab=256)),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="vocab"):
        ServingEngine(port, ServingConfig(**CORE, num_speculative_tokens=2,
                                          drafter="model"),
                      device="cpu", draft_model=other)


def test_later_slices_stay_refused(models):
    port = models[2]
    for kw in (dict(tp_degree=2), dict(role="decode")):
        with pytest.raises(NotImplementedError, match="later slice"):
            ServingConfig(**CORE, num_speculative_tokens=2, **kw)
    # the per-width speculative engine is ported: it builds and serves
    # (held against the reference in tests/test_torch_per_width.py)
    pw = ServingEngine(port, ServingConfig(**CORE, num_speculative_tokens=2,
                                           ragged_batch=False),
                       device="cpu")
    assert pw.stats()["ragged_batch"] is False
    pw.shutdown()
    eng = ServingEngine(port, ServingConfig(**CORE,
                                            num_speculative_tokens=2),
                        device="cpu")
    st = eng.stats()
    with pytest.raises(KeyError):
        st["no_such_key"]
    # the digest of tokens a verify window is ported: zeroed before any
    assert st["spec_accept_len"]["count"] == 0 and st["spec_tree_nodes"] == 0
    eng.shutdown()
