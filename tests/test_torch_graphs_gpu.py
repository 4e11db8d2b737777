"""The serving engine's and ``generate()``'s CUDA graphs, and the async
pipeline, on the card. Every test here needs a CUDA device and skips
itself without one (a graph has no CPU mode). The file imports neither
``jax`` nor ``paddle_tpu``:

    python -m pytest --noconftest -q tests/test_torch_graphs_gpu.py

Each tick kind (decode, linear verify, tree verify, draft heads, the
model drafting for itself; decode and verify also sampling, whose graphs
register the engine's generator) on bfloat16, int8 and float32 pools (GPT's,
under a bfloat16 model), and a DeepSeek-MoE engine, is served by two
engines in lockstep with staggered admissions
(``chip_smoke.graph_lockstep``): one replays every tick from CUDA graphs,
the other runs every tick eagerly at the same widths (ticks with prefill
rows at the static width); each tick's tokens, logits and added launch
counts, and the pools at the end, must be equal to the bit, and both a
pure tick's graph and a mixed tick's must replay. A second wave of the
same traffic captures no further graph; a graph captured before a larger
capture on the same stream grew the kernels' per-stream scratch still
replays to the bit; ``async_depth=1`` streams what ``async_depth=0``
does. Ticks replayed after a prefix hit's copy-on-write and a swap
resume's import read the blocks those wrote in place, and prefix-hit
ticks replay graphs already captured. ``generate()``'s paged, n-gram,
self-drafted and tree runs, greedy and sampling, replay their steps from
graphs and equal the eager steps (the model's ``cuda_graphs`` off) bit
for bit. A LoRA engine's replays equal its eager ticks across a hot
reload mid-run, adapter churn through two resident rows captures no graph
(as many as a LoRA-off engine on the same traffic), and a reload between
two runs is read by the second run's replays. The telemetry: the
non-finite probe fires inside captured ticks and adds no graph,
``kernel_census()`` counts each captured graph's nodes and names the
hand-written kernels, and tracing and health on or off stream the same
tokens under ``async_depth=1``. The per-width engine
(``ragged_batch=False``; ``chip_smoke.per_width_lockstep``) replays each
of its steps (decode, verify, the chunk step and its draft twin, the
draft loop, the bucketed prefill's buckets) equal to its eager run on
the three pools, and its replays read the blocks a copy-on-write and a
swap resume wrote. AMP's ``GradScaler`` refuses to run inside a capture."""
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import graph_lockstep, lockstep, per_width_lockstep
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.models import (DeepseekMoeConfig,
                                     DeepseekMoeForCausalLM, GPTConfig,
                                     GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.ops import cuda_graphs, kernels

CORE = dict(num_slots=4, block_size=16, max_model_len=256, prefill_chunk=32)
KINDS = {"decode": {},
         "verify": dict(num_speculative_tokens=2),
         "tree": dict(num_speculative_tokens=3, spec_tree=(0, 0, 1)),
         "heads": dict(num_speculative_tokens=3, spec_tree=(0, 0, 1),
                       drafter="heads"),
         "self_draft": dict(num_speculative_tokens=2, drafter="model"),
         "sampling": dict(decode_strategy="sampling", temperature=0.9,
                          top_k=20, seed=4),
         "verify_sampling": dict(num_speculative_tokens=2,
                                 decode_strategy="sampling", top_p=0.9,
                                 seed=4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _model(pool):
    """A tiny bf16 model whose pools are ``pool``: Llama (bf16 or int8
    pools) or GPT (float32 pools under a bf16 model)."""
    if pool == "float32":
        m = GPTForCausalLM(GPTConfig.tiny(vocab=512, hidden=256, heads=4),
                           device="cuda", seed=3).to(torch.bfloat16)
    else:
        cfg = LlamaConfig.tiny(vocab=512, hidden=256, heads=4, kv_heads=2,
                               ffn=512)
        cfg.dtype = "bfloat16"
        m = LlamaForCausalLM(cfg, device="cuda", seed=3)
    return m.eval()


def _prompts(vocab, lens=(40, 9, 70, 20, 33), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=n) for n in lens]


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_replay_equals_eager_tick(cuda, kind, pool):
    model = _model(pool)
    kw = dict(CORE, **KINDS[kind])
    if pool == "int8":
        kw["kv_cache_dtype"] = "int8"
    st = graph_lockstep(
        torch, kernels, ServingEngine, model, ServingConfig(**kw),
        _prompts(model.config.vocab_size), 12, f"{kind} {pool}",
        draft=model if kind == "self_draft" else None)
    # one graph a seated count (pure), one a verifying count (mixed)
    assert st["pure_graphs"] <= CORE["num_slots"]
    assert st["mixed_graphs"] <= (CORE["num_slots"] if "num_speculative_"
                                  "tokens" in KINDS[kind] else 1)


@pytest.mark.gpu
def test_moe_replay_equals_eager_tick(cuda):
    cfg = DeepseekMoeConfig.tiny(vocab=512, hidden=256, heads=4,
                                 kv_heads=4)
    cfg.dtype, cfg.dropless = "bfloat16", True
    model = DeepseekMoeForCausalLM(cfg, device="cuda", seed=5).eval()
    for depth in (0, 1):
        st = graph_lockstep(
            torch, kernels, ServingEngine, model,
            ServingConfig(**CORE, async_depth=depth), _prompts(512), 10,
            f"moe async {depth}")
        assert st["moe_dispatches"] > 0


@pytest.mark.gpu
def test_second_wave_captures_nothing(cuda):
    model = _model("bfloat16")
    eng = ServingEngine(model, ServingConfig(**CORE, async_depth=1))
    eng.serve(_prompts(512), 10)
    n = eng.stats()["executables_compiled"]
    pure = eng.stats()["pure_ticks"]
    eng.serve(_prompts(512, seed=1), 10)
    st = eng.stats()
    assert n >= 1 and st["executables_compiled"] == n
    assert st["pure_ticks"] > pure and st["pipelined_ticks"] > 0
    eng.shutdown()


@pytest.mark.gpu
def test_scratch_outlives_a_larger_capture(cuda):
    """One slot decodes alone (a pure graph for one seated slot), a
    second joins (its prefill replays the mixed graph; its warm-up of two
    seated slots grows K3's per-stream scratch on the capture stream, its
    capture takes the larger one), then the first leaves and the
    one-slot graph replays: it still writes the scratch it was captured
    with, which is held by it."""
    model = _model("bfloat16")
    cfg = ServingConfig(**dict(CORE, num_slots=2))
    short, long_ = _prompts(512)[1], _prompts(512)[0]
    eng = ServingEngine(model, cfg)
    rid0 = eng.submit(short, 6)
    while not any(lay.pure for lay in eng._graphs):
        eng.step()
    g1 = next(g for lay, g in eng._graphs.items() if lay.pure)
    held = [(t, t.data_ptr()) for t in g1.step.scratch]
    assert held
    joined = eng.stats()["ticks"]
    rid1 = eng.submit(long_, 20)
    done = eng.run()
    # the mixed graph and two pure ones
    assert eng.stats()["executables_compiled"] == 3
    assert all(t.data_ptr() == p for t, p in held)
    # the same schedule, every tick eager
    ref = ServingEngine(model, cfg)
    ref.cuda_graphs = False
    r0 = ref.submit(short, 6)
    while ref.stats()["ticks"] < joined:
        ref.step()
    r1 = ref.submit(long_, 20)
    want = ref.run()
    np.testing.assert_array_equal(done[rid0], want[r0])
    np.testing.assert_array_equal(done[rid1], want[r1])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_async_on_equals_off(cuda, kind):
    model = _model("bfloat16")
    outs = []
    for depth in (0, 1):
        eng = ServingEngine(model, ServingConfig(
            **CORE, **KINDS[kind], async_depth=depth))
        outs.append(eng.serve(_prompts(512), 12))
        st = eng.stats()
        eng.shutdown()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    if kind == "decode":
        assert st["pipelined_ticks"] > 0


def _waves_lockstep(model, cfg, waves):
    """Two engines of ``cfg``, one replaying its ticks from CUDA graphs
    and one running them eagerly, stepped in lockstep over ``waves`` (a
    wave starts when both engines drained the last one; each entry is
    ``(tick, prompt, max_new, priority)``, the tick counted from the
    wave's start): every tick both must commit the same tokens and give
    the same logits to the bit. Returns the graph engine, its graph count
    after each wave and its pools' storage pointers from before the
    first tick."""
    engines = []
    for graphs in (True, False):
        e = ServingEngine(model, cfg)
        e.cuda_graphs = graphs
        engines.append(e)
    ptrs = [t.data_ptr() for t in _pool_tensors(engines[0]._pools)]
    counts = []
    for wave in waves:
        todo = sorted(wave, key=lambda w: w[0])
        tick = 0
        while todo or any(e.num_active or e.num_queued for e in engines):
            while todo and todo[0][0] <= tick:
                _, p, new, prio = todo.pop(0)
                for e in engines:
                    e.submit(p, new, priority=prio)
            seen = []
            for e in engines:
                emitted = e.step()
                torch.cuda.synchronize()
                lg = None if e.last_logits is None else e.last_logits.clone()
                seen.append((emitted, lg))
            (em_g, lg_g), (em_e, lg_e) = seen
            assert em_g == em_e, f"tick {tick}: {em_g} vs {em_e}"
            assert lg_g is None or torch.equal(lg_g, lg_e), f"tick {tick}"
            tick += 1
        counts.append(engines[0].stats()["executables_compiled"])
    results = [e.run() for e in engines]
    assert {r: list(t) for r, t in results[0].items()} == \
        {r: list(t) for r, t in results[1].items()}
    for a, b in zip(_pool_tensors(engines[0]._pools),
                    _pool_tensors(engines[1]._pools)):
        assert torch.equal(a[1:], b[1:])
    return engines[0], counts, ptrs


def _pool_tensors(pools):
    for pair in pools:
        for p in pair:
            yield from ((p.data, p.scale) if hasattr(p, "scale") else (p,))


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "int8", "float32"])
def test_replays_read_the_blocks_a_copy_and_a_swap_wrote(cuda, pool):
    """A full-prompt prefix hit copies its shared block (COW), then two
    high-priority arrivals preempt it and it resumes by importing its
    blocks from the host tier (swap): both write the pools in place, so
    the ticks replayed from graphs afterwards read those blocks, and
    every tick equals the eager engine's; the pools keep their
    storage."""
    model = _model(pool)
    kw = dict(CORE, num_slots=2, preempt_resume="swap")
    if pool == "int8":
        kw["kv_cache_dtype"] = "int8"
    p = _prompts(model.config.vocab_size, lens=(64, 20, 30), seed=2)
    eng, _, ptrs = _waves_lockstep(
        model, ServingConfig(**kw),
        [[(0, p[0], 8, 0)],
         [(0, p[0], 40, 0), (6, p[1], 10, 2), (6, p[2], 10, 2)]])
    st = eng.stats()
    assert st["cow_copies"] >= 1 and st["prefix_tokens_reused"] >= 63
    assert st["preemptions"] >= 1 and st["preempt_swap_resumes"] >= 1
    assert st["kv_blocks_restored"] >= 1
    assert [t.data_ptr() for t in _pool_tensors(eng._pools)] == ptrs
    eng.shutdown()


@pytest.mark.gpu
def test_prefix_hit_ticks_replay_captured_graphs(cuda):
    """The same two prompts served again hit the prefix cache (one row
    of each prefilled, its block copied): those ticks replay the graphs
    the first wave captured, so the graph count does not grow, and every
    tick equals the eager engine's."""
    model = _model("bfloat16")
    p = _prompts(model.config.vocab_size, lens=(48, 48), seed=3)
    wave = [(0, p[0], 10, 0), (0, p[1], 10, 0)]
    eng, counts, _ = _waves_lockstep(
        model, ServingConfig(**dict(CORE, num_slots=2)), [wave, wave])
    st = eng.stats()
    assert counts[0] >= 2 and counts[1] == counts[0]
    assert st["cow_copies"] == 2 and st["prefix_tokens_reused"] == 94
    eng.shutdown()


@pytest.mark.gpu
def test_capture_survives_a_collected_engine(cuda):
    """A dropped engine held in a reference cycle is freed by the cyclic
    collector, destroying its graphs, whenever the collector runs. It
    does not run inside a capture (a graph destroyed mid-capture
    invalidates it): with the collector run at nearly every allocation,
    a new engine still captures and replays."""
    import gc
    model = _model("bfloat16")
    prompts = _prompts(512, lens=(40, 9))
    old = ServingEngine(model, ServingConfig(**CORE))
    old.serve(prompts, 6)
    assert old.stats()["executables_compiled"] >= 2
    old.cycle = old                     # only the collector frees it
    del old
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        eng = ServingEngine(model, ServingConfig(**CORE))
        got = eng.serve(prompts, 6)
    finally:
        gc.set_threshold(*threshold)
    assert eng.stats()["executables_compiled"] >= 2
    ref = ServingEngine(model, ServingConfig(**CORE))
    ref.cuda_graphs = False
    for a, b in zip(got, ref.serve(prompts, 6)):
        np.testing.assert_array_equal(a, b)


GENERATE = {"paged": dict(cache_impl="paged"),
            "ngram": dict(num_speculative_tokens=3),
            "self_draft": dict(num_speculative_tokens=3),
            "tree": dict(num_speculative_tokens=3, spec_tree=(0, 0, 1)),
            "paged_sampling": dict(cache_impl="paged",
                                   decode_strategy="sampling",
                                   temperature=0.9, top_k=20, seed=5),
            "ngram_sampling": dict(num_speculative_tokens=3,
                                   decode_strategy="sampling", top_p=0.9,
                                   seed=5)}


def _motif_ids(vocab, b=2, n=48, seed=2):
    """Prompts with a repeated run, so prompt lookup finds drafts."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, (b, n))
    ids[:, 30:38] = ids[:, 4:12]
    return ids


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("kind", list(GENERATE))
def test_generate_graph_equals_eager(cuda, kind, pool):
    """generate() with its steps replayed from CUDA graphs equals the
    same run with every step eager: tokens, scores (bit for bit) and the
    launch counts; the graphed run captured exactly one graph."""
    model = _model(pool)
    kw = dict(GENERATE[kind], max_new_tokens=14)
    if pool == "int8":
        kw["kv_cache_dtype"] = "int8"
    if kind == "self_draft":
        kw["draft_model"] = model
    ids = _motif_ids(model.config.vocab_size)
    got = []
    for graphs in (True, False):
        model.cuda_graphs = graphs
        c0 = dict(kernels.launch_counts)
        with mock.patch.object(cuda_graphs, "capture",
                               wraps=cuda_graphs.capture) as cap:
            out, scores = model.generate(ids, **kw)
        torch.cuda.synchronize()
        added = {k: v - c0[k] for k, v in kernels.launch_counts.items()
                 if v != c0[k]}
        got.append((out, scores, added, cap.call_count))
    (o_g, s_g, n_g, c_g), (o_e, s_e, n_e, c_e) = got
    assert (c_g, c_e) == (1, 0)
    assert torch.equal(o_g, o_e) and torch.equal(s_g, s_e)
    assert n_g == n_e and sum(n_g.values()) > 0


@pytest.mark.gpu
def test_generate_eos_graph_equals_eager(cuda):
    """An EOS that every row emits within the run: the graphed loop (the
    all-done flag read one step late) gives the eager loop's tokens and
    scores, pads after the EOS, and runs at most one more step."""
    model = _model("bfloat16")
    ids = _motif_ids(model.config.vocab_size)
    base, _ = model.generate(ids, max_new_tokens=12, cache_impl="paged")
    eos = int(base[0, 3])
    got = []
    for graphs in (True, False):
        model.cuda_graphs = graphs
        c0 = kernels.launch_counts["paged_decode_attention"]
        out, sc = model.generate(ids, max_new_tokens=12, cache_impl="paged",
                                 eos_token_id=eos)
        got.append((out, sc,
                    kernels.launch_counts["paged_decode_attention"] - c0))
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])
    assert got[0][2] == got[1][2]
    first = int(torch.argmax((got[0][0][0] == eos).int()))
    assert first <= 3 and (got[0][0][0, first + 1:] == eos).all()


LORA_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
LORA_ALL = LORA_ATTN + ("gate_proj", "up_proj", "down_proj")


def _lora_weights(model, aid, names=LORA_ATTN, rank=4):
    """Adapter ``aid``'s leaf-name weights at ``model``'s widths, N(0,
    0.3), for the target modules ``names``."""
    widths = {q.rsplit(".", 1)[-1]: tuple(m.weight.shape)
              for q, m in model.named_modules()
              if q.rsplit(".", 1)[-1] in names}
    rng = np.random.RandomState(100 + aid)
    return {n: (rng.normal(0, 0.3, (d, rank)).astype(np.float32),
                rng.normal(0, 0.3, (rank, o)).astype(np.float32))
            for n, (d, o) in widths.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("targets", ["attn", "all"])
def test_lora_replay_equals_eager_tick(cuda, targets):
    """A LoRA engine's ticks (adapters 1 and 2 and base riders, rank 4 in
    stacks of 8) replayed from graphs equal the eager ticks bit for bit,
    across a hot reload of adapter 1 mid-run: the replays read the rows
    the reload wrote in place."""
    model = _model("bfloat16")
    names = LORA_ATTN if targets == "attn" else LORA_ALL
    weights = {aid: _lora_weights(model, aid, names) for aid in (1, 2)}

    def reload(e, tick):
        if tick == 7:
            e.load_adapter(1, weights[2])
    st = graph_lockstep(
        torch, kernels, ServingEngine, model,
        ServingConfig(**CORE, lora_rank=4, max_adapters=2,
                      lora_targets=targets),
        _prompts(model.config.vocab_size), 12, f"lora {targets}",
        adapters=(weights, (1, None, 2, 1, 2)), on_tick=reload)
    assert st["lora_adapters_resident"] == 2
    assert st["kernel_launches"]["lora_gmm"] > 0


@pytest.mark.gpu
def test_lora_churn_captures_no_graph(cuda):
    """Four adapters through two resident rows: a second wave of the same
    prompts under adapters 3 and 4 swaps both rows and captures no graph;
    a LoRA-off engine on the same traffic captures as many."""
    model = _model("bfloat16")
    prompts = _prompts(model.config.vocab_size)
    eng = ServingEngine(model, ServingConfig(**CORE, lora_rank=4,
                                             max_adapters=2))
    base = ServingEngine(model, ServingConfig(**CORE))
    for aid in (1, 2, 3, 4):
        eng.load_adapter(aid, _lora_weights(model, aid))
    graphs = []
    for wave in ((1, 2, None), (3, 4, None)):
        for e in (eng, base):
            e.purge_published()
            for k, p in enumerate(prompts):
                e.submit(p, 10, adapter_id=wave[k % 3] if e is eng
                         else None)
            e.run()
        graphs.append((eng.stats()["executables_compiled"],
                       base.stats()["executables_compiled"]))
    assert graphs[0][0] >= 1 and graphs[0] == graphs[1] \
        and graphs[0][0] == graphs[0][1]
    assert eng.stats()["lora_adapter_swaps"] >= 2
    eng.shutdown()
    base.shutdown()


@pytest.mark.gpu
def test_lora_hot_reload_is_read_by_the_replays(cuda):
    """A resident adapter reloaded between two runs of one request: the
    second run replays the graphs the first captured, its tokens differ
    from the first's and equal an eager engine's under the new weights."""
    model = _model("bfloat16")
    (p,) = _prompts(model.config.vocab_size, lens=(40,))
    new = _lora_weights(model, 9)

    def engine(graphs):
        e = ServingEngine(model, ServingConfig(**CORE, lora_rank=4))
        e.cuda_graphs = graphs
        e.load_adapter(1, _lora_weights(model, 1))
        return e

    eng = engine(True)
    rid = eng.submit(p, 12, adapter_id=1)
    first = eng.run()[rid]
    n = eng.stats()["executables_compiled"]
    assert eng.adapter_resident(1)
    eng.load_adapter(1, new)
    rid = eng.submit(p, 12, adapter_id=1)
    second = eng.run()[rid]
    assert eng.stats()["executables_compiled"] == n
    eager = engine(False)
    eager.load_adapter(1, new)
    rid = eager.submit(p, 12, adapter_id=1)
    np.testing.assert_array_equal(second, eager.run()[rid])
    assert not np.array_equal(first, second)
    eng.shutdown()
    eager.shutdown()


def _f32_model():
    cfg = LlamaConfig.tiny(vocab=512, hidden=256, heads=4, kv_heads=2,
                           ffn=512)
    return LlamaForCausalLM(cfg, device="cuda", seed=3).eval()


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [0, 1])
def test_nonfinite_probe_fires_inside_captured_ticks(cuda, depth):
    """An LM-head column set to inf poisons every tick's logits: the
    probe inside the captured ticks flags them, the page alert fires,
    and the engine captures the graphs a clean one does, no more."""
    model = _f32_model()
    prompts = _prompts(512, lens=(30, 9))

    def serve():
        eng = ServingEngine(model, ServingConfig(**CORE, async_depth=depth))
        eng.serve(prompts, 8)
        return eng, eng.stats()

    clean, st0 = serve()
    assert st0["nonfinite_logits_ticks"] == 0
    assert clean.health()["alerts_firing"] == []
    with torch.no_grad():
        model.lm_head.weight[:, 7] = float("inf")
    eng, st = serve()
    assert st["nonfinite_logits_ticks"] > 0
    assert "nonfinite_logits" in eng.health()["alerts_firing"]
    assert st["executables_compiled"] == st0["executables_compiled"] >= 2
    clean.shutdown()
    eng.shutdown(check_leaks=False)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "float32"])
def test_kernel_census_counts_graph_nodes_and_names_the_kernels(cuda,
                                                                 pool):
    """Every captured layout's census: its graph's kernel nodes (each
    one of the node types), the hand-written kernels' launches a replay
    adds (as its capture recorded them), K3a / K3b / K2r among them and
    among the kernel nodes by symbol; and the layout's counted work in
    the roofline, with a measured time once it replayed."""
    model = _model(pool)
    layers = model.config.num_hidden_layers
    eng = ServingEngine(model, ServingConfig(**CORE))
    eng.serve(_prompts(model.config.vocab_size), 10)
    census = eng.kernel_census()
    st = eng.stats()
    assert len(census) == st["executables_compiled"] >= 2
    steps = {lay.name(0): gr.step for lay, gr in eng._graphs.items()}
    rpa = "ragged_paged_attention" + ("_f32pool" if pool == "float32"
                                      else "")
    for name, c in census.items():
        assert c["kernel_nodes"] == c["graph_nodes"]["kernel"] > 0
        assert sum(c["graph_nodes"].values()) >= c["kernel_nodes"]
        assert c["kernels"] == {k: v for k, v in steps[name].counts.items()
                                if k != "moe_calls"}
        assert c["kernels"]["norm_matmul"] == 2 * layers
        assert c["kernels"]["matmul_residual"] == 2 * layers
        assert c["kernels"][rpa] == layers
        assert c["launch_proxy"] >= sum(c["kernels"].values())
        names = " ".join(c.get("kernel_names", {}))
        if "kernel_names" in c:
            assert sum(c["kernel_names"].values()) == c["kernel_nodes"]
            assert "decode_gemm" in names and "paged_attention" in names
    roof = st["roofline"]
    assert roof["cpu_proxy"] is False
    assert set(roof["per_executable"]) == set(census)
    for row in roof["per_executable"].values():
        assert row["flops"] > 0 and row["bytes_accessed"] > 0
    assert any(r["ticks"] > 0 and r["mfu"] > 0 and r["hbm_bw_util"] > 0
               for r in roof["per_executable"].values())
    assert st["kernels_per_tick"] > 0
    eng.shutdown()


@pytest.mark.gpu
def test_telemetry_on_and_off_stream_equal_under_async(cuda, monkeypatch):
    """Tracing and health on (the defaults) against both off, under
    ``async_depth=1``: the same streams bit for bit and the same graphs
    in number; the tracer saw the pipelined dispatches."""
    model = _model("bfloat16")
    prompts = _prompts(512)

    def serve(on):
        if not on:
            monkeypatch.setenv("PADDLE_TPU_TRACE", "0")
        eng = ServingEngine(model, ServingConfig(**CORE, async_depth=1,
                                                 health=on))
        monkeypatch.delenv("PADDLE_TPU_TRACE", raising=False)
        out = eng.serve(prompts, 12)
        st = eng.stats()
        names = {e["name"] for e in eng.tracer.events()} if on else set()
        eng.shutdown()
        return out, st, names

    a, st_on, names = serve(True)
    b, st_off, _ = serve(False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert st_on["executables_compiled"] == st_off["executables_compiled"]
    assert st_on["tracing"] and not st_off["tracing"]
    assert st_off["trace_events"] == 0 and st_on["pipelined_ticks"] > 0
    assert "pipelined dispatch" in names and "decode tick" in names


PER_WIDTH = {"decode": (dict(ragged_batch=False), ("decode", "chunk")),
             "interleaved": (dict(ragged_batch=False,
                                  max_prefill_chunks_per_step=1),
                             ("decode", "chunk")),
             "bucketed": (dict(ragged_batch=False, chunked_prefill=False,
                               min_prefill_bucket=16), ("decode",)),
             "verify": (dict(ragged_batch=False, num_speculative_tokens=2),
                        ("verify", "chunk")),
             "self_draft": (dict(ragged_batch=False,
                                 num_speculative_tokens=2, drafter="model"),
                            ("draft", "verify", "chunk", "draft_chunk")),
             "sampling": (dict(ragged_batch=False,
                               decode_strategy="sampling", temperature=0.9,
                               top_k=20, seed=4), ("decode", "chunk"))}


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("kind", list(PER_WIDTH))
def test_per_width_replay_equals_eager(cuda, kind, pool):
    """Each per-width step replayed from its graph equals its eager run
    (tokens, launches, decode logits, pools), over bf16, int8 and float32
    pools; every step the engine ran was captured once."""
    model = _model(pool)
    kw, steps = PER_WIDTH[kind]
    kw = dict(CORE, **kw)
    if pool == "int8":
        kw["kv_cache_dtype"] = "int8"
    st = per_width_lockstep(
        torch, kernels, ServingEngine, model, ServingConfig(**kw),
        _prompts(model.config.vocab_size), 12, f"per-width {kind} {pool}",
        draft=model if kind == "self_draft" else None)
    assert set(steps) <= set(st["graphs"]), st["graphs"]
    if kind == "bucketed":
        assert any(g.startswith("prefill") for g in st["graphs"])
        assert st["prefill_compiles"] == sum(
            g.startswith("prefill") for g in st["graphs"])


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "int8", "float32"])
def test_ragged_bucketed_replay_equals_eager(cuda, pool):
    """The ragged engine with chunked_prefill=False: each prompt bucket's
    prefill step, captured into the pool the tick layouts share, and the
    pure ticks replay equal to the eager engine's (tokens, launches,
    logits, pools), prompts admitted between replayed ticks."""
    model = _model(pool)
    kw = dict(CORE, chunked_prefill=False, min_prefill_bucket=16)
    if pool == "int8":
        kw["kv_cache_dtype"] = "int8"
    eng, eager = lockstep(
        torch, kernels, ServingEngine, model, ServingConfig(**kw),
        _prompts(model.config.vocab_size), 12, f"ragged bucketed {pool}")
    st = eng.stats()
    buckets = {n for n, s in eng._pw.items() if s.graph is not None}
    assert buckets == {"prefill16", "prefill32", "prefill64",
                       "prefill128"}, buckets
    assert st["prefill_compiles"] == len(buckets)
    assert eng._graphs and all(lay.pure for lay in eng._graphs)
    assert st["pure_ticks"] > len(eng._graphs)
    assert st["prefix_cache_enabled"] is False
    for e in (eng, eager):
        e.shutdown()


@pytest.mark.gpu
def test_per_width_launches_k3_around_k2(cuda):
    """The per-width decode step launches K3a / K3b twice a layer around
    K2d, the verify step around K2v at gamma + 1, the chunk step around
    K2v at T = prefill_chunk; generate()'s paged steps launch no K3."""
    model = _model("bfloat16")
    n_layers = model.config.num_hidden_layers
    for kw, k2 in ((dict(), "paged_decode_attention"),
                   (dict(num_speculative_tokens=2),
                    "paged_verify_attention")):
        eng = ServingEngine(model, ServingConfig(**CORE, ragged_batch=False,
                                                 **kw))
        eng.submit(_prompts(512, lens=(20,))[0], 6)
        eng.step()                      # admission: the chunk steps
        kernels.reset_launch_counts()
        eng.step()
        got = {k: v for k, v in kernels.launch_counts.items() if v}
        assert got == {"norm_matmul": 2 * n_layers,
                       "matmul_residual": 2 * n_layers, k2: n_layers}, got
        eng.shutdown()
    ids = torch.from_numpy(_prompts(512, lens=(20,))[0][None]).cuda()
    kernels.reset_launch_counts()
    model.generate(ids, max_new_tokens=4, cache_impl="paged")
    assert kernels.launch_counts["norm_matmul"] == 0
    assert kernels.launch_counts["paged_decode_attention"] > 0


@pytest.mark.gpu
def test_ragged_draft_loop_launches_k3_around_k2d(cuda):
    """The ragged engine's draft loop runs the fused layer: a pure
    verifying tick of a self-drafted engine launches the target's K3a /
    K3b pairs and, for each of the draft loop's gamma + 1 K2d steps, one
    more pair a layer (replayed from the tick's graph)."""
    model = _model("bfloat16")
    n_layers = model.config.num_hidden_layers
    g = 2
    eng = ServingEngine(model, ServingConfig(
        **CORE, num_speculative_tokens=g, drafter="model"),
        draft_model=model)
    eng.submit(_prompts(512, lens=(20,))[0], 12)
    eng.step()                          # admission: prefill and the prime
    for _ in range(2):                  # the first pure tick is captured,
        kernels.reset_launch_counts()   # the second replays
        eng.step()
        got = {k: v for k, v in kernels.launch_counts.items() if v}
        assert got == {"norm_matmul": 2 * n_layers * (g + 2),
                       "matmul_residual": 2 * n_layers * (g + 2),
                       "paged_decode_attention": n_layers * (g + 1),
                       "ragged_paged_attention": n_layers}, got
    eng.shutdown()


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "int8", "float32"])
def test_per_width_replays_read_copied_and_swapped_blocks(cuda, pool):
    """The per-width engine's twin of
    test_replays_read_the_blocks_a_copy_and_a_swap_wrote: a full-prompt
    prefix hit copies its shared block, a preemption resumes by swap, and
    the decode steps replayed afterwards equal the eager engine's to the
    bit; the pools keep their storage."""
    model = _model(pool)
    kw = dict(CORE, num_slots=2, preempt_resume="swap", ragged_batch=False)
    if pool == "int8":
        kw["kv_cache_dtype"] = "int8"
    p = _prompts(model.config.vocab_size, lens=(64, 20, 30), seed=2)
    eng, _, ptrs = _waves_lockstep(
        model, ServingConfig(**kw),
        [[(0, p[0], 8, 0)],
         [(0, p[0], 40, 0), (6, p[1], 10, 2), (6, p[2], 10, 2)]])
    st = eng.stats()
    assert st["cow_copies"] >= 1 and st["prefix_tokens_reused"] >= 63
    assert st["preemptions"] >= 1 and st["preempt_swap_resumes"] >= 1
    assert [t.data_ptr() for t in _pool_tensors(eng._pools)] == ptrs
    eng.shutdown()


@pytest.mark.gpu
def test_grad_scaler_refuses_a_graph_capture(cuda):
    """``GradScaler`` reads its found-inf flag back, which no captured
    graph may do: inside a capture it raises."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import SGD
    p = torch.nn.Parameter(torch.ones(4, device="cuda"))
    p.grad = torch.ones(4, device="cuda")
    scaler = amp.GradScaler()
    opt = SGD(0.1, parameters=[p])
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with pytest.raises(RuntimeError, match="CUDA graph capture"):
            with torch.cuda.graph(graph, stream=stream):
                scaler.unscale_(opt)
