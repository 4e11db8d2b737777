"""The port's metrics registry, cost accounting and the serving engine's
registry and ``stats()`` telemetry, against the JAX package on the CPU.

Pure host code first: the two registries fed the same seeded operations
give equal samples, Prometheus text, text tables and JSONL rows (less the
timestamp); ``MOE_STATS`` is served by the registry as the reference's;
the cost recorder counts aten FLOPs by ``torch.utils.flop_counter``'s
formulas and each hand-written kernel by the work its wrapper declares.
Then the engines: a tiny Llama served by the port and by the reference
engine through the same lifecycle wave (staggered admissions, two
priority arrivals preempting a running request, a rejected submit, a
cancel in the queue and in flight, a shutdown with requests queued), and
an n-gram speculative wave, give the same tokens, every ``stats()`` key
of the reference's with equal counts, and equal counter and histogram
counts in their registries (timings and the compile counters excluded:
the CPU captures no graph), the queue-wait outcomes included. The tiny
Qwen2-MoE engine feeds ``serving_moe_expert_load``.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import monitor as jmonitor
from paddle_tpu.inference import ServingConfig as JaxServingConfig
from paddle_tpu.inference import ServingEngine as JaxServingEngine
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.monitor import registry as jreg
from paddle_tpu_torch import monitor
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.distributed import moe as tmoe
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     Qwen2MoeConfig, Qwen2MoeForCausalLM)
from paddle_tpu_torch.monitor import accounting as acct
from paddle_tpu_torch.monitor import registry as treg
from paddle_tpu_torch.ops.kernels import decode_fused as df
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

LLAMA = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128)
CORE = dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8)
REF_ONLY = dict(min_prefill_bucket=8, async_depth=0)
# compiles: the reference compiles its tick once; the port's CPU ticks are
# eager (on CUDA it counts its graph captures)
NOT_COMPARED = {"serving_decode_compiles", "serving_prefill_compiles"}
COUNT_KEYS = (
    "decode_steps", "tokens_total", "requests_completed", "prefill_chunks",
    "prefix_blocks_reused", "prefix_tokens_reused", "cow_copies",
    "cache_evictions", "cached_blocks", "preemptions", "kv_blocks_spilled",
    "kv_blocks_restored", "preempt_swap_resumes",
    "preempt_recompute_resumes", "requests_shed", "requests_timed_out",
    "requests_cancelled", "kernel_fallbacks", "trace_events",
    "trace_events_dropped", "nonfinite_logits_ticks", "profile_captures",
    "moe_dispatches", "prefills_exported", "kv_blocks_exported",
    "kv_blocks_imported", "sessions_migrated_out", "sessions_migrated_in",
    "tp_degree", "tp_collective_bytes_total", "role", "ragged_batch",
    "chunked_prefill", "tracing", "fused_decode")


# ---------------------------------------------------------------- registry

def _feed(reg, seed):
    """A seeded sequence of every kind of write."""
    rng = np.random.RandomState(seed)
    c = reg.counter("req_total", "requests", labels=("kind",))
    g = reg.gauge("depth", "queue depth")
    h = reg.histogram("lat_ms", "latency", labels=("path",))
    h2 = reg.histogram("share", "load", buckets=(0.01, 0.1, 0.5, 1.0))
    i = reg.info("kernel", "kernel chosen", labels=("op",))
    for _ in range(200):
        op = rng.randint(5)
        if op == 0:
            c.labels(kind=f"k{rng.randint(3)}").inc(int(rng.randint(1, 4)))
        elif op == 1:
            g.set(float(rng.randint(0, 50)))
        elif op == 2:
            h.labels(path=rng.choice(["a", "b\n\"q\""])).observe(
                float(rng.exponential(30.0)))
        elif op == 3:
            h2.observe_many(rng.dirichlet(np.ones(6)))
        else:
            i.labels(op="gmm").set({"name": f"v{rng.randint(9)}"})
    g.dec(2)
    c.inc()
    with pytest.raises(ValueError, match="unknown"):
        c.labels(other="x")
    with pytest.raises(ValueError, match="re-registered"):
        reg.gauge("req_total")


def test_registry_matches_reference_sample_for_sample(tmp_path):
    mine, ref = treg.Registry(), jreg.Registry()
    _feed(mine, 3)
    _feed(ref, 3)
    assert mine.collect() == ref.collect()
    assert mine.prometheus_text() == ref.prometheus_text()
    assert mine.table() == ref.table()

    def rows(reg, name):
        with open(reg.dump_jsonl(str(tmp_path / name))) as f:
            return [dict(json.loads(x), ts=None) for x in f]

    assert rows(mine, "a.jsonl") == rows(ref, "b.jsonl")
    assert open(mine.dump_prometheus(str(tmp_path / "a.prom"))).read() \
        == ref.prometheus_text()
    mine.reset()
    assert mine.collect() == [] and mine.get("depth") is not None


def test_module_api_and_env_switches(tmp_path, monkeypatch):
    monitor.counter("api_events", "x", labels=("k",)).labels(k="a").inc()
    monitor.gauge("api_gauge").set(3)
    monitor.histogram("api_hist", buckets=(1, 2)).observe(1.5)
    monitor.info("api_info").set("v")
    assert "api_events" in monitor.report()
    monkeypatch.setenv("PADDLE_TPU_METRICS_DIR", str(tmp_path / "m"))
    monkeypatch.setenv("PADDLE_TPU_METRICS_PROM", str(tmp_path / "p"))
    assert monitor.metrics_dir() and monitor.metrics_enabled()
    path = monitor.export_jsonl()
    assert path.startswith(str(tmp_path / "m")) and path.endswith(".jsonl")
    assert "# TYPE api_gauge gauge" in open(monitor.prometheus_dump()).read()
    # the port's registry is its own: nothing leaks into the reference's
    assert jmonitor.get_registry().get("api_events") is None
    # the training step's report is ported; the collective census comes
    # with distribution
    assert set(jmonitor.__all__) - set(monitor.__all__) == {
        "collective_census"}


def test_moe_stats_served_by_registry():
    """The reference's ``tests/test_monitor.py`` case on the port."""
    tmoe.reset_moe_stats()
    tmoe.MOE_STATS["grouped_mm_calls"] += 1
    tmoe.MOE_STATS["grouped_mm_kernel"] = "gmm"
    st = tmoe.moe_stats()
    assert st["grouped_mm_calls"] == 1 and st["grouped_mm_kernel"] == "gmm"
    g = monitor.gauge("moe_path_calls", labels=("path",))
    assert g.labels(path="grouped_mm_calls").value() == 1
    assert monitor.info("moe_grouped_mm_kernel").get() == "gmm"
    tmoe.reset_moe_stats()
    assert tmoe.moe_stats()["grouped_mm_calls"] == 0
    with pytest.raises(KeyError):
        tmoe.MOE_STATS["nope"] = 1


# ---------------------------------------------------------------- accounting

def test_device_peaks(monkeypatch):
    assert acct.device_peak_flops("cpu") == 1e12
    assert acct.device_peak_hbm_bw("cpu") == 1e11
    assert acct.PEAKS["NVIDIA H100 80GB HBM3"] == (989.4e12, 3.35e12)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert acct.device_peak_flops("cuda") == 989.4e12
    assert acct.device_peak_hbm_bw("cuda") == 3.35e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "Some Other Card")
    with pytest.raises(ValueError, match="Some Other Card"):
        acct.device_peak_flops("cuda")
    assert acct.sample_device_memory(device="cpu") == {}


def test_cost_recorder_counts_aten_ops_and_declared_kernels():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 64, generator=g)
    w = torch.randn(64, 32, generator=g)
    emb = torch.randn(100, 64, generator=g)
    with acct.CostRecorder() as rec:
        e = emb[torch.tensor([1, 2, 3])]
        y = x @ w
        y.view(-1).mul_(2)
        torch.empty(5)
    r = rec.result()
    assert r["flops"] == 2 * 8 * 64 * 32
    # gather: 3 rows read and written + 3 int64 indices; mm: x, w, y;
    # mul_: y read, y written (the view and the allocation move nothing)
    want = (2 * e.numel() * 4 + 3 * 8) + 4 * (x.numel() + w.numel()
                                              + y.numel()) \
        + 2 * 4 * y.numel()
    assert r["bytes_accessed"] == want
    assert r["launch_by_op"] == {"aten.index": 1, "aten.lift_fresh_copy": 1,
                                 "aten.mm": 1, "aten.mul_": 1} \
        or r["launch_by_op"] == {"aten.index": 1, "aten.mm": 1,
                                 "aten.mul_": 1}
    # a hand-written kernel's wrapper: its declared work, its plain
    # version's aten ops left out, on the CPU as on CUDA
    d, widths, rows = 64, (32, 16), 5
    xs = torch.randn(rows, d, generator=g)
    gamma = torch.randn(d, generator=g)
    ws = [torch.randn(d, n, generator=g) for n in widths]
    with acct.CostRecorder() as rec:
        df.norm_matmul(xs, gamma, None, ws, [None, None], eps=1e-6,
                       kind="rms")
    r = rec.result()
    assert r["kernels"] == {"norm_matmul": 1} and r["launch_proxy"] == 1
    assert r["flops"] == 2 * rows * d * sum(widths) + 4 * rows * d
    assert r["bytes_accessed"] == 4 * (xs.numel() + d + sum(
        w.numel() for w in ws) + rows * sum(widths))


def test_ragged_attention_declares_this_calls_positions():
    """K2r's declared work counts the positions this call's lengths
    attend (read back once, by ``result()``): each slot's K and V over
    its context and rows, 4 x D operations a visible pair a head."""
    g = torch.Generator().manual_seed(1)
    nb, bs, hkv, d, h = 9, 8, 2, 64, 4
    kp = torch.randn(nb, bs, hkv, d, generator=g)
    vp = torch.randn(nb, bs, hkv, d, generator=g)
    tables = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    ctx = torch.tensor([10, 3], dtype=torch.int32)
    ql = torch.tensor([1, 4], dtype=torch.int32)
    rs = torch.tensor([0, 1], dtype=torch.int32)
    q = torch.randn(5, h, d, generator=g)
    with acct.CostRecorder() as rec:
        rpa.ragged_paged_attention(q, kp, vp, tables, ctx, ql, rs, 4)
    r = rec.result()
    kv_pos = (10 + 1) + (3 + 4)
    vis = (1 * 10 + 1) + (4 * 3 + 4 * 5 // 2)
    assert r["kernels"] == {"ragged_paged_attention": 1}
    assert r["flops"] == 4 * vis * h * d
    assert r["bytes_accessed"] == 2 * kv_pos * hkv * d * 4 \
        + 2 * q.numel() * 4 + 4 * (tables.numel() + 3 * 2)


# ---------------------------------------------------------------- engines

@pytest.fixture(scope="module")
def llama():
    paddle.seed(7)
    ref = JaxLlama(JaxLlamaConfig.tiny(**LLAMA))
    ref.eval()
    port = LlamaForCausalLM(LlamaConfig.tiny(**LLAMA), device="cpu")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    return ref, port.eval()


def _engine(model, jax, **kw):
    if jax:
        return JaxServingEngine(model, JaxServingConfig(
            **dict(CORE, **kw), **REF_ONLY))
    return ServingEngine(model, ServingConfig(**dict(CORE, **kw)),
                         device="cpu")


def _registry_counts(reg):
    """Counter values and histogram counts (full buckets where the value
    is not a time) of the serving engine's metrics."""
    out = {}
    for r in reg.collect():
        name = r["name"]
        if r["kind"] not in ("counter", "histogram") \
                or name in NOT_COMPARED or not (
                    name.startswith(("serving_", "spec_"))
                    or name == "trace_events_dropped"):
            continue
        key = (name, tuple(sorted(r["labels"].items())))
        v = r["value"]
        if r["kind"] == "histogram":
            v = v["count"] if name.endswith("_ms") \
                else (v["count"], tuple(sorted(v["buckets"].items())))
        out[key] = v
    return out


def _lifecycle(eng):
    """Staggered admissions over two slots, two priority arrivals that
    preempt a running request, a rejected submit, a cancel in the queue
    and one in flight, then a shutdown with two requests queued."""
    rng = np.random.RandomState(21)
    p = [rng.randint(1, 128, (n,)) for n in (20, 9, 7, 12, 6, 5, 11, 8)]
    rids = [eng.submit(p[0], 12, priority=0), eng.submit(p[1], 8)]
    for _ in range(4):
        eng.step()
    rids += [eng.submit(p[2], 8, priority=2), eng.submit(p[3], 8,
                                                          priority=2)]
    queued = eng.submit(p[4], 6)
    with pytest.raises(ValueError):
        eng.submit([], 4)
    for _ in range(3):
        eng.step()
    assert eng.cancel(queued)
    seated = [s.rid for s in eng._slots if s is not None]
    assert eng.cancel(seated[-1])
    done = eng.run()
    eng.submit(p[5], 4)
    eng.submit(p[6], 4)
    done.update(eng.run())
    eng.submit(p[7], 4, priority=1)
    eng.submit(p[0][:6], 4)
    eng.submit(p[1][:5], 4)
    eng.step()
    st = eng.stats()
    eng.shutdown(check_leaks=False)
    st["queue_exits"] = {r["labels"]["outcome"]: r["value"]["count"]
                         for r in _registry_of(eng).collect()
                         if r["name"] == "serving_queue_wait_ms"}
    return done, st


def _registry_of(eng):
    return jmonitor.get_registry() if isinstance(eng, JaxServingEngine) \
        else monitor.get_registry()


def _run(model, jax, drive, **kw):
    eng = _engine(model, jax, **kw)
    reg = _registry_of(eng)
    reg.reset()
    done, st = drive(eng)
    return done, st, _registry_counts(reg), eng


@pytest.fixture(scope="module")
def lifecycle(llama):
    ref, port = llama
    return (_run(port, False, _lifecycle), _run(ref, True, _lifecycle))


def _spec_wave(eng):
    rng = np.random.RandomState(5)
    phrase = rng.randint(1, 128, (6,))
    prompts = [np.tile(phrase, 4), np.tile(phrase, 3), rng.randint(
        1, 128, (10,))]
    out = eng.serve(prompts, max_new_tokens=8)
    st = eng.stats()
    eng.shutdown()
    return dict(enumerate(out)), st


@pytest.fixture(scope="module")
def spec(llama):
    ref, port = llama
    kw = dict(num_speculative_tokens=2)
    return (_run(port, False, _spec_wave, **kw),
            _run(ref, True, _spec_wave, **kw))


def _streams_equal(a, b):
    assert sorted(a) == sorted(b)
    for r in a:
        np.testing.assert_array_equal(np.asarray(a[r]), np.asarray(b[r]),
                                      err_msg=f"request {r}")


@pytest.mark.parametrize("wave", ["lifecycle", "spec"])
def test_engine_counts_match_reference(request, wave):
    (done, st, counts, _), (jdone, jst, jcounts, _) = \
        request.getfixturevalue(wave)
    _streams_equal(done, jdone)
    assert set(st) >= set(jst) - {"queue_exits"}
    keys = COUNT_KEYS + (("spec_tokens_proposed", "spec_tokens_accepted")
                         if wave == "spec" else ())
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    for k in ("ttft_ms", "itl_ms", "queue_wait_ms", "e2e_ms",
              "spec_accept_len"):
        assert st[k]["count"] == jst[k]["count"], k
        assert set(st[k]) == set(jst[k])
    assert counts == jcounts
    assert st["preemptions"] >= (1 if wave == "lifecycle" else 0)


def test_queue_wait_outcomes_match_reference(lifecycle):
    (_, st, _, _), (_, jst, _, _) = lifecycle
    assert st["queue_exits"] == jst["queue_exits"]
    assert {"admitted", "resumed", "cancelled", "rejected",
            "shutdown"} <= set(st["queue_exits"])
    # stats() was read before the shutdown's exits
    assert st["queue_wait_ms"]["count"] == sum(
        st["queue_exits"].values()) - st["queue_exits"]["shutdown"]


def test_stats_roofline_and_census_on_the_cpu(lifecycle):
    (_, st, _, eng), _ = lifecycle
    roof = st["roofline"]
    assert roof["cpu_proxy"] is True
    assert roof["peak_flops_per_s"] == 1e12
    assert roof["tick_executable"] in roof["per_executable"]
    census = eng.kernel_census()
    assert set(census) == set(roof["per_executable"])
    layers = LLAMA["layers"]
    for name, c in census.items():
        assert name.startswith("decode-")
        assert "graph_nodes" not in c        # the CPU captures no graph
        assert c["kernels"] == {"norm_matmul": 2 * layers,
                                "matmul_residual": 2 * layers,
                                "ragged_paged_attention": layers}
        assert c["launch_proxy"] == sum(c["launch_by_op"].values())
        r = roof["per_executable"][name]
        assert r["flops"] > 0 and r["bytes_accessed"] > 0
    assert st["kernels_per_tick"] == 0
    assert st["kernel_launch_proxy_per_tick"] == census[
        roof["tick_executable"]]["launch_proxy"]
    assert st["fused_decode_mode"] == "kernel"


def test_engine_metrics_match_reference_definitions(lifecycle, spec):
    """Every metric the reference engine registers (read off its source)
    is in the port's registry under the same kind, labels and buckets."""
    import re
    src = open(JaxServingEngine.__init__.__code__.co_filename).read()
    names = set(re.findall(
        r'monitor\.(?:gauge|counter|histogram|info)\(\s*"([a-z0-9_]+)"', src))
    assert len(names) >= 40 and "serving_e2e_ms" in names
    mine, ref = monitor.get_registry(), jmonitor.get_registry()
    for name in sorted(names):
        m, r = mine.get(name), ref.get(name)
        assert m is not None, name
        assert (m.kind, m.labelnames, getattr(m, "buckets", None)) == \
            (r.kind, r.labelnames, getattr(r, "buckets", None)), name


def test_moe_engine_feeds_expert_load():
    cfg = Qwen2MoeConfig.tiny(vocab=96, hidden=64, moe_ffn=32,
                              shared_ffn=64, experts=4, topk=2)
    cfg.dropless = True
    model = Qwen2MoeForCausalLM(cfg, device="cpu").eval()
    h = monitor.histogram(
        "serving_moe_expert_load", buckets=(0.001, 0.01, 0.05, 0.1, 0.2,
                                            0.4, 0.6, 0.8, 1.0))
    n0 = h.value()["count"]
    eng = ServingEngine(model, ServingConfig(**CORE), device="cpu")
    eng.serve([[1, 2, 3, 4], [5, 6, 7]], max_new_tokens=4)
    st = eng.stats()
    eng.shutdown()
    assert st["moe_dispatches"] > 0
    assert h.value()["count"] - n0 == st["moe_dispatches"] * 4
    assert 0.0 < monitor.gauge("serving_moe_routing_entropy").value() <= 1.0
