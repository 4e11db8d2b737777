"""The port's span tracer, latency digests and profiling windows, and the
serving engine's spans, against the JAX package on the CPU.

Pure host code: the two tracers fed the same seeded spans (explicit
intervals, instants, flows, begin / end) export the same Chrome events
and NDJSON less their times, wrap their ring buffers alike and count the
dropped events in their registries; the two P² digests give the same
summaries. The engines: a tiny Llama served by the port and by the
reference engine through a mixed wave with staggered admissions, and
through an ``async_depth=1`` wave, record the same spans, tid for tid
and in order, with the same arguments (less the ``exec`` name, which
names the port's tick layout), under the documented tid layout; under
``async_depth=1`` the tick timeline (tid 0) holds as many ticks, and the
port pipelines no more of them than the reference. The
``PADDLE_TPU_TRACE=0`` kill switch leaves no tracer and the same tokens;
``dump_trace`` writes the Chrome file; ``profile(n)`` arms a
``torch.profiler`` window over the next ``n`` ticks.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import ServingConfig as JaxServingConfig
from paddle_tpu.inference import ServingEngine as JaxServingEngine
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.monitor import digest as jdigest
from paddle_tpu.monitor import tracing as jtracing
from paddle_tpu_torch import monitor
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.monitor import digest as tdigest
from paddle_tpu_torch.monitor import tracing as ttracing

LLAMA = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128)
CORE = dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8)
REF_ONLY = dict(min_prefill_bucket=8)
TIMES = ("ts", "dur")


# ---------------------------------------------------------------- host code

def _spans(tr, seed):
    rng = np.random.RandomState(seed)
    tr.set_thread(0, "engine")
    tr.set_thread(1, "slot 0")
    t = 100.0
    for k in range(60):
        op = rng.randint(4)
        tid = int(rng.randint(0, 3))
        if op == 0:
            tr.emit(f"span{k % 5}", tid=tid, t0=t, t1=t + rng.rand(),
                    args={"rows": int(rng.randint(9))})
        elif op == 1:
            tr.instant("admit", tid=tid, args={"rid": k})
        elif op == 2:
            tr.flow("kv handoff", tid=tid, flow_id=k,
                    phase="s" if k % 2 else "f", args={"b": k})
        else:
            tr.end(tr.begin("chunk", tid=tid, pos=k), rows=3)
        t += 1.0


def _no_times(events):
    return [{k: v for k, v in e.items() if k not in TIMES} for e in events]


def test_tracer_exports_match_reference(tmp_path):
    mine = ttracing.Tracer("ServingEngine[0]", pid=7)
    ref = jtracing.Tracer("ServingEngine[0]", pid=7)
    _spans(mine, 4)
    _spans(ref, 4)
    assert _no_times(mine.chrome_events()) == _no_times(ref.chrome_events())
    assert len(mine) == len(ref) == 60

    def nd(tr, name):
        with open(tr.dump_ndjson(str(tmp_path / name))) as f:
            return [{k: v for k, v in json.loads(x).items()
                     if k not in ("t0", "dur")} for x in f]

    assert nd(mine, "a.ndjson") == nd(ref, "b.ndjson")
    doc = json.load(open(mine.dump_chrome_trace(str(tmp_path / "t.json"))))
    assert doc["displayTimeUnit"] == "ms"
    assert _no_times(doc["traceEvents"]) == _no_times(
        ref.chrome_trace()["traceEvents"])
    assert mine in ttracing.live_tracers()
    merged = json.load(open(ttracing.dump_chrome_trace(
        str(tmp_path / "m.json"), [mine])))
    assert len(merged["traceEvents"]) == len(doc["traceEvents"])
    assert ttracing.next_flow_id() < ttracing.next_flow_id()


def test_tracer_ring_wraps_and_counts_drops():
    c = monitor.counter("trace_events_dropped")
    d0 = c.value()
    mine = ttracing.Tracer("t", capacity=16)
    ref = jtracing.Tracer("t", capacity=16)
    for tr in (mine, ref):
        for k in range(40):
            tr.instant(f"e{k}")
    assert len(mine) == len(ref) == 16
    assert mine.dropped == ref.dropped == 24
    assert c.value() - d0 == 24
    assert [e["name"] for e in mine.events()] == \
        [e["name"] for e in ref.events()] == [f"e{k}" for k in range(24, 40)]
    mine.clear()
    assert len(mine) == 0 and mine.dropped == 0


def test_tracer_env_switches(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TRACE_EVENTS", "32")
    assert ttracing.trace_buffer_capacity() == 32
    assert ttracing.Tracer("x").capacity == 32
    monkeypatch.setenv("PADDLE_TPU_TRACE_EVENTS", "bogus")
    assert ttracing.trace_buffer_capacity() == 65536
    assert ttracing.tracing_enabled()
    monkeypatch.setenv("PADDLE_TPU_TRACE", "0")
    assert not ttracing.tracing_enabled()
    with pytest.raises(ValueError, match="flow phase"):
        ttracing.Tracer("y").flow("x", phase="q")


@pytest.mark.parametrize("seed", [0, 1])
def test_digests_match_reference(seed):
    rng = np.random.RandomState(seed)
    xs = rng.lognormal(2.0, 1.0, size=500)
    mine, ref = tdigest.LatencyDigest(), jdigest.LatencyDigest()
    for x in xs:
        mine.observe(float(x))
        ref.observe(float(x))
    assert mine.summary() == ref.summary()
    assert mine.quantiles() == ref.quantiles()


def test_profiler_window_arms_and_brackets_ticks(tmp_path, monkeypatch):
    calls = []
    w = ttracing.ProfilerWindow(start=lambda d: calls.append(("start", d)),
                                stop=lambda: calls.append("stop") or "f")
    with pytest.raises(ValueError, match="n_ticks"):
        w.arm(0, str(tmp_path))
    monkeypatch.delenv("PADDLE_TPU_PROFILE_DIR", raising=False)
    with pytest.raises(ValueError, match="PADDLE_TPU_PROFILE_DIR"):
        w.arm(2)
    assert w.arm(2, str(tmp_path)) == str(tmp_path)
    with pytest.raises(RuntimeError, match="already armed"):
        w.arm(1, str(tmp_path))
    for _ in range(3):
        with w.tick():
            pass
    assert calls == [("start", str(tmp_path)), "stop"]
    assert (w.captures, w.pending, w.last_dir, w.last_file) == (
        1, 0, str(tmp_path), "f")
    monkeypatch.setenv("PADDLE_TPU_TRACE", "0")
    assert w.arm(3, str(tmp_path)) is None and w.pending == 0


# ---------------------------------------------------------------- engines

@pytest.fixture(scope="module")
def llama():
    paddle.seed(9)
    ref = JaxLlama(JaxLlamaConfig.tiny(**LLAMA))
    ref.eval()
    port = LlamaForCausalLM(LlamaConfig.tiny(**LLAMA), device="cpu")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in ref.state_dict().items()})
    return ref, port.eval()


def _wave(eng, max_new=5):
    """Four prompts over two slots, admitted as slots free up, with a
    request submitted between ticks."""
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 128, (n,)) for n in (6, 20, 9, 14)]
    rids = [eng.submit(p, max_new) for p in prompts[:3]]
    eng.step()
    eng.step()
    rids.append(eng.submit(prompts[3], max_new))
    done = eng.run()
    out = [done[r] for r in rids]
    st = eng.stats()
    events = eng.tracer.events()
    eng.shutdown()
    return out, st, events


def _engines(llama, **kw):
    ref, port = llama
    mine = _wave(ServingEngine(port, ServingConfig(**CORE, **kw),
                               device="cpu"))
    theirs = _wave(JaxServingEngine(ref, JaxServingConfig(
        **CORE, **kw, **REF_ONLY)))
    return mine, theirs


@pytest.fixture(scope="module")
def sync_wave(llama):
    return _engines(llama, async_depth=0)


@pytest.fixture(scope="module")
def async_wave(llama):
    return _engines(llama, async_depth=1)


def _by_tid(events):
    """Each tid's events in order: phase, name and arguments (less the
    tick's ``exec``, the port's layout name)."""
    out = {}
    for e in events:
        args = {k: v for k, v in (e["args"] or {}).items() if k != "exec"}
        out.setdefault(e["tid"], []).append((e["ph"], e["name"], args))
    return out


@pytest.mark.parametrize("wave", ["sync_wave", "async_wave"])
def test_engine_spans_match_reference(request, wave):
    (out, st, ev), (jout, jst, jev) = request.getfixturevalue(wave)
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(a, b)
    mine, ref = _by_tid(ev), _by_tid(jev)
    assert set(mine) == set(ref) <= set(range(CORE["num_slots"] + 2))
    for tid in ref:
        if tid or wave == "sync_wave":
            assert mine[tid] == ref[tid], f"tid {tid}"
    if wave == "async_wave":
        # the port pipelines over fewer ticks than the reference (not over
        # a slot on its last token: its pure ticks pack their live rows,
        # the reference's the static width), so its tick timeline has
        # fewer pipelined dispatches, the same ticks in number
        ticks = [x for x in mine[0] if x[1] == "tick"]
        jticks = [x for x in ref[0] if x[1] == "tick"]
        assert len(ticks) == len(jticks)
        piped = [x for x in mine[0] if x[1] == "pipelined dispatch"]
        jpiped = [x for x in ref[0] if x[1] == "pipelined dispatch"]
        assert 0 < len(piped) == st["pipelined_ticks"] <= len(jpiped)
    else:
        assert st["trace_events"] == jst["trace_events"] == len(ev)
    names = {e["name"] for e in ev}
    assert {"submit", "admit", "prefill chunk", "decode tick", "tick",
            "retired"} <= names
    if wave == "async_wave":
        assert "pipelined dispatch" in names and st["pipelined_ticks"] > 0
    ticks = [e for e in ev if e["name"] == "tick"]
    assert all(e["tid"] == 0 and e["args"]["exec"].startswith("decode-")
               and e["args"]["kernel_fallbacks"] == 0 for e in ticks)
    # a request's span holds its slot's tick spans
    reqs = {e["name"]: e for e in ev if e["name"].startswith("req")
            and not e["name"].endswith("queued")}
    for e in ev:
        if e["name"] in ("decode tick", "prefill chunk"):
            parent = reqs[f"req{e['args']['rid']}"]
            assert parent["tid"] == e["tid"]
            assert parent["t0"] <= e["t0"] + 1e-9
            assert e["t0"] + e["dur"] <= parent["t0"] + parent["dur"] + 1e-9


def test_trace_kill_switch_is_inert(llama, sync_wave, monkeypatch,
                                    tmp_path):
    """``PADDLE_TPU_TRACE=0``: no tracer, the same tokens and graphs, the
    digests still run, ``profile()`` refuses. The export switches
    (``PADDLE_TPU_METRICS_DIR`` / ``_PROM`` / ``_DUMP``) and the
    incident and profile directories, set with it, are host-only too."""
    (out, st, _), _ = sync_wave
    monkeypatch.setenv("PADDLE_TPU_TRACE", "0")
    for env, sub in (("PADDLE_TPU_METRICS_DIR", "m"),
                     ("PADDLE_TPU_METRICS_PROM", "p"),
                     ("PADDLE_TPU_INCIDENT_DIR", "i"),
                     ("PADDLE_TPU_PROFILE_DIR", "f")):
        monkeypatch.setenv(env, str(tmp_path / sub))
    monkeypatch.setenv("PADDLE_TPU_METRICS_DUMP", "stderr")
    eng = ServingEngine(llama[1], ServingConfig(**CORE, async_depth=0),
                        device="cpu")
    assert eng.tracer is None and eng.dump_trace("x.json") is None
    assert eng.profile(2, "somewhere") is None
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 128, (n,)) for n in (6, 20, 9, 14)]
    rids = [eng.submit(p, 5) for p in prompts[:3]]
    eng.step()
    eng.step()
    rids.append(eng.submit(prompts[3], 5))
    done = eng.run()
    for r, a in zip(rids, out):
        np.testing.assert_array_equal(done[r], a)
    off = eng.stats()
    assert off["tracing"] is False and off["trace_events"] == 0
    assert off["executables_compiled"] == st["executables_compiled"]
    assert off["ttft_ms"]["count"] == st["ttft_ms"]["count"] == 4
    assert eng.shutdown()


def test_dump_trace_and_profile_window(llama, tmp_path):
    eng = ServingEngine(llama[1], ServingConfig(**CORE), device="cpu")
    eng.submit(list(range(1, 12)), 6)
    eng.step()
    assert eng.profile(2, str(tmp_path / "prof")) == str(tmp_path / "prof")
    with pytest.raises(RuntimeError, match="already armed"):
        eng.profile(1, str(tmp_path / "prof"))
    assert eng.stats()["profile_ticks_remaining"] == 2
    eng.run()
    st = eng.stats()
    assert st["profile_captures"] == 1 and st["profile_ticks_remaining"] == 0
    prof = json.load(open(eng._prof.last_file))
    assert os.path.dirname(eng._prof.last_file) == str(tmp_path / "prof")
    assert any(e.get("name", "").startswith("aten::")
               for e in prof["traceEvents"])
    doc = json.load(open(eng.dump_trace(str(tmp_path / "t" / "a.json"))))
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names == {0: "engine", 1: "slot 0", 2: "slot 1", 3: "queue"}
    assert {e["tid"] for e in doc["traceEvents"]} <= set(names)
    assert eng.shutdown()
