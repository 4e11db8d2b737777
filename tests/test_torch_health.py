"""The port's health engine against the JAX package's, and wired into the
port's serving engine, on the CPU.

Pure host code: every detector, the ``HealthMonitor`` state machine and
``IncidentCapture`` are fed the same seeded signal sequences under an
injected clock in both packages; the journals, scores, firing sets,
snapshots and incident bundles (less the wall-clock stamp and the
bundles' sequence numbers) must be equal. The engine: a healthy serve
fires nothing; ``health=False`` gives ``health()`` None with every key
present; ``PADDLE_TPU_HEALTH=0`` changes no token and no graph count; a
NaN weight trips the non-finite probe, which rides the tick's read-back;
an unmeetable SLO fires the fast burn and captures an incident bundle;
and the watchdog reads the tick's time EMA.
"""
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu.monitor import health as jh
from paddle_tpu_torch.inference import ServingConfig, ServingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.monitor import health as th

LLAMA = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _signals(seed, n=400):
    """A seeded run of ticks: latency with spikes and a stall, queue
    growth, capture storms, acceptance collapse, preemption thrash and
    non-finite ticks, and retirements meeting or missing their SLO."""
    rng = np.random.RandomState(seed)
    out, comp, pre, done, emit, ver = [], 0, 0, 0, 0, 0
    for k in range(n):
        tick = float(rng.lognormal(-4.0, 0.2))
        if 150 <= k < 156 or rng.rand() < 0.02:
            tick *= 20.0
        if k == 300:
            tick = 9.0                              # a stall
        comp += int(rng.rand() < (0.5 if 200 <= k < 215 else 0.01))
        pre += int(rng.rand() < (0.6 if 250 <= k < 270 else 0.02))
        done += int(rng.rand() < 0.3)
        ver += 2
        emit += 2 * (1 + (3 if k < 240 else int(rng.rand() < 0.2)))
        out.append(dict(
            dt=float(rng.uniform(0.005, 0.05)),
            tick=dict(tick_s=tick, queued=int(k // 20 if 100 <= k < 140
                                              else rng.randint(3)),
                      step_ema_s=0.02, fallbacks=0, compiles=comp,
                      spec_emitted=emit, spec_verifies=ver,
                      preemptions=pre, completed=done,
                      nonfinite=bool(330 <= k < 333),
                      compiled=bool(k in (0, 1, 205))),
            requests=[bool(rng.rand() > (0.6 if 50 <= k < 90 else 0.01))
                      for _ in range(rng.randint(3))]))
    return out


def _drive(mod, seed, tmp, **kw):
    clock = _Clock()
    inc = mod.IncidentCapture(out_dir=str(tmp), min_interval_s=2.0,
                              max_incidents=3, clock=clock)
    profiles = []
    h = mod.HealthMonitor(clock=clock, stats_cb=lambda: {"ticks": 1},
                          trace_cb=lambda: {"traceEvents": []},
                          profile_cb=lambda: profiles.append(clock()),
                          incident=inc, **kw)
    trail = []
    for s in _signals(seed):
        clock.t += s["dt"]
        for met in s["requests"]:
            h.on_request(met)
        h.on_tick(**s["tick"])
        trail.append((h.score(), tuple(h.firing()), h.burn_rates()))
    stuck = h.watchdog_check(0.02)
    return h, trail, profiles, stuck


def _bundles(tmp):
    out = {}
    for d in sorted(os.listdir(tmp)):
        name = d.split("-", 3)[-1]          # less pid and sequence number
        files = {}
        for f in sorted(os.listdir(os.path.join(tmp, d))):
            text = open(os.path.join(tmp, d, f)).read()
            if f == "manifest.json":
                m = json.loads(text)
                m.pop("unix_ts")
                m.pop("seq")
                text = m
            files[f] = text
        out.setdefault(name, []).append(files)
    return out


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, dict(slo_target=0.95, burn_fast_s=1.0, burn_slow_s=4.0,
             burn_min_requests=4, spike_consecutive=2, queue_window=6,
             recompile_threshold=4, thrash_min_events=3)),
])
def test_health_monitor_matches_reference(tmp_path, seed, kw):
    a, b = tmp_path / "port", tmp_path / "ref"
    a.mkdir()
    b.mkdir()
    mine, trail, prof, stuck = _drive(th, seed, a, **kw)
    ref, jtrail, jprof, jstuck = _drive(jh, seed, b, **kw)
    assert trail == jtrail
    assert list(mine.journal) == list(ref.journal)
    assert mine.snapshot() == ref.snapshot()
    assert (mine.fired_total, prof, stuck) == (ref.fired_total, jprof,
                                               jstuck)
    assert mine.fired_total > 3
    assert mine._incident.captured == ref._incident.captured > 0
    assert _bundles(a) == _bundles(b)
    assert th.ALERT_SEVERITY == jh.ALERT_SEVERITY
    assert len(th.ALERT_SEVERITY) == 10


def test_detectors_match_reference():
    rng = np.random.RandomState(2)
    xs = rng.lognormal(0.0, 0.5, size=300)
    xs[100:106] *= 30
    pairs = [(th.EwmaSpikeDetector(), jh.EwmaSpikeDetector()),
             (th.CollapseDetector(), jh.CollapseDetector()),
             (th.TrendDetector(window=5, min_depth=2, min_growth=3),
              jh.TrendDetector(window=5, min_depth=2, min_growth=3))]
    for mine, ref in pairs:
        vals = xs if not isinstance(mine, th.TrendDetector) \
            else np.cumsum(rng.randint(0, 2, size=300))
        assert [mine.observe(float(x)) for x in vals] == \
            [ref.observe(float(x)) for x in vals]
    clock = _Clock()
    st, jst = th.StormDetector(clock=clock), jh.StormDetector(clock=clock)
    rd, jrd = th.RatioDetector(clock=clock), jh.RatioDetector(clock=clock)
    br = th.BurnRateMonitor(min_requests=3, clock=clock)
    jbr = jh.BurnRateMonitor(min_requests=3, clock=clock)
    for k in range(200):
        clock.t += float(rng.uniform(0.1, 2.0))
        c, p, d = (int(x) for x in rng.randint(0, 4, size=3))
        assert st.observe(c) == jst.observe(c)
        assert rd.observe(p, d) == jrd.observe(p, d)
        met = bool(rng.rand() > (0.5 if 80 <= k < 120 else 0.02))
        br.observe(met)
        jbr.observe(met)
        assert br.rates() == jbr.rates() and br.firing() == jbr.firing()
    with pytest.raises(ValueError, match="budget"):
        th.BurnRateMonitor(budget=1.5)


def test_incident_capture_rate_limit_bound_and_disabled(tmp_path,
                                                        monkeypatch):
    clock = _Clock()
    inc = th.IncidentCapture(out_dir=str(tmp_path), min_interval_s=5.0,
                             max_incidents=2, clock=clock)
    made = []
    for k in range(6):
        clock.t += 3.0
        made.append(inc.maybe_capture(f"a{k}", "warn",
                                      stats_cb=lambda: {"x": 1},
                                      journal=[{"t": k}]))
    assert [m is not None for m in made] == [True, False, True, False,
                                             True, False]
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("inc"))
    assert len(kept) == 2 and inc.captured == 3
    assert not any(d.startswith(".tmp-") for d in os.listdir(tmp_path))
    monkeypatch.delenv("PADDLE_TPU_INCIDENT_DIR", raising=False)
    assert th.IncidentCapture().maybe_capture("x", "page") is None


# ---------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def model():
    return LlamaForCausalLM(LlamaConfig.tiny(**LLAMA), device="cpu",
                            seed=5).eval()


def _cfg(**kw):
    # generous SLOs: a CPU tick must not read as a violation
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("max_model_len", 64)
    kw.setdefault("health_slo_ttft_ms", 600000.0)
    kw.setdefault("health_slo_itl_ms", 600000.0)
    return ServingConfig(**kw)


def _prompts(n=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (9,)) for _ in range(n)]


def test_healthy_serve_fires_nothing(model):
    eng = ServingEngine(model, _cfg(), device="cpu")
    eng.serve(_prompts())
    st = eng.stats()
    assert st["health_score"] == 1.0 and st["alerts_firing"] == 0
    assert st["alerts_fired_total"] == 0 and st["incidents_captured"] == 0
    assert st["nonfinite_logits_ticks"] == 0
    h = eng.health()
    assert h["alerts_firing"] == [] and h["journal"] == []
    assert h["burn_rate"]["fast"] == 0.0
    assert set(h["alerts"]) == set(th.ALERT_SEVERITY)
    assert not eng.watchdog_stuck()
    assert eng.shutdown()


def test_health_off_keeps_keys_and_returns_none(model):
    eng = ServingEngine(model, _cfg(health=False), device="cpu")
    eng.serve(_prompts(2))
    st = eng.stats()
    assert (st["health_score"], st["alerts_firing"],
            st["alerts_fired_total"], st["incidents_captured"],
            st["nonfinite_logits_ticks"]) == (1.0, 0, 0, 0, 0)
    assert eng.health() is None and not eng.watchdog_stuck()
    assert eng.shutdown()


@pytest.mark.parametrize("depth", [0, 1])
def test_kill_switch_is_inert_on_tokens_and_graphs(model, monkeypatch,
                                                   tmp_path, depth):
    """``PADDLE_TPU_HEALTH=0`` beats the config: no monitor, no bundle,
    the same tokens and graph count (an unmeetable SLO and an incident
    directory armed in both arms, so the on arm does fire)."""
    monkeypatch.setenv("PADDLE_TPU_INCIDENT_DIR", str(tmp_path))

    def serve(off):
        if off:
            monkeypatch.setenv("PADDLE_TPU_HEALTH", "0")
        eng = ServingEngine(model, _cfg(
            async_depth=depth, health_slo_ttft_ms=1e-3,
            health_slo_itl_ms=1e-3, health_burn_fast_s=0.5,
            health_burn_slow_s=2.0, health_burn_min_requests=2),
            device="cpu")
        monkeypatch.delenv("PADDLE_TPU_HEALTH", raising=False)
        out = [o.tolist() for o in eng.serve(_prompts(6, 3))]
        st, h = eng.stats(), eng.health()
        eng.shutdown()
        return out, st, h

    on, st_on, h_on = serve(False)
    n_on = len(os.listdir(tmp_path))
    off, st_off, h_off = serve(True)
    assert on == off
    assert st_on["executables_compiled"] == st_off["executables_compiled"]
    assert st_on["alerts_fired_total"] > 0
    assert "slo_fast_burn" in h_on["alerts_firing"] \
        or st_on["incidents_captured"] > 0
    assert n_on > 0 and len(os.listdir(tmp_path)) == n_on
    assert h_off is None and st_off["alerts_fired_total"] == 0
    bundle = sorted(d for d in os.listdir(tmp_path)
                    if d.startswith("incident-"))[0]
    stats = json.load(open(tmp_path / bundle / "stats.json"))
    assert "roofline" in stats and "health_score" in stats
    trace = json.load(open(tmp_path / bundle / "trace.json"))
    assert trace["traceEvents"]


@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_nonfinite_probe_fires(model, kind):
    """A NaN weight poisons the logits: the probe, read back with the
    tick's tokens, flags the ticks and the page alert fires; the engine
    captures nothing (the CPU replays no graph) and serves on."""
    sick = LlamaForCausalLM(LlamaConfig.tiny(**LLAMA), device="cpu",
                            seed=5).eval()
    with torch.no_grad():
        sick.lm_head.weight[:, 3] = float("nan")
    kw = dict(num_speculative_tokens=2) if kind == "verify" else {}
    eng = ServingEngine(sick, _cfg(**kw), device="cpu")
    eng.serve(_prompts(2), max_new_tokens=4)
    st = eng.stats()
    assert st["nonfinite_logits_ticks"] > 0
    assert "nonfinite_logits" in eng.health()["alerts_firing"]
    assert th.ALERT_SEVERITY["nonfinite_logits"] == "page"
    assert st["health_score"] <= 0.5
    assert st["executables_compiled"] == 0
    eng.shutdown(check_leaks=False)


def test_watchdog_reads_the_tick_ema(model, monkeypatch):
    eng = ServingEngine(model, _cfg(health_watchdog_floor_s=1e-9,
                                    health_watchdog_mult=1.0),
                        device="cpu")
    eng.serve(_prompts(4))
    roof = eng.stats()["roofline"]
    assert any(r["step_time_ms"] for r in roof["per_executable"].values())
    eng._step_time[roof["tick_executable"]] = 1e-9   # the last tick outran
    assert eng.watchdog_stuck()
    assert "stuck_tick" in eng.health()["alerts_firing"]
    assert eng.shutdown()
