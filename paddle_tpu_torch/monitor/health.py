"""Fleet health engine: anomaly detectors, watchdog, incident capture
(the port's copy of ``paddle_tpu/monitor/health.py``, which imports no
JAX: the same ten alerts, journal and score rules).

The flight recorder (tracing.py) and SLO digests (digest.py) made the
serving stack *inspectable*; this module makes it *watched*.  Every
detector here consumes a signal the engine already produces — nothing
in this file touches a device or adds an executable:

* :class:`BurnRateMonitor` — SRE-style multi-window SLO burn rate over
  the per-request TTFT/TPOT attainment stream (fast window pages,
  slow window warns; both must exceed the threshold for the fast
  alert so a single blip cannot page).
* :class:`EwmaSpikeDetector` — tick-latency spike detection: EWMA of
  the mean and absolute deviation, fires on a run of samples far
  above both the deviation band and a hard multiple of the mean.
* :class:`TrendDetector` — queue-depth growth: monotone non-decreasing
  window with a minimum total rise.
* :class:`StormDetector` — windowed event-count storms (kernel
  fallbacks, recompiles).
* :class:`CollapseDetector` — speculative acceptance-length collapse:
  a fast EMA falling far under the slow EMA.
* :class:`RatioDetector` — host-tier thrash: windowed preemptions
  outpacing completions.

:class:`HealthMonitor` aggregates the detectors into a named-alert
state machine with a transition journal and a scalar health score;
:class:`IncidentCapture` turns ok→firing transitions into atomic,
rate-limited, bounded incident bundles on disk.  All of it is pure
host Python — the engine kill switch (``PADDLE_TPU_HEALTH=0``) simply
never constructs a monitor, keeping tokens and graph counts
bit-for-bit identical.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = [
    "ALERT_SEVERITY",
    "BurnRateMonitor",
    "CollapseDetector",
    "EwmaSpikeDetector",
    "HealthMonitor",
    "IncidentCapture",
    "RatioDetector",
    "StormDetector",
    "TrendDetector",
]

# Every alert the stack can raise, with its severity.  ``page`` means
# "a human (or the fleet controller) must act now"; ``warn`` means
# "degraded but serving".  The stats-docs lint walks this registry, so
# an alert cannot ship without an OPS.md entry.
ALERT_SEVERITY: Dict[str, str] = {
    "slo_fast_burn": "page",
    "slo_slow_burn": "warn",
    "tick_latency_spike": "warn",
    "queue_depth_growth": "warn",
    "kernel_fallback_storm": "warn",
    "recompile_storm": "page",
    "spec_accept_collapse": "warn",
    "host_tier_thrash": "warn",
    "nonfinite_logits": "page",
    "stuck_tick": "page",
}

_SCORE_PENALTY = {"page": 0.5, "warn": 0.15}


class BurnRateMonitor:
    """Multi-window SLO burn rate (SRE fast/slow window alerting).

    Each completed request reports whether it met its SLO.  Burn rate
    is the windowed violation fraction divided by the error budget
    (``1 - slo_target``): burn 1.0 consumes the budget exactly; burn
    ``threshold`` (default 2.0) consumes it ``threshold``× too fast.
    The fast alert requires *both* windows over threshold — the slow
    window confirms the fast one so a short blip cannot page.
    """

    def __init__(self, fast_s: float = 5.0, slow_s: float = 60.0,
                 budget: float = 0.01, threshold: float = 2.0,
                 min_requests: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        if not 0.0 < budget < 1.0:
            raise ValueError(f"budget must be in (0, 1), got {budget!r}")
        if not 0.0 < fast_s < slow_s:
            raise ValueError(
                f"need 0 < fast_s < slow_s, got {fast_s!r}, {slow_s!r}")
        self._fast_s = fast_s
        self._slow_s = slow_s
        self._budget = budget
        self._threshold = threshold
        self._min_requests = min_requests
        self._clock = clock
        self._events: deque = deque()  # (t, met)

    def observe(self, met: bool) -> None:
        self._events.append((self._clock(), bool(met)))
        self._prune()

    def _prune(self) -> None:
        cut = self._clock() - self._slow_s
        ev = self._events
        while ev and ev[0][0] < cut:
            ev.popleft()

    def rates(self) -> Dict[str, float]:
        """Current fast/slow burn rates and window populations."""
        self._prune()
        now = self._clock()
        fast_cut = now - self._fast_s
        n_fast = bad_fast = n_slow = bad_slow = 0
        for t, met in self._events:
            n_slow += 1
            bad_slow += not met
            if t >= fast_cut:
                n_fast += 1
                bad_fast += not met
        fast = (bad_fast / n_fast / self._budget) if n_fast else 0.0
        slow = (bad_slow / n_slow / self._budget) if n_slow else 0.0
        return {"fast": fast, "slow": slow,
                "n_fast": n_fast, "n_slow": n_slow}

    def firing(self) -> Dict[str, bool]:
        r = self.rates()
        thr = self._threshold
        fast = (r["fast"] >= thr and r["slow"] >= thr
                and r["n_fast"] >= self._min_requests)
        slow = r["slow"] >= thr and r["n_slow"] >= self._min_requests
        return {"fast": fast, "slow": slow}


class EwmaSpikeDetector:
    """Tick-latency spike: EWMA mean + deviation band, run-gated.

    Fires only when a sample exceeds *both* ``mean + k*dev`` and
    ``min_ratio * mean`` for ``consecutive`` samples in a row after a
    warmup — compile-induced first ticks and lone scheduler hiccups
    stay quiet.  Spiking samples are held OUT of the EMAs (outlier
    rejection): otherwise one absorbed spike widens the deviation
    band enough to swallow the next, and a sustained stall could
    never string ``consecutive`` detections together.  A sustained
    level shift therefore keeps the alert up until latency actually
    returns toward the old baseline — which is the correct alert
    semantic for "the tick got slow and stayed slow".
    """

    def __init__(self, alpha: float = 0.3, k: float = 6.0,
                 min_ratio: float = 4.0, warmup: int = 10,
                 consecutive: int = 3):
        self._alpha = alpha
        self._k = k
        self._min_ratio = min_ratio
        self._warmup = warmup
        self._consecutive = consecutive
        self._mean = 0.0
        self._dev = 0.0
        self._n = 0
        self._run = 0

    def observe(self, x: float) -> bool:
        """Feed one sample; returns True when the detector is firing."""
        spike = False
        if self._n >= self._warmup:
            spike = (x > self._mean + self._k * self._dev
                     and x > self._min_ratio * self._mean)
        self._run = self._run + 1 if spike else 0
        if not spike:               # outlier rejection (see docstring)
            a = self._alpha
            if self._n == 0:
                self._mean = x
            else:
                self._dev = ((1 - a) * self._dev
                             + a * abs(x - self._mean))
                self._mean = (1 - a) * self._mean + a * x
            self._n += 1
        return self._run >= self._consecutive

    @property
    def mean(self) -> float:
        return self._mean


class TrendDetector:
    """Queue-depth growth: full monotone window with a minimum rise."""

    def __init__(self, window: int = 12, min_depth: int = 4,
                 min_growth: int = 6):
        self._win: deque = deque(maxlen=window)
        self._min_depth = min_depth
        self._min_growth = min_growth

    def observe(self, depth: int) -> bool:
        self._win.append(int(depth))
        w = self._win
        if len(w) < w.maxlen or w[-1] < self._min_depth:
            return False
        if w[-1] - w[0] < self._min_growth:
            return False
        return all(b >= a for a, b in zip(w, itertools.islice(w, 1, None)))


class StormDetector:
    """Windowed event-count storm (fallbacks, recompiles)."""

    def __init__(self, window_s: float = 30.0, threshold: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        self._window_s = window_s
        self._threshold = threshold
        self._clock = clock
        self._events: deque = deque()  # (t, count)

    def observe(self, count: int) -> bool:
        now = self._clock()
        if count > 0:
            self._events.append((now, int(count)))
        cut = now - self._window_s
        ev = self._events
        while ev and ev[0][0] < cut:
            ev.popleft()
        return sum(c for _, c in ev) >= self._threshold


class CollapseDetector:
    """Acceptance-length collapse: fast EMA far under the slow EMA."""

    def __init__(self, alpha_fast: float = 0.4, alpha_slow: float = 0.02,
                 ratio: float = 0.5, warmup: int = 20):
        self._af = alpha_fast
        self._as = alpha_slow
        self._ratio = ratio
        self._warmup = warmup
        self._fast = 0.0
        self._slow = 0.0
        self._n = 0

    def observe(self, x: float) -> bool:
        if self._n == 0:
            self._fast = self._slow = x
        else:
            self._fast = (1 - self._af) * self._fast + self._af * x
            self._slow = (1 - self._as) * self._slow + self._as * x
        self._n += 1
        # the 1.0 floor: a baseline under one accepted token/tick has
        # nothing meaningful to collapse from
        return (self._n > self._warmup and self._slow > 1.0
                and self._fast < self._ratio * self._slow)


class RatioDetector:
    """Host-tier thrash: windowed preemptions outpacing completions."""

    def __init__(self, window_s: float = 30.0, ratio: float = 1.0,
                 min_events: int = 4,
                 clock: Callable[[], float] = time.monotonic):
        self._window_s = window_s
        self._ratio = ratio
        self._min_events = min_events
        self._clock = clock
        self._num: deque = deque()  # (t, preemptions)
        self._den: deque = deque()  # (t, completions)

    def observe(self, preemptions: int, completions: int) -> bool:
        now = self._clock()
        if preemptions > 0:
            self._num.append((now, int(preemptions)))
        if completions > 0:
            self._den.append((now, int(completions)))
        cut = now - self._window_s
        for q in (self._num, self._den):
            while q and q[0][0] < cut:
                q.popleft()
        pre = sum(c for _, c in self._num)
        done = sum(c for _, c in self._den)
        return pre >= self._min_events and pre > self._ratio * max(done, 1)


class IncidentCapture:
    """Atomic, rate-limited, bounded incident bundles on disk.

    A bundle is a directory ``incident-<pid>-<seq>-<alert>/`` under
    ``PADDLE_TPU_INCIDENT_DIR`` holding ``manifest.json`` (alert name,
    severity, timestamps), ``stats.json`` (the full ``stats()``
    snapshot incl. roofline), ``trace.json`` (merged Perfetto trace,
    when a tracer is live), and ``journal.ndjson`` (recent alert
    transitions, severity-tagged).  The bundle is staged under a
    ``.tmp-`` name and ``os.rename``d into place so readers never see
    a torn bundle; captures are rate-limited (``min_interval_s``) and
    the oldest bundles are pruned past ``max_incidents``.
    """

    _seq = itertools.count()

    def __init__(self, out_dir: Optional[str] = None,
                 min_interval_s: float = 30.0, max_incidents: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        if out_dir is None:
            out_dir = os.environ.get("PADDLE_TPU_INCIDENT_DIR")
        self._out_dir = out_dir
        self._min_interval_s = min_interval_s
        self._max_incidents = max_incidents
        self._clock = clock
        self._last_t: Optional[float] = None
        self.captured = 0

    def maybe_capture(self, alert: str, severity: str, *,
                      stats_cb: Optional[Callable[[], dict]] = None,
                      trace_cb: Optional[Callable[[], Optional[dict]]] = None,
                      journal: Optional[List[dict]] = None,
                      ) -> Optional[str]:
        """Write a bundle unless disabled or rate-limited.

        Returns the final bundle path, or None when skipped."""
        if not self._out_dir:
            return None
        now = self._clock()
        if (self._last_t is not None
                and now - self._last_t < self._min_interval_s):
            return None
        self._last_t = now
        seq = next(IncidentCapture._seq)
        name = f"incident-{os.getpid()}-{seq:04d}-{alert}"
        tmp = os.path.join(self._out_dir, f".tmp-{name}")
        final = os.path.join(self._out_dir, name)
        os.makedirs(tmp, exist_ok=True)
        try:
            manifest = {"alert": alert, "severity": severity,
                        "monotonic_s": now, "unix_ts": time.time(),
                        "pid": os.getpid(), "seq": seq}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=2, default=str)
            if stats_cb is not None:
                with open(os.path.join(tmp, "stats.json"), "w") as f:
                    json.dump(stats_cb(), f, indent=2, default=str)
            if trace_cb is not None:
                trace = trace_cb()
                if trace is not None:
                    with open(os.path.join(tmp, "trace.json"), "w") as f:
                        json.dump(trace, f, default=str)
            with open(os.path.join(tmp, "journal.ndjson"), "w") as f:
                for entry in journal or []:
                    f.write(json.dumps(entry, default=str) + "\n")
            os.rename(tmp, final)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self.captured += 1
        self._prune()
        return final

    def _prune(self) -> None:
        try:
            dirs = sorted(d for d in os.listdir(self._out_dir)
                          if d.startswith("incident-"))
        except OSError:
            return
        for d in dirs[:-self._max_incidents] if self._max_incidents else dirs:
            shutil.rmtree(os.path.join(self._out_dir, d),
                          ignore_errors=True)


class HealthMonitor:
    """Per-engine alert state machine over the detector suite.

    The engine feeds :meth:`on_request` (per retired request: SLO
    met?) and :meth:`on_tick` (per tick: wall time, queue depth,
    cumulative counters).  Counters arrive cumulative and are diffed
    internally, so call sites stay stateless.  Alert transitions are
    journaled; ok→firing bumps ``alerts_fired_total`` and triggers
    incident capture (and, optionally, arms a profiler window).
    """

    def __init__(self, *,
                 slo_target: float = 0.99,
                 burn_fast_s: float = 5.0, burn_slow_s: float = 60.0,
                 burn_threshold: float = 2.0, burn_min_requests: int = 8,
                 watchdog_mult: float = 50.0, watchdog_floor_s: float = 5.0,
                 spike_alpha: float = 0.3, spike_k: float = 6.0,
                 spike_min_ratio: float = 4.0, spike_warmup: int = 10,
                 spike_consecutive: int = 3,
                 queue_window: int = 12, queue_min_depth: int = 4,
                 queue_min_growth: int = 6,
                 fallback_window_s: float = 30.0, fallback_threshold: int = 8,
                 recompile_window_s: float = 60.0,
                 recompile_threshold: int = 10,
                 collapse_ratio: float = 0.5, collapse_warmup: int = 20,
                 thrash_window_s: float = 30.0, thrash_ratio: float = 1.0,
                 thrash_min_events: int = 4,
                 journal_len: int = 256,
                 clock: Callable[[], float] = time.monotonic,
                 stats_cb: Optional[Callable[[], dict]] = None,
                 trace_cb: Optional[Callable[[], Optional[dict]]] = None,
                 profile_cb: Optional[Callable[[], None]] = None,
                 incident: Optional[IncidentCapture] = None):
        self._clock = clock
        self._stats_cb = stats_cb
        self._trace_cb = trace_cb
        self._profile_cb = profile_cb
        self._incident = incident
        self._burn = BurnRateMonitor(
            fast_s=burn_fast_s, slow_s=burn_slow_s,
            budget=max(1.0 - slo_target, 1e-9),
            threshold=burn_threshold, min_requests=burn_min_requests,
            clock=clock)
        self._spike = EwmaSpikeDetector(
            alpha=spike_alpha, k=spike_k, min_ratio=spike_min_ratio,
            warmup=spike_warmup, consecutive=spike_consecutive)
        self._trend = TrendDetector(
            window=queue_window, min_depth=queue_min_depth,
            min_growth=queue_min_growth)
        self._fallback_storm = StormDetector(
            window_s=fallback_window_s, threshold=fallback_threshold,
            clock=clock)
        self._recompile_storm = StormDetector(
            window_s=recompile_window_s, threshold=recompile_threshold,
            clock=clock)
        self._collapse = CollapseDetector(
            ratio=collapse_ratio, warmup=collapse_warmup)
        self._thrash = RatioDetector(
            window_s=thrash_window_s, ratio=thrash_ratio,
            min_events=thrash_min_events, clock=clock)
        self._wd_mult = watchdog_mult
        self._wd_floor_s = watchdog_floor_s
        self._wd_last_end: Optional[float] = None
        self._wd_last_dur = 0.0
        # cumulative-counter baselines for on_tick diffs
        self._prev: Dict[str, float] = {}
        # alert name -> {"firing": bool, "value": float, "since": t}
        self._alerts: Dict[str, dict] = {
            name: {"firing": False, "value": 0.0, "since": None}
            for name in ALERT_SEVERITY}
        self.journal: deque = deque(maxlen=journal_len)
        self.fired_total = 0
        self._last_burn = {"fast": 0.0, "slow": 0.0}

    # -- signal intake ------------------------------------------------

    def on_request(self, met: bool) -> None:
        """One retired request: did it meet its SLO end to end?"""
        self._burn.observe(met)

    def on_tick(self, *, tick_s: float, queued: int, step_ema_s: float,
                fallbacks: int = 0, compiles: int = 0,
                spec_emitted: int = 0, spec_verifies: int = 0,
                preemptions: int = 0, completed: int = 0,
                nonfinite: bool = False, compiled: bool = False) -> None:
        """One engine tick.  Counter args are cumulative totals; the
        monitor diffs against its own previous snapshot.  ``compiled``
        marks a tick that included a fresh compile — its wall time is
        excluded from spike detection and the watchdog duration check
        (a first compile is seconds on CPU and would false-positive
        every detector tuned for steady state)."""
        now = self._clock()
        prev, d = self._prev, {}
        for k, v in (("fallbacks", fallbacks), ("compiles", compiles),
                     ("spec_emitted", spec_emitted),
                     ("spec_verifies", spec_verifies),
                     ("preemptions", preemptions),
                     ("completed", completed)):
            d[k] = max(0, v - prev.get(k, 0))
            prev[k] = v
        if not compiled:
            self._wd_last_dur = tick_s
        self._wd_last_end = now

        burn = self._burn.firing()
        rates = self._burn.rates()
        self._last_burn = rates
        self._set("slo_fast_burn", burn["fast"], rates["fast"])
        self._set("slo_slow_burn", burn["slow"], rates["slow"])
        if compiled:
            spike = self._alerts["tick_latency_spike"]["firing"]
        else:
            spike = self._spike.observe(tick_s)
        self._set("tick_latency_spike", spike, tick_s)
        self._set("queue_depth_growth", self._trend.observe(queued),
                  float(queued))
        self._set("kernel_fallback_storm",
                  self._fallback_storm.observe(d["fallbacks"]),
                  float(d["fallbacks"]))
        self._set("recompile_storm",
                  self._recompile_storm.observe(d["compiles"]),
                  float(d["compiles"]))
        if d["spec_verifies"] > 0:
            accept_len = d["spec_emitted"] / d["spec_verifies"]
            self._set("spec_accept_collapse",
                      self._collapse.observe(accept_len), accept_len)
        self._set("host_tier_thrash",
                  self._thrash.observe(d["preemptions"], d["completed"]),
                  float(d["preemptions"]))
        self._set("nonfinite_logits", bool(nonfinite),
                  1.0 if nonfinite else 0.0)
        if not compiled:
            deadline = self.watchdog_deadline_s(step_ema_s)
            if tick_s > deadline:
                self._set("stuck_tick", True, tick_s)

    # -- watchdog -----------------------------------------------------

    def watchdog_deadline_s(self, step_ema_s: float) -> float:
        return max(self._wd_floor_s, self._wd_mult * step_ema_s)

    def watchdog_check(self, step_ema_s: float) -> bool:
        """True when the engine looks wedged: its last completed
        (non-compile) tick blew the deadline.  A synchronous caller
        can only observe a blown deadline post-hoc — a tick that never
        returns stalls the caller too, so wall-age since the last tick
        would only measure the *other* replicas' tick time and
        false-positive.  The alert latches (the caller drains the
        replica; there is no recovery to observe)."""
        stuck = self._wd_last_dur > self.watchdog_deadline_s(step_ema_s)
        if stuck:
            self._set("stuck_tick", True, self._wd_last_dur)
        return stuck

    # -- alert state machine ------------------------------------------

    def _set(self, name: str, firing: bool, value: float) -> None:
        st = self._alerts[name]
        st["value"] = value
        if firing == st["firing"]:
            return
        st["firing"] = firing
        now = self._clock()
        st["since"] = now if firing else None
        sev = ALERT_SEVERITY[name]
        self.journal.append({"t_s": now, "alert": name, "severity": sev,
                             "state": "firing" if firing else "ok",
                             "value": value})
        if firing:
            self.fired_total += 1
            if self._incident is not None:
                try:
                    self._incident.maybe_capture(
                        name, sev, stats_cb=self._stats_cb,
                        trace_cb=self._trace_cb,
                        journal=list(self.journal))
                except Exception:
                    pass  # capture must never take the engine down
            if self._profile_cb is not None:
                try:
                    self._profile_cb()
                except Exception:
                    pass

    # -- reporting ----------------------------------------------------

    def firing(self) -> List[str]:
        return sorted(n for n, st in self._alerts.items() if st["firing"])

    def score(self) -> float:
        """Health in [0, 1]: 1 minus severity penalties for firing
        alerts (page 0.5, warn 0.15), floored at 0."""
        pen = sum(_SCORE_PENALTY[ALERT_SEVERITY[n]] for n in self.firing())
        return max(0.0, 1.0 - pen)

    def burn_rates(self) -> Dict[str, float]:
        """The last computed SLO burn rates, ``{"fast", "slow"}`` —
        the autoscaler's cheap per-tick signal tap: the
        full :meth:`snapshot` copies the journal every call, which is
        too heavy to poll from a control loop."""
        return {"fast": float(self._last_burn.get("fast", 0.0)),
                "slow": float(self._last_burn.get("slow", 0.0))}

    def snapshot(self) -> dict:
        return {
            "health_score": self.score(),
            "alerts_firing": self.firing(),
            "alerts_fired_total": self.fired_total,
            "incidents_captured": (self._incident.captured
                                   if self._incident is not None else 0),
            "burn_rate": {"fast": self._last_burn.get("fast", 0.0),
                          "slow": self._last_burn.get("slow", 0.0)},
            "watchdog": {"last_tick_s": self._wd_last_dur,
                         "floor_s": self._wd_floor_s,
                         "mult": self._wd_mult},
            "alerts": {n: {"firing": st["firing"], "value": st["value"],
                           "since": st["since"],
                           "severity": ALERT_SEVERITY[n]}
                       for n, st in self._alerts.items()},
            "journal": list(self.journal),
        }
