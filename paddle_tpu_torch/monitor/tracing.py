"""Request-lifecycle span tracer — per-engine timelines the serving
engine (and anything else host-side) records around its hot loop (the
port's copy of ``paddle_tpu/monitor/tracing.py``; its
:class:`ProfilerWindow` arms ``torch.profiler`` where the reference's
arms ``jax.profiler``).

Design constraints, in order:

1. **Lock-cheap on the hot path.** A span is ONE append to a bounded
   ``collections.deque`` under one lock acquisition — begin() carries
   no lock at all (it just captures a monotonic timestamp into a
   tuple), and the record is written only at end(). An engine tick
   emits a handful of spans, each costing one deque.append.
2. **Bounded memory.** The buffer is a ring (``deque(maxlen=...)``,
   default 65536 events, env ``PADDLE_TPU_TRACE_EVENTS``): a
   long-lived engine overwrites its oldest spans instead of growing.
3. **Opt-out kill switch.** ``PADDLE_TPU_TRACE=0`` disables tracing
   entirely; callers are expected to hold ``None`` instead of a Tracer
   and skip every call site (the serving engine does exactly this), so
   the killed hot path executes zero tracer instructions. Tracing is
   pure host code — span calls never enter a captured CUDA graph, so
   enabling/disabling it cannot change engine outputs or graph counts.
4. **Standard viewers.** Export is Chrome trace-event JSON — load the
   file at https://ui.perfetto.dev or chrome://tracing — plus NDJSON
   (one JSON object per event) for ad-hoc grepping. One Tracer is one
   trace-viewer *process* (pid); rows inside it are *threads* (tid):
   the serving engine maps tid 0 to its tick timeline, tid ``1+i`` to
   slot ``i``'s request timeline, and the last tid to the admission
   queue.

Clocks are ``time.monotonic()`` (the same base the serving scheduler
stamps ``submit_time`` with), exported in integer microseconds as the
trace-event spec wants.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import warnings
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from .registry import get_registry

__all__ = ["Tracer", "tracing_enabled", "trace_buffer_capacity",
           "live_tracers", "dump_chrome_trace", "next_flow_id",
           "ProfilerWindow"]

_TRACE_ENV = "PADDLE_TPU_TRACE"
_CAP_ENV = "PADDLE_TPU_TRACE_EVENTS"
_PROFILE_DIR_ENV = "PADDLE_TPU_PROFILE_DIR"

_PIDS = itertools.count(1)
# flow (arrow) ids are PROCESS-unique so a link's two ends — possibly
# recorded by different tracers (the disaggregated handoff's export on
# the prefill engine, import on the decode replica) — resolve in the
# merged trace no matter which engines the spans landed on
_FLOW_IDS = itertools.count(1)
# every live Tracer, so a process-wide dump can merge engines into one
# Perfetto file (each keeps its own pid lane)
_TRACERS: "weakref.WeakSet[Tracer]" = weakref.WeakSet()


def next_flow_id() -> int:
    """Process-unique id for one flow link (see :meth:`Tracer.flow`)."""
    return next(_FLOW_IDS)


def tracing_enabled() -> bool:
    """True unless the operator opted out (``PADDLE_TPU_TRACE=0``)."""
    return os.environ.get(_TRACE_ENV, "1") != "0"


def trace_buffer_capacity() -> int:
    """Ring-buffer capacity in events (``PADDLE_TPU_TRACE_EVENTS``)."""
    try:
        return max(16, int(os.environ.get(_CAP_ENV, 65536)))
    except ValueError:
        return 65536


class Tracer:
    """One trace-viewer process worth of timeline rows.

    Usage::

        tr = Tracer("ServingEngine[0]")
        tr.set_thread(0, "engine")
        with tr.span("tick", tid=0, active=3):
            ...
        tok = tr.begin("prefill chunk", tid=2)
        ...
        tr.end(tok, rows=16)
        tr.dump_chrome_trace("/tmp/serve_trace.json")
    """

    def __init__(self, name: str, pid: Optional[int] = None,
                 capacity: Optional[int] = None):
        self.name = name
        self.pid = next(_PIDS) if pid is None else int(pid)
        self.capacity = int(capacity or trace_buffer_capacity())
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._threads: Dict[int, str] = {}
        self._n_dropped = 0          # events the ring overwrote
        # ring wrap-around is OBSERVABLE — the process-wide counter
        # makes silent truncation a metric, the per-tracer `dropped`
        # property feeds engine stats()
        self._m_dropped = get_registry().counter(
            "trace_events_dropped",
            "span events overwritten by a tracer ring buffer wrapping "
            "(PADDLE_TPU_TRACE_EVENTS capacity) — the flight "
            "recorder's own loss accounting")
        _TRACERS.add(self)

    # -- recording ----------------------------------------------------

    def set_thread(self, tid: int, name: str):
        """Name one timeline row (Perfetto track label)."""
        with self._lock:
            self._threads[int(tid)] = str(name)

    def _append(self, rec):
        with self._lock:
            if len(self._buf) == self.capacity:
                self._n_dropped += 1
                self._m_dropped.inc()
            self._buf.append(rec)

    def emit(self, name: str, tid: int = 0, t0: float = None,
             t1: float = None, args: Optional[dict] = None):
        """Record one complete span over the monotonic-seconds interval
        ``[t0, t1]`` (defaults: a zero-length span at now). The
        explicit-interval form lets a caller blanket several rows with
        one measured interval (e.g. every slot that rode one engine
        tick). ``t1`` defaults to *now*, so ``emit(name, t0=start)``
        is "the span that began at ``start`` just ended"."""
        now = time.monotonic()
        t0 = now if t0 is None else t0
        t1 = now if t1 is None else t1
        self._append(("X", name, int(tid), t0, max(t1 - t0, 0.0),
                      args))

    def instant(self, name: str, tid: int = 0,
                args: Optional[dict] = None):
        """Record a point-in-time marker."""
        self._append(("i", name, int(tid), time.monotonic(), 0.0,
                      args))

    def flow(self, name: str, tid: int = 0, flow_id: int = 0,
             phase: str = "s", args: Optional[dict] = None):
        """Record one end of a FLOW link (a Perfetto arrow between
        spans): ``phase="s"`` starts the flow, ``"f"`` finishes it.
        Both ends share ``flow_id`` (allocate with
        :func:`next_flow_id`); each binds to the slice enclosing its
        (pid, tid, ts), so a disaggregated KV handoff renders as an
        arrow from the prefill slot's request span to the decode
        replica's — across process lanes in a merged trace."""
        if phase not in ("s", "f"):
            raise ValueError(f"flow phase must be 's'|'f', "
                             f"got {phase!r}")
        self._append((phase, name, int(tid), time.monotonic(), 0.0,
                      dict(args or {}, flow_id=int(flow_id))))

    def begin(self, name: str, tid: int = 0, **args):
        """Start a span; returns an opaque token for :meth:`end`.
        Lock-free — nothing is recorded until the span ends."""
        return (name, int(tid), time.monotonic(), args or None)

    def end(self, token, **more_args):
        """Finish a span started by :meth:`begin` (ONE buffer append)."""
        name, tid, t0, args = token
        if more_args:
            args = dict(args or {}, **more_args)
        self._append(("X", name, tid, t0,
                      max(time.monotonic() - t0, 0.0), args))

    @contextlib.contextmanager
    def span(self, name: str, tid: int = 0, **args):
        """Context-manager form of begin/end."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self._append(("X", name, int(tid), t0,
                          max(time.monotonic() - t0, 0.0),
                          args or None))

    # -- introspection ------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    @property
    def dropped(self) -> int:
        """Events the ring buffer overwrote (oldest-first)."""
        with self._lock:
            return self._n_dropped

    def clear(self):
        with self._lock:
            self._buf.clear()
            self._n_dropped = 0

    def events(self) -> List[dict]:
        """Snapshot of the buffered events as plain dicts (monotonic
        seconds), oldest first."""
        with self._lock:
            items = list(self._buf)
        return [{"ph": ph, "name": name, "tid": tid, "t0": t0,
                 "dur": dur, "args": args}
                for ph, name, tid, t0, dur, args in items]

    # -- export -------------------------------------------------------

    def chrome_events(self) -> List[dict]:
        """This tracer's events in Chrome trace-event form: metadata
        rows first (process/thread names), then one ``"X"`` (complete)
        or ``"i"`` (instant) event per record, ``ts``/``dur`` in
        integer microseconds."""
        with self._lock:
            items = list(self._buf)
            threads = dict(self._threads)
        out: List[dict] = [{
            "ph": "M", "pid": self.pid, "tid": 0,
            "name": "process_name", "args": {"name": self.name}}]
        for tid in sorted(threads):
            out.append({"ph": "M", "pid": self.pid, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": threads[tid]}})
            out.append({"ph": "M", "pid": self.pid, "tid": tid,
                        "name": "thread_sort_index",
                        "args": {"sort_index": tid}})
        for ph, name, tid, t0, dur, args in items:
            ev = {"ph": ph, "pid": self.pid, "tid": tid, "name": name,
                  "cat": "paddle_tpu", "ts": int(t0 * 1e6)}
            if ph == "X":
                ev["dur"] = int(dur * 1e6)
            elif ph in ("s", "f"):      # flow start / finish
                a = dict(args or {})
                ev["id"] = a.pop("flow_id", 0)
                if ph == "f":
                    ev["bp"] = "e"      # bind to the enclosing slice
                args = a or None
            else:                       # instant: thread-scoped
                ev["s"] = "t"
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def chrome_trace(self) -> dict:
        """The full Perfetto/chrome://tracing-loadable document."""
        return {"traceEvents": self.chrome_events(),
                "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path: str) -> str:
        """Write the Chrome trace-event JSON to ``path``; returns it."""
        os.makedirs(os.path.dirname(os.path.abspath(path)),
                    exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, default=str)
        return path

    def dump_ndjson(self, path: str) -> str:
        """Write one JSON object per event (grep/jq-friendly twin of
        the Chrome export); returns ``path``."""
        os.makedirs(os.path.dirname(os.path.abspath(path)),
                    exist_ok=True)
        with open(path, "w") as f:
            for ev in self.events():
                f.write(json.dumps(
                    {"pid": self.pid, "tracer": self.name, **ev},
                    default=str) + "\n")
        return path


class ProfilerWindow:
    """Bounded on-demand ``torch.profiler`` capture armed around the
    next N ticks of a host loop (``engine.profile(n)``). ``arm(n_ticks,
    path)`` schedules a capture (``path`` defaults to
    ``PADDLE_TPU_PROFILE_DIR``); the owner brackets each tick with
    ``tick_begin()`` / ``tick_end()`` — the profiler starts before the
    first armed tick and stops after the Nth, so the capture is exactly
    the requested window, never an unbounded always-on trace. A window
    writes one Chrome trace, ``trace-<pid>-<n>.json`` under the path
    (``last_file``): the host's operators, and on CUDA every kernel the
    ticks ran, those replayed from a CUDA graph included.

    Under the ``PADDLE_TPU_TRACE=0`` kill switch ``arm()`` refuses
    (returns None) and the unarmed begin/end calls are integer
    comparisons — the killed hot path runs zero profiler instructions.
    A profiler failure (a concurrent capture: one ``torch.profiler``
    session runs at a time in a process) disarms with a warning instead
    of taking down the serving loop. The ``start``/``stop`` hooks exist
    for tests (and for embedding a different profiler): ``start(dir)``
    begins a capture, ``stop()`` ends it and returns the file written
    (or None); they default to ``torch.profiler`` over the CPU, and the
    card's kernels when CUDA is available."""

    _seq = itertools.count()

    def __init__(self, start=None, stop=None):
        self._start = start
        self._stop = stop
        self._left = 0              # ticks remaining in the window
        self._dir: Optional[str] = None
        self._active = False
        self._prof = None           # the live torch.profiler session
        self.captures = 0           # windows completed
        self.last_dir: Optional[str] = None
        self.last_file: Optional[str] = None

    @property
    def pending(self) -> int:
        """Ticks left in the armed (or running) window (0 = idle)."""
        return self._left

    def arm(self, n_ticks: int, path: Optional[str] = None):
        """Schedule a capture of the next ``n_ticks`` ticks into
        ``path`` (default ``$PADDLE_TPU_PROFILE_DIR``). Returns the
        capture dir, or None under ``PADDLE_TPU_TRACE=0`` (the whole
        flight recorder is inert there). Raises while a window is
        already armed/running — one capture runs at a time."""
        if not tracing_enabled():
            return None
        n = int(n_ticks)
        if n < 1:
            raise ValueError(f"n_ticks must be >= 1, got {n_ticks!r}")
        if self._left or self._active:
            raise RuntimeError(
                "a profiling window is already armed "
                f"({self._left} ticks remaining)")
        path = path or os.environ.get(_PROFILE_DIR_ENV)
        if not path:
            raise ValueError(
                "no profile output dir: pass path= or set "
                f"{_PROFILE_DIR_ENV}")
        self._left = n
        self._dir = str(path)
        return self._dir

    def _torch_start(self, path):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        self._prof = prof

    def _torch_stop(self):
        import torch
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            # the window's last tick may still run on the card
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(self._dir, exist_ok=True)
        out = os.path.join(
            self._dir, f"trace-{os.getpid()}-{next(self._seq)}.json")
        prof.export_chrome_trace(out)
        return out

    def tick_begin(self):
        """Start the capture if a window is armed and not yet live."""
        if self._left <= 0 or self._active:
            return
        try:
            if self._start is not None:
                self._start(self._dir)
            else:
                os.makedirs(self._dir, exist_ok=True)
                self._torch_start(self._dir)
            self._active = True
        except Exception as exc:    # pragma: no cover - profiler quirk
            warnings.warn(f"profiling window disarmed: {exc!r}")
            self._left = 0
            self._dir = None
            self._prof = None

    def tick_end(self):
        """Count one tick off the live window; stop the capture when
        the window is spent. A failed stop disarms but is NOT counted
        as a completed capture (``captures``/``last_dir`` only report
        profiles that were actually written)."""
        if not self._active:
            return
        self._left -= 1
        if self._left > 0:
            return
        try:
            if self._stop is not None:
                out = self._stop()
            else:
                out = self._torch_stop()
        except Exception as exc:    # pragma: no cover - profiler quirk
            warnings.warn(f"profiler stop failed: {exc!r}")
            self._active = False
            self._dir = None
            self._prof = None
            return
        self._active = False
        self.captures += 1
        self.last_dir, self._dir = self._dir, None
        self.last_file = out

    @contextlib.contextmanager
    def tick(self):
        """Bracket ONE tick of the owner's host loop: starts the
        capture if a window is armed, counts the tick off on exit.
        The single call site shape for engines — ``with prof.tick():
        ...`` — so the bracketing semantics cannot drift between
        owners. No-op (beyond an integer check) when idle."""
        if self._left <= 0 and not self._active:
            yield
            return
        self.tick_begin()
        try:
            yield
        finally:
            self.tick_end()


def live_tracers() -> List[Tracer]:
    """Every Tracer still referenced somewhere in the process."""
    return sorted(_TRACERS, key=lambda t: t.pid)


def dump_chrome_trace(path: str,
                      tracers: Optional[List[Tracer]] = None) -> str:
    """Merge ``tracers`` (default: every live tracer) into ONE Chrome
    trace file — each tracer keeps its own pid lane, so a multi-engine
    process shows one process row per engine in Perfetto."""
    events: List[Any] = []
    for tr in (live_tracers() if tracers is None else tracers):
        events.extend(tr.chrome_events())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  default=str)
    return path
