"""``paddle_tpu_torch.monitor`` — the port's runtime telemetry
(counterpart of ``paddle_tpu/monitor``; the same names, kinds and
environment switches):

1. **Metrics registry** (``registry.py``): labeled Counter / Gauge /
   Histogram / Info, thread-safe, JSONL export
   (``PADDLE_TPU_METRICS_DIR``), Prometheus text
   (``PADDLE_TPU_METRICS_PROM``) and an atexit text table
   (``PADDLE_TPU_METRICS_DUMP=stdout|stderr``). ``MOE_STATS``
   (``distributed/moe.py``) is served by it.
2. **Step accounting** (``accounting.py``): the FLOPs, bytes and
   launches of one run of a step, counted from its eager run
   (:class:`CostRecorder`), joined with the node census of its captured
   CUDA graph; the card's spec-sheet peaks; the training step's report
   (``record_compiled_step``, ``step_report(s)``, ``analytic_mfu``).
3. **Serving telemetry**: the P² latency digests (``digest.py``), the
   span tracer and on-demand ``torch.profiler`` windows
   (``tracing.py``, ``PADDLE_TPU_TRACE``, ``PADDLE_TPU_PROFILE_DIR``)
   and the health engine (``health.py``, ``PADDLE_TPU_HEALTH``,
   ``PADDLE_TPU_INCIDENT_DIR``) that the serving engine wires in.

Usage::

    from paddle_tpu_torch import monitor
    monitor.counter("my_events", "what happened", labels=("kind",)) \\
        .labels(kind="x").inc()
    print(monitor.report())          # text table
    monitor.export_jsonl("/tmp/m")   # or via PADDLE_TPU_METRICS_DIR
"""
from __future__ import annotations

import atexit
import os
import sys

from .registry import (Counter, Gauge, Histogram, Info, Registry,
                       get_registry, metrics_dir, metrics_enabled,
                       prometheus_path)
from .accounting import (CostRecorder, analytic_mfu, declares,
                         device_peak_flops, device_peak_hbm_bw,
                         executable_cost, kernel_census,
                         record_compiled_step, sample_device_memory,
                         step_report, step_reports)
from .digest import LatencyDigest, P2Quantile
from .tracing import (ProfilerWindow, Tracer, dump_chrome_trace,
                      live_tracers, next_flow_id, tracing_enabled)
from .health import (ALERT_SEVERITY, BurnRateMonitor, CollapseDetector,
                     EwmaSpikeDetector, HealthMonitor, IncidentCapture,
                     RatioDetector, StormDetector, TrendDetector)

__all__ = [
    "Counter", "Gauge", "Histogram", "Info", "Registry",
    "get_registry", "metrics_dir", "metrics_enabled",
    "counter", "gauge", "histogram", "info",
    "export_jsonl", "report", "reset",
    "prometheus_dump", "prometheus_path",
    "LatencyDigest", "P2Quantile", "Tracer", "tracing_enabled",
    "ProfilerWindow", "next_flow_id", "live_tracers", "dump_chrome_trace",
    "CostRecorder", "declares", "kernel_census", "executable_cost",
    "sample_device_memory", "device_peak_flops", "device_peak_hbm_bw",
    "record_compiled_step", "step_report", "step_reports", "analytic_mfu",
    "ALERT_SEVERITY", "BurnRateMonitor", "CollapseDetector",
    "EwmaSpikeDetector", "HealthMonitor", "IncidentCapture",
    "RatioDetector", "StormDetector", "TrendDetector",
]


def counter(name, help="", labels=()) -> Counter:
    return get_registry().counter(name, help, labels)


def gauge(name, help="", labels=()) -> Gauge:
    return get_registry().gauge(name, help, labels)


def histogram(name, help="", labels=(), buckets=None) -> Histogram:
    if buckets is not None:
        return get_registry().histogram(name, help, labels,
                                        buckets=buckets)
    return get_registry().histogram(name, help, labels)


def info(name, help="", labels=()) -> Info:
    return get_registry().info(name, help, labels)


def export_jsonl(path=None):
    """Dump every metric as JSONL; ``path`` defaults to
    ``$PADDLE_TPU_METRICS_DIR``. Returns the file written or None."""
    return get_registry().dump_jsonl(path)


def prometheus_dump(path=None):
    """Render the registry in the Prometheus text exposition format to
    ``path`` (default ``$PADDLE_TPU_METRICS_PROM``; a directory gets
    ``metrics-<pid>.prom``). Returns the file written or None. The
    atexit hook writes this automatically when the env var is set."""
    return get_registry().dump_prometheus(path)


def report() -> str:
    """Human text table of every metric sample."""
    return get_registry().table()


def reset():
    """Clear all samples (test/bench hygiene; metric handles survive)."""
    get_registry().reset()


def _atexit_dump():
    try:
        if metrics_dir():
            get_registry().dump_jsonl()
        if prometheus_path():
            get_registry().dump_prometheus()
        dump = os.environ.get("PADDLE_TPU_METRICS_DUMP")
        if dump:
            stream = sys.stdout if dump == "stdout" else sys.stderr
            print(get_registry().table(), file=stream)
    except Exception:
        pass          # never let telemetry break interpreter shutdown


atexit.register(_atexit_dump)
