"""Labeled metrics registry — the port's telemetry store (its copy of
``paddle_tpu/monitor/registry.py``, which imports no JAX: same metric
kinds, names, export formats and environment switches).

One thread-safe registry every subsystem writes to: the serving
engine's ``serving_*`` metrics, the MoE path counters behind
``MOE_STATS`` (``distributed/moe.py``), the tracer's dropped-event
counter.

Design follows the Prometheus client shape (Counter/Gauge/Histogram
with label children) plus an ``Info`` kind for non-numeric values
(kernel names, reason strings) — but stays dependency-free and adds
``reset()``/``set()`` because this registry also backs trace-time path
counters that tests clear between compilations.

Export is pull-free: ``dump_jsonl()`` writes one JSON record per
(metric, labelset) to ``$PADDLE_TPU_METRICS_DIR/metrics-<pid>.jsonl``,
and an atexit hook (installed by ``paddle_tpu_torch.monitor``) dumps both the
JSONL (when the env var is set) and a text table (when
``PADDLE_TPU_METRICS_DUMP`` is set to ``stdout``/``stderr``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Info", "Registry",
           "get_registry", "metrics_dir", "metrics_enabled",
           "prometheus_path"]

_DIR_ENV = "PADDLE_TPU_METRICS_DIR"
_DUMP_ENV = "PADDLE_TPU_METRICS_DUMP"
_PROM_ENV = "PADDLE_TPU_METRICS_PROM"

# histogram bucket upper bounds (ms-scale spans AND unit-scale ratios
# both fit; +Inf is implicit)
_DEFAULT_BUCKETS = (0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0,
                    1000.0, 5000.0)


def metrics_dir() -> Optional[str]:
    """JSONL export directory, or None when export is disabled."""
    d = os.environ.get(_DIR_ENV)
    return d or None


def metrics_enabled() -> bool:
    """True when the operator opted into the heavier accounting paths
    (explicit export dir, or ``PADDLE_TPU_METRICS=1``)."""
    return bool(metrics_dir() or os.environ.get("PADDLE_TPU_METRICS"))


def prometheus_path() -> Optional[str]:
    """Prometheus text-exposition export path
    (``PADDLE_TPU_METRICS_PROM``), or None when disabled."""
    p = os.environ.get(_PROM_ENV)
    return p or None


# -- Prometheus text-format mangling ----------------------------------
# (the reference's rules, docs/OPS.md "Prometheus exposition")

def _prom_name(name: str) -> str:
    """Metric/label name mangling: any char outside [a-zA-Z0-9_:] maps
    to '_', and a leading digit gets a '_' prefix."""
    out = "".join(c if (c.isascii() and (c.isalnum() or c in "_:"))
                  else "_" for c in str(name))
    if out and out[0].isdigit():
        out = "_" + out
    return out or "_"


def _prom_label_value(value, limit: int = 200) -> str:
    """Escape a label value per the exposition format (backslash,
    double-quote, newline), truncating pathological payloads."""
    s = str(value)
    if len(s) > limit:
        s = s[:limit] + "..."
    return s.replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = list(labels.items()) + list((extra or {}).items())
    if not items:
        return ""
    body = ",".join(f'{_prom_name(k)}="{_prom_label_value(v)}"'
                    for k, v in items)
    return "{" + body + "}"


def _prom_number(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if f != f:                       # NaN: int(f) below would raise
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return repr(f) if f != int(f) else str(int(f))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames=(),
                 registry: "Registry" = None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], Any] = {}
        self._registry = registry

    # -- label plumbing ------------------------------------------------
    def _key(self, labels: Optional[Dict[str, Any]]) -> Tuple[str, ...]:
        labels = labels or {}
        extra = set(labels) - set(self.labelnames)
        if extra:
            raise ValueError(
                f"metric {self.name!r} has labels {self.labelnames}, "
                f"got unknown {sorted(extra)}")
        return tuple(str(labels.get(ln, "")) for ln in self.labelnames)

    def labels(self, **labels) -> "_Child":
        return _Child(self, self._key(labels))

    def reset(self):
        with self._lock:
            self._values.clear()

    # -- collection ----------------------------------------------------
    def _label_dict(self, key) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))

    def collect(self) -> Iterable[dict]:
        with self._lock:
            items = list(self._values.items())
        for key, value in items:
            yield {"name": self.name, "kind": self.kind,
                   "labels": self._label_dict(key),
                   "value": self._export_value(value)}

    def _export_value(self, value):
        return value


class _Child:
    """One labelset of a metric; forwards the write API."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric, key):
        self._metric = metric
        self._key = key

    def inc(self, amount=1):
        return self._metric._inc(self._key, amount)

    def dec(self, amount=1):
        return self._metric._inc(self._key, -amount)

    def set(self, value):
        return self._metric._set(self._key, value)

    def observe(self, value):
        return self._metric._observe(self._key, value)

    def value(self):
        return self._metric._get(self._key)

    def get(self):
        return self._metric._get(self._key)


class Counter(_Metric):
    kind = "counter"

    def _inc(self, key, amount):
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def _set(self, key, value):        # registry-internal resets only
        with self._lock:
            self._values[key] = value

    def _get(self, key):
        with self._lock:
            return self._values.get(key, 0)

    def inc(self, amount=1):
        self._inc(self._key(None), amount)

    def value(self):
        return self._get(self._key(None))


class Gauge(Counter):
    kind = "gauge"

    def set(self, value):
        self._set(self._key(None), value)

    def dec(self, amount=1):
        self._inc(self._key(None), -amount)


class Info(_Metric):
    """Arbitrary JSON-able value (strings, dicts) — kernel names,
    censuses, reason payloads."""
    kind = "info"

    def _set(self, key, value):
        with self._lock:
            self._values[key] = value

    def _get(self, key):
        with self._lock:
            return self._values.get(key)

    def set(self, value):
        self._set(self._key(None), value)

    def get(self):
        return self._get(self._key(None))


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(), registry=None,
                 buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, registry)
        self.buckets = tuple(sorted(buckets))

    def _observe(self, key, value):
        value = float(value)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                st = {"count": 0, "sum": 0.0,
                      "buckets": [0] * (len(self.buckets) + 1)}
                self._values[key] = st
            st["count"] += 1
            st["sum"] += value
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    st["buckets"][i] += 1
                    break
            else:
                st["buckets"][-1] += 1

    def observe(self, value):
        self._observe(self._key(None), value)

    def observe_many(self, values):
        """Bulk observe: bin the whole vector once (numpy) and add the
        counts under ONE lock acquisition — the hot-path form for
        per-step vector observations (e.g. per-expert MoE load), where
        a python observe() loop per element would serialize on the
        lock thousands of times per decode step."""
        import numpy as _np
        values = _np.asarray(values, dtype=float).reshape(-1)
        if values.size == 0:
            return
        idx = _np.searchsorted(_np.asarray(self.buckets), values,
                               side="left")
        binned = _np.bincount(idx, minlength=len(self.buckets) + 1)
        key = self._key(None)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                st = {"count": 0, "sum": 0.0,
                      "buckets": [0] * (len(self.buckets) + 1)}
                self._values[key] = st
            st["count"] += int(values.size)
            st["sum"] += float(values.sum())
            for i, n in enumerate(binned):
                st["buckets"][i] += int(n)

    def _get(self, key):
        with self._lock:
            st = self._values.get(key)
            return dict(st) if st else {"count": 0, "sum": 0.0}

    def value(self):
        return self._get(self._key(None))

    def _export_value(self, st):
        out = {"count": st["count"], "sum": round(st["sum"], 6)}
        if st["count"]:
            out["avg"] = round(st["sum"] / st["count"], 6)
        out["buckets"] = {
            (str(ub) if i < len(self.buckets) else "+Inf"): n
            for i, (ub, n) in enumerate(
                zip(list(self.buckets) + [None], st["buckets"]))}
        return out


class Registry:
    """Get-or-create metric store. One process-wide default instance
    (``get_registry()``); tests may build private ones."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labels=(), **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames=labels, registry=self,
                        **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls) or m.labelnames != tuple(labels):
                raise ValueError(
                    f"metric {name!r} re-registered with different "
                    f"kind/labels ({m.kind}{m.labelnames} vs "
                    f"{cls.kind}{tuple(labels)})")
            return m

    def counter(self, name, help="", labels=()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def info(self, name, help="", labels=()) -> Info:
        return self._get_or_create(Info, name, help, labels)

    def get(self, name) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[dict]:
        with self._lock:
            metrics = list(self._metrics.values())
        out = []
        for m in sorted(metrics, key=lambda m: m.name):
            out.extend(m.collect())
        return out

    def reset(self):
        """Clear every metric's samples (metric objects survive, so
        module-level handles stay valid). Test/benchmark hygiene."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()

    # -- export --------------------------------------------------------
    def dump_jsonl(self, path: Optional[str] = None) -> Optional[str]:
        """Write one JSON record per (metric, labelset). ``path`` may be
        a directory (file name is ``metrics-<pid>.jsonl``) or a file
        path; defaults to ``$PADDLE_TPU_METRICS_DIR``. Returns the file
        written, or None when export is disabled."""
        target = path or metrics_dir()
        if target is None:
            return None
        if os.path.splitext(target)[1] in (".jsonl", ".json"):
            fname = target
            os.makedirs(os.path.dirname(fname) or ".", exist_ok=True)
        else:
            os.makedirs(target, exist_ok=True)
            fname = os.path.join(target,
                                 f"metrics-{os.getpid()}.jsonl")
        ts = time.time()
        with open(fname, "w") as f:
            for rec in self.collect():
                rec["ts"] = ts
                f.write(json.dumps(rec, default=str) + "\n")
        return fname

    def prometheus_text(self) -> str:
        """Render every metric in the Prometheus text exposition format
        (version 0.0.4): ``# HELP`` / ``# TYPE`` headers plus one sample
        line per (metric, labelset). Mangling rules (docs/OPS.md):

        - names/labels: chars outside ``[a-zA-Z0-9_:]`` become ``_``,
          a leading digit gains a ``_`` prefix; registry names are
          otherwise exported verbatim (no ``_total`` suffixing).
        - histograms: the registry's per-bin counts are re-rendered as
          the CUMULATIVE ``<name>_bucket{le="..."}`` series Prometheus
          expects, plus ``<name>_sum`` / ``<name>_count``.
        - Info metrics (non-numeric) export as ``<name>_info ... 1``
          gauges carrying the JSON-ish payload in a ``value`` label
          (truncated at 200 chars).
        """
        out: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: m.name)
        for m in metrics:
            pname = _prom_name(m.name)
            with m._lock:
                items = list(m._values.items())
            if not items:
                continue
            # info families are exported as <name>_info samples — the
            # HELP must name the family the samples belong to
            fam = f"{pname}_info" if m.kind == "info" else pname
            if m.help:
                # HELP lines escape only backslash + newline
                h = str(m.help).replace("\\", "\\\\") \
                    .replace("\n", "\\n")
                out.append(f"# HELP {fam} {h}")
            if m.kind == "info":
                out.append(f"# TYPE {pname}_info gauge")
                for key, value in items:
                    lbl = _prom_labels(m._label_dict(key),
                                       {"value": json.dumps(
                                           value, default=str)})
                    out.append(f"{pname}_info{lbl} 1")
                continue
            if m.kind == "histogram":
                out.append(f"# TYPE {pname} histogram")
                for key, st in items:
                    base = m._label_dict(key)
                    cum = 0
                    for ub, n in zip(list(m.buckets) + [None],
                                     st["buckets"]):
                        cum += n
                        le = "+Inf" if ub is None else _prom_number(ub)
                        lbl = _prom_labels(base, {"le": le})
                        out.append(f"{pname}_bucket{lbl} {cum}")
                    lbl = _prom_labels(base)
                    out.append(f"{pname}_sum{lbl} "
                               f"{_prom_number(st['sum'])}")
                    out.append(f"{pname}_count{lbl} {st['count']}")
                continue
            # counter / gauge (untyped values export as gauge)
            kind = m.kind if m.kind in ("counter", "gauge") else "gauge"
            out.append(f"# TYPE {pname} {kind}")
            for key, value in items:
                lbl = _prom_labels(m._label_dict(key))
                out.append(f"{pname}{lbl} {_prom_number(value)}")
        return "\n".join(out) + ("\n" if out else "")

    def dump_prometheus(self, path: Optional[str] = None
                        ) -> Optional[str]:
        """Write the text exposition to ``path`` (default
        ``$PADDLE_TPU_METRICS_PROM``; a directory gets
        ``metrics-<pid>.prom``). Returns the file written, or None when
        export is disabled. The atexit hook in ``paddle_tpu_torch.monitor``
        calls this next to the JSONL dump — point a node_exporter
        textfile collector (or a scrape-side cat) at the file."""
        target = path or prometheus_path()
        if target is None:
            return None
        if os.path.splitext(target)[1]:
            fname = target
            os.makedirs(os.path.dirname(fname) or ".", exist_ok=True)
        else:
            os.makedirs(target, exist_ok=True)
            fname = os.path.join(target,
                                 f"metrics-{os.getpid()}.prom")
        with open(fname, "w") as f:
            f.write(self.prometheus_text())
        return fname

    def table(self) -> str:
        """Formatted text table of every sample (atexit human dump)."""
        rows = []
        for rec in self.collect():
            lbl = ",".join(f"{k}={v}" for k, v in rec["labels"].items())
            val = rec["value"]
            if isinstance(val, dict):     # histogram summary
                val = (f"count={val.get('count')} "
                       f"avg={val.get('avg', 0)}")
            rows.append([rec["name"], rec["kind"], lbl, str(val)])
        if not rows:
            return "metrics: (empty)"
        headers = ["metric", "kind", "labels", "value"]
        widths = [max(len(h), *(len(r[i]) for r in rows))
                  for i, h in enumerate(headers)]
        sep = "-+-".join("-" * w for w in widths)
        lines = ["Telemetry Metrics", sep,
                 " | ".join(h.ljust(w) for h, w in zip(headers, widths)),
                 sep]
        for r in rows:
            lines.append(" | ".join(c.ljust(w)
                                    for c, w in zip(r, widths)))
        lines.append(sep)
        return "\n".join(lines)


_REGISTRY = Registry()


def get_registry() -> Registry:
    return _REGISTRY
