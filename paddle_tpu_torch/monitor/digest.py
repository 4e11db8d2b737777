"""Bounded-memory streaming quantile digests (the port's copy of
``paddle_tpu/monitor/digest.py``, which imports no JAX) — the always-on
percentiles behind the serving engine's ``host_gap_ms`` and
``spec_accept_len``.

Implementation is the P² algorithm (Jain & Chlamtac, CACM 1985): one
target quantile is tracked by FIVE markers (height + position + desired
position each), adjusted per observation with a piecewise-parabolic
prediction — O(1) memory and O(1) update regardless of stream length,
which is what lets every engine keep four digests hot forever without a
reservoir to resize or a histogram to pre-bucket.

Accuracy: exact until 5 observations (the markers ARE the sorted
sample); after that the estimate converges to the true quantile for
i.i.d. streams, with relative error typically well under a few percent
of the distribution's scale by a few hundred observations (the
``tests/test_tracing.py`` accuracy tests pin 3% of range on uniform /
exponential / normal streams at n=4000). It is an *estimate*: adversarially
ordered streams can bias it, and extreme tails (p999+) need more
observations to settle — for SLO p50/p95/p99 over request latencies it
is the standard tradeoff (same family Prometheus summaries use).
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Tuple

__all__ = ["P2Quantile", "LatencyDigest"]


class P2Quantile:
    """One streaming quantile via the P² algorithm (5 markers)."""

    __slots__ = ("q", "_heights", "_pos", "_want", "_dwant", "_n")

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self._heights = []            # marker heights (sorted)
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._want = [1.0, 1.0 + 2 * q, 1.0 + 4 * q, 3.0 + 2 * q, 5.0]
        self._dwant = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]
        self._n = 0

    def observe(self, x: float):
        x = float(x)
        self._n += 1
        h = self._heights
        if len(h) < 5:                # exact phase: collect + sort
            h.append(x)
            h.sort()
            return
        # locate the cell containing x (clamping the extremes)
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        pos = self._pos
        for i in range(k + 1, 5):
            pos[i] += 1.0
        want = self._want
        for i in range(5):
            want[i] += self._dwant[i]
        # adjust the three interior markers toward desired positions
        for i in (1, 2, 3):
            d = want[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
                    (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                d = 1.0 if d > 0 else -1.0
                # piecewise-parabolic (P²) prediction
                hp = h[i] + d / (pos[i + 1] - pos[i - 1]) * (
                    (pos[i] - pos[i - 1] + d)
                    * (h[i + 1] - h[i]) / (pos[i + 1] - pos[i])
                    + (pos[i + 1] - pos[i] - d)
                    * (h[i] - h[i - 1]) / (pos[i] - pos[i - 1]))
                if not (h[i - 1] < hp < h[i + 1]):
                    # parabola left the bracket: linear fallback
                    j = i + (1 if d > 0 else -1)
                    hp = h[i] + d * (h[j] - h[i]) / (pos[j] - pos[i])
                h[i] = hp
                pos[i] += d

    @property
    def count(self) -> int:
        return self._n

    def value(self) -> float:
        """Current quantile estimate (0.0 before any observation;
        exact linear interpolation of the sample while n < 5)."""
        h = self._heights
        if not h:
            return 0.0
        if len(h) < 5:
            # numpy 'linear' percentile on the exact sorted sample
            idx = self.q * (len(h) - 1)
            lo = int(idx)
            hi = min(lo + 1, len(h) - 1)
            return h[lo] + (idx - lo) * (h[hi] - h[lo])
        return h[2]


class LatencyDigest:
    """A bundle of P² quantiles plus count/sum/min/max — the per-engine
    latency summary (``p50/p95/p99`` by default). Thread-safe; O(1)
    memory and update.

    ``summary()`` is ALWAYS fully keyed (zeros before the first
    observation), so ``stats()`` consumers never KeyError on an idle
    engine.
    """

    DEFAULT_QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)

    def __init__(self, quantiles: Iterable[float] = DEFAULT_QUANTILES):
        qs = tuple(quantiles)
        self._est = {q: P2Quantile(q) for q in qs}
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    @staticmethod
    def _key(q: float) -> str:
        s = f"{100 * q:g}".replace(".", "_")
        return f"p{s}"

    def observe(self, x: float):
        x = float(x)
        with self._lock:
            self._count += 1
            self._sum += x
            self._min = x if self._min is None else min(self._min, x)
            self._max = x if self._max is None else max(self._max, x)
            for est in self._est.values():
                est.observe(x)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def quantile(self, q: float) -> float:
        with self._lock:
            est = self._est.get(q)
            if est is None:
                raise KeyError(f"digest does not track q={q}; "
                               f"tracked: {sorted(self._est)}")
            return est.value()

    def quantiles(self) -> Dict[str, float]:
        """``{"p50": ..., "p95": ..., "p99": ...}`` snapshot."""
        with self._lock:
            return {self._key(q): est.value()
                    for q, est in self._est.items()}

    def summary(self) -> Dict[str, float]:
        """Always-present summary: count, mean, min, max and every
        tracked quantile (all 0.0 while empty)."""
        with self._lock:
            out = {"count": self._count,
                   "mean": self._sum / self._count if self._count
                   else 0.0,
                   "min": self._min or 0.0,
                   "max": self._max or 0.0}
            for q, est in self._est.items():
                out[self._key(q)] = est.value()
            return out
