"""Counters / gauges / fixed-bucket histograms with a JSON-exportable registry.

Zero-dependency (numpy only) metrics for the serve path and the engine:

  * :class:`Counter` — monotone float adds.
  * :class:`Gauge`   — last-write-wins value.
  * :class:`Histogram` — fixed exponential buckets, numpy-backed counts, exact
    count/sum/min/max, and percentile estimates by linear interpolation inside
    the containing bucket (error bounded by that bucket's width — the
    tradeoff that keeps ``observe`` O(log n_buckets) and the export tiny).
  * :class:`MetricsRegistry` — name → metric, get-or-create, ``snapshot()``
    dict export and a lossless JSON round-trip (``to_json`` / ``from_json``).

The module-level :data:`REGISTRY` is the default sink (engine mispredict
counters); servers that want isolation construct their own registry.

Thread safety: mutation (``inc``/``set``/``observe``) and registry
get-or-create are lock-protected — the serve loop's worker threads, the
background scrubber (robust/scrub.py), and the hot-swap reloader all write
the same registry. Reads (``snapshot``/``value``) are deliberately
lock-free: a torn multi-field histogram snapshot under concurrent observes
is a monitoring-grade approximation, never a crash.
"""
from __future__ import annotations

import json
import threading
from bisect import bisect_left
from typing import Any

import numpy as np

#: Default latency buckets (milliseconds): 1 µs … ~100 s, ×2 per bucket.
#: The +1th count is the overflow bucket.
DEFAULT_BUCKETS = tuple(float(2.0**k) * 1e-3 for k in range(28))


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self, value: float = 0.0):
        self.value = float(value)
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:  # += on a float is read-modify-write, not atomic
            self.value += n

    def snapshot(self) -> float:
        return self.value


class Gauge:
    __slots__ = ("value", "_lock")

    def __init__(self, value: float = 0.0):
        self.value = float(value)
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Fixed-bucket histogram. ``bounds`` are the inclusive upper edges of the
    first ``len(bounds)`` buckets; values above ``bounds[-1]`` land in the
    overflow bucket (whose upper edge is the observed max)."""

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max", "_lock")

    def __init__(self, bounds=DEFAULT_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        self.counts = np.zeros(len(self.bounds) + 1, np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[bisect_left(self.bounds, v)] += 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def observe_many(self, vs) -> None:
        for v in np.asarray(vs, np.float64).ravel():
            self.observe(float(v))

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (0..100) by linear interpolation
        inside the containing bucket; exact at the observed min/max."""
        if self.count == 0:
            return float("nan")
        rank = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else self.min
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo, hi = max(lo, self.min), min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = min(max((rank - cum) / c, 0.0), 1.0)
                return lo + frac * (hi - lo)
            cum += c
        return self.max

    def snapshot(self) -> dict[str, Any]:
        s: dict[str, Any] = {
            "count": self.count,
            "sum": round(self.sum, 6),
            "bounds": list(self.bounds),
            "counts": self.counts.tolist(),
        }
        if self.count:
            s.update(
                min=self.min, max=self.max,
                p50=self.percentile(50), p95=self.percentile(95),
                p99=self.percentile(99),
            )
        return s


class MetricsRegistry:
    """Named metrics with get-or-create accessors and a JSON round-trip."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str, bounds=DEFAULT_BUCKETS) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.get(name)
                if h is None:
                    h = self._histograms[name] = Histogram(bounds)
        return h

    def counters_with_prefix(self, prefix: str) -> dict[str, float]:
        """Every counter under a dotted namespace (e.g. ``robust.errors.``) —
        the rollup view serve summaries and chaos assertions read."""
        return {
            n: c.snapshot()
            for n, c in sorted(self._counters.items())
            if n.startswith(prefix)
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def snapshot(self) -> dict[str, Any]:
        return {
            "counters": {n: c.snapshot() for n, c in sorted(self._counters.items())},
            "gauges": {n: g.snapshot() for n, g in sorted(self._gauges.items())},
            "histograms": {
                n: h.snapshot() for n, h in sorted(self._histograms.items())
            },
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "MetricsRegistry":
        """Rebuild a registry from :meth:`to_json` output. Percentile
        estimates are recomputed from the bucket counts, so
        ``from_json(r.to_json()).snapshot() == r.snapshot()``."""
        data = json.loads(s)
        reg = cls()
        for n, v in data.get("counters", {}).items():
            reg.counter(n).value = float(v)
        for n, v in data.get("gauges", {}).items():
            reg.gauge(n).set(v)
        for n, h in data.get("histograms", {}).items():
            hist = reg.histogram(n, bounds=h["bounds"])
            hist.counts = np.asarray(h["counts"], np.int64)
            hist.count = int(h["count"])
            hist.sum = float(h["sum"])
            hist.min = float(h.get("min", float("inf")))
            hist.max = float(h.get("max", float("-inf")))
        return reg


#: Default process-wide registry (engine-internal counters land here).
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
