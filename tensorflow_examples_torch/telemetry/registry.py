"""Process-local metrics registry: counters, gauges, time histograms.

The port's own copy of ``tensorflow_examples_tpu/telemetry/registry.py``
(same names, same semantics). The serving engine, KV pools and batcher
publish into a registry; the frontend renders it at ``/metrics``.
Counters are monotonic and cumulative; a gauge is last-write-wins; a
time histogram keeps exact count/sum/min/max for the run and
percentiles over a bounded window of recent samples. Every instrument is
thread-safe.
"""

from __future__ import annotations

import collections
import math
import threading


class Counter:
    """Monotonic cumulative counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) must be >= 0")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value (a single reference store, so
    no lock: racing setters are the semantics)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value: float | None = None

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float | None:
        return self._value


def _nearest_rank(sorted_samples: list[float], q: float) -> float | None:
    """Nearest-rank percentile (q in [0, 100]) over pre-sorted samples."""
    if not sorted_samples:
        return None
    rank = max(int(math.ceil(q / 100.0 * len(sorted_samples))) - 1, 0)
    return sorted_samples[min(rank, len(sorted_samples) - 1)]


class TimeHistogram:
    """Duration distribution: running count/sum/min/max plus the most
    recent ``max_samples`` observations for percentiles."""

    __slots__ = ("name", "count", "total", "min", "max", "_samples", "_lock")

    def __init__(self, name: str, *, max_samples: int = 8192):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: collections.deque = collections.deque(maxlen=max_samples)
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        s = float(seconds)
        with self._lock:
            self.count += 1
            self.total += s
            self.min = min(self.min, s)
            self.max = max(self.max, s)
            self._samples.append(s)

    def summary(self) -> dict:
        with self._lock:
            n, total = self.count, self.total
            lo = self.min if n else None
            hi = self.max if n else None
            samples = sorted(self._samples)
        return {
            "count": n,
            "total": total,
            "mean": (total / n) if n else None,
            "min": lo,
            "max": hi,
            "p50": _nearest_rank(samples, 50),
            "p95": _nearest_rank(samples, 95),
            "p99": _nearest_rank(samples, 99),
        }


class MetricsRegistry:
    """Namespace of instruments: get-or-create by name, read as dicts."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, TimeHistogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str, **kw) -> TimeHistogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = TimeHistogram(name, **kw)
            return h

    def counter_values(self) -> dict[str, int]:
        with self._lock:
            counters = list(self._counters.values())
        return {c.name: c.value for c in counters}

    def gauge_values(self) -> dict[str, float]:
        with self._lock:
            gauges = list(self._gauges.values())
        return {g.name: g.value for g in gauges if g.value is not None}

    def histogram_summaries(self) -> dict[str, dict]:
        with self._lock:
            hists = list(self._histograms.values())
        return {h.name: h.summary() for h in hists}


_default: MetricsRegistry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry library code publishes into."""
    return _default
