"""Bounded in-process time-series store: the port of
``tensorflow_examples_tpu/telemetry/timeseries.py``.

One ring a series (``deque(maxlen=capacity)`` of ``(time_unix, value)``),
fed by :meth:`TimeSeriesStore.sample` on the serving process's stats
tick (no thread or clock of its own) and served as JSON at
``GET /series``. A sample walks the registry: every counter becomes a
series of its cumulative value, every gauge one of its value, every
histogram three (``<name>.p50`` / ``.p95`` / ``.p99``). Memory is
``capacity`` points a series. The registry snapshot is taken before the
store's lock, so the store is a leaf in the lock order. Stdlib only.
"""

from __future__ import annotations

import collections
import threading
import time

__all__ = ["TimeSeriesStore"]

_HIST_QS = (("p50", 50.0), ("p95", 95.0), ("p99", 99.0))


def _nearest_rank(sorted_vals: list[float], q: float) -> float | None:
    if not sorted_vals:
        return None
    rank = max(int(-(-(q / 100.0 * len(sorted_vals)) // 1)) - 1, 0)
    return sorted_vals[min(rank, len(sorted_vals) - 1)]


class TimeSeriesStore:
    """Ring-buffered ``{series name: [(time_unix, value), ...]}``."""

    def __init__(self, registry=None, *, capacity: int = 720):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.registry = registry
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._series: dict[str, collections.deque] = {}
        self.samples_taken = 0

    def _append_locked(self, name: str, t: float, v: float) -> None:
        ring = self._series.get(name)
        if ring is None:
            ring = self._series[name] = collections.deque(maxlen=self.capacity)
        ring.append((t, v))

    # ----------------------------------------------------------- write

    def record(self, name: str, value: float, *, now: float | None = None) -> None:
        """Append one point to one named series."""
        t = time.time() if now is None else float(now)
        with self._lock:
            self._append_locked(name, t, float(value))

    def sample(self, *, now: float | None = None) -> int:
        """One sample of the attached registry; returns the points
        appended (0 without a registry)."""
        if self.registry is None:
            return 0
        t = time.time() if now is None else float(now)
        counters = self.registry.counter_values()
        gauges = self.registry.gauge_values()
        hists = self.registry.histogram_summaries()
        points = [(k, float(v)) for k, v in counters.items()]
        points += [(k, float(v)) for k, v in gauges.items()]
        for hname, summ in hists.items():
            for suffix, _q in _HIST_QS:
                v = summ.get(suffix)
                if v is not None:
                    points.append((f"{hname}.{suffix}", float(v)))
        with self._lock:
            for name, v in points:
                self._append_locked(name, t, v)
            self.samples_taken += 1
        return len(points)

    # ------------------------------------------------------------ read

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def series(self, name: str, *, last: int | None = None) -> list:
        """One series' points, oldest first (``last``: the newest N)."""
        with self._lock:
            ring = self._series.get(name)
            pts = list(ring) if ring is not None else []
        if last is not None and last >= 0:
            pts = pts[-last:]
        return pts

    def rollup(self, name: str) -> dict:
        """count/min/max/last and p50/p95/p99 over what the ring holds."""
        vals = sorted(v for _t, v in self.series(name))
        pts = self.series(name, last=1)
        out = {"count": len(vals), "min": vals[0] if vals else None,
               "max": vals[-1] if vals else None, "last": pts[-1][1] if pts else None}
        for suffix, q in _HIST_QS:
            out[suffix] = _nearest_rank(vals, q)
        return out

    def to_payload(self, *, last: int | None = None) -> dict:
        """The ``GET /series`` body: every series' ``[time_unix, value]``
        points, oldest first, per-series rollups and the store's own
        accounting."""
        with self._lock:
            rings = {n: list(self._series[n]) for n in sorted(self._series)}
            taken = self.samples_taken
        if last is not None and last >= 0:
            rings = {n: pts[-last:] for n, pts in rings.items()}
        payload = {"capacity": self.capacity, "samples_taken": taken,
                   "series": {n: [[t, v] for t, v in pts] for n, pts in rings.items()},
                   "rollups": {}}
        for n, pts in rings.items():
            vals = sorted(v for _t, v in pts)
            payload["rollups"][n] = {"count": len(vals), "last": pts[-1][1] if pts else None,
                                     "p50": _nearest_rank(vals, 50.0),
                                     "p95": _nearest_rank(vals, 95.0),
                                     "p99": _nearest_rank(vals, 99.0)}
        return payload
