"""Fleet observability, per-rank skew and straggler attribution: the
port of ``tensorflow_examples_tpu/telemetry/fleet.py``.

Every log window each rank builds a small fixed vector of its own health
numbers (step-time p50/p95, data-fetch p95, steps lost, live-memory
peak, io retries, skipped batches, data-work p95; NaN when absent) and
the ranks allgather them over the world group
(``core/distributed.allgather_host``: the same shape on every rank, so
the collective cannot diverge). Every rank then derives the same
summary: per-rank rows, the slowest rank (step-time p95 argmax), the
skew (its p95 over the median of the others), and, when the skew
reaches ``TrainConfig.straggler_skew_factor``, a straggler verdict with
its side: input-side when the rank's input-pipeline excess (``data_work``
p95, else ``data_fetch`` p95) covers half its step-time excess,
compute-side otherwise. The summary is a ``kind="fleet"`` line
(``telemetry/hub.py``), and the primary logs the verdict at WARNING.

One process emits the same line with a one-rank fleet and no
collective. ``snapshot`` is the collective-free payload of abnormal
exits: the last gathered summary, marked ``"emergency": true``.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Mapping

import numpy as np

from tensorflow_examples_torch.telemetry import registry as registry_mod
from tensorflow_examples_torch.telemetry import schema

log = logging.getLogger(__name__)

# The allgathered per-rank vector, in order: the schema's per-host keys.
VECTOR_KEYS = schema.FLEET_HOST_KEYS + schema.FLEET_HOST_KEYS_OPTIONAL

# The straggler is input-side when its input excess covers at least this
# fraction of its step-time excess.
INPUT_SIDE_FRACTION = 0.5


def _finite_median(vals: np.ndarray) -> float:
    finite = vals[np.isfinite(vals)]
    return float(np.median(finite)) if finite.size else float("nan")


def _num(v: float) -> float | int | None:
    """NaN (the wire encoding of 'absent') -> None for the JSONL line."""
    if not math.isfinite(v):
        return None
    return int(v) if float(v).is_integer() else float(v)


class FleetMonitor:
    """Per-fit fleet bookkeeping: one ``gather()`` per log window, a
    collective-free cached ``snapshot()`` for emergency paths.
    ``allgather``, ``process_index`` and ``process_count`` are injectable
    (tests); by default they are the process group's."""

    def __init__(self, *, skew_factor: float = 2.0, registry=None,
                 allgather: Callable[[np.ndarray], np.ndarray] | None = None,
                 process_index: int | None = None, process_count: int | None = None):
        self.skew_factor = float(skew_factor)
        self._registry = registry
        self._allgather = allgather
        self._process_index = process_index
        self._process_count = process_count
        self._last: dict | None = None
        self._warned_hosts: set[int] = set()

    @classmethod
    def from_config(cls, cfg) -> "FleetMonitor":
        return cls(skew_factor=float(getattr(cfg, "straggler_skew_factor", 2.0) or 0.0))

    def _reg(self):
        return self._registry if self._registry is not None else registry_mod.default_registry()

    def _topology(self) -> tuple[int, int]:
        if self._process_index is not None and self._process_count is not None:
            return self._process_index, self._process_count
        from tensorflow_examples_torch.core import distributed

        return distributed.process_index(), distributed.process_count()

    def local_vector(self, counters: Mapping[str, int]) -> np.ndarray:
        """This rank's health vector (``VECTOR_KEYS`` order, NaN =
        absent); ``counters`` are this rank's fit-delta counters."""
        reg = self._reg()
        steps = reg.histogram("step_time").summary()
        step_p50, step_p95 = steps["p50"], steps["p95"]
        fetch_p95 = reg.histogram("span/data_fetch").summary()["p95"]
        work_p95 = reg.histogram("span/data_work").summary()["p95"]
        peak = reg.gauge("memory/peak_live_bytes").value
        nan = float("nan")
        return np.asarray([
            step_p50 if step_p50 is not None else nan,
            step_p95 if step_p95 is not None else nan,
            fetch_p95 if fetch_p95 is not None else nan,
            float(counters.get("resilience/steps_lost", 0)),
            float(peak) if peak is not None else nan,
            float(counters.get("io/retries", 0)),
            float(counters.get("data/batches_skipped", 0)),
            work_p95 if work_p95 is not None else nan,
        ], np.float32)

    def gather(self, counters: Mapping[str, int]) -> dict:
        """Allgather every rank's vector and derive the summary. A
        collective with several ranks: every rank calls it at the same
        window, never on an abnormal-exit path (``snapshot`` there)."""
        vec = self.local_vector(counters)
        index, count = self._topology()
        if count > 1:
            gather = self._allgather
            if gather is None:
                from tensorflow_examples_torch.core.distributed import allgather_host as gather
            matrix = np.asarray(gather(vec), np.float64).reshape(count, len(VECTOR_KEYS))
        else:
            matrix = vec[None, :].astype(np.float64)
        summary = self._summarize(matrix)
        self._last = summary
        if summary["straggler"] and index == 0:
            self._warn(summary)
        return summary

    def _summarize(self, matrix: np.ndarray) -> dict:
        hosts = [{"host": h, **{k: _num(row[i]) for i, k in enumerate(VECTOR_KEYS)}}
                 for h, row in enumerate(matrix)]
        p95 = matrix[:, VECTOR_KEYS.index("step_time_p95")]
        fetch = matrix[:, VECTOR_KEYS.index("data_fetch_p95")]
        work = matrix[:, VECTOR_KEYS.index("data_work_p95")]
        input_sig = np.where(np.isfinite(work), work, fetch)
        summary: dict = {"hosts": hosts, "slowest_host": None, "skew": None, "side": None,
                         "straggler": False}
        if not np.isfinite(p95).any():
            return summary  # no step times yet
        slowest = int(np.nanargmax(p95))
        # The baseline excludes the slowest rank, which would otherwise
        # dilute its own denominator in a small fleet.
        others = np.delete(p95, slowest)
        median_p95 = _finite_median(others if others.size else p95)
        summary["slowest_host"] = slowest
        if median_p95 > 0 and math.isfinite(p95[slowest]):
            skew = float(p95[slowest] / median_p95)
            summary["skew"] = skew
            others_sig = np.delete(input_sig, slowest)
            summary["side"] = self._attribute_side(
                p95[slowest], median_p95, input_sig[slowest],
                _finite_median(others_sig if others_sig.size else input_sig))
            summary["straggler"] = (self.skew_factor > 0 and len(hosts) > 1
                                    and skew >= self.skew_factor)
        return summary

    @staticmethod
    def _attribute_side(host_p95: float, median_p95: float, host_input: float,
                        median_input: float) -> str:
        """Compute- vs input-side: does the rank's input excess explain
        its step-time excess?"""
        step_excess = max(host_p95 - median_p95, 0.0)
        if not math.isfinite(host_input):
            return "compute"
        base_input = median_input if math.isfinite(median_input) else 0.0
        input_excess = max(host_input - base_input, 0.0)
        if step_excess <= 0:
            return "compute"
        return "input" if input_excess >= INPUT_SIDE_FRACTION * step_excess else "compute"

    def _warn(self, summary: dict) -> None:
        host = summary["slowest_host"]
        if host in self._warned_hosts:
            return  # one warning per straggling rank per fit
        self._warned_hosts.add(host)
        entry = summary["hosts"][host]
        work = entry.get("data_work_p95")
        log.warning(
            "FLEET STRAGGLER: host %d step-time p95 %.4fs is %.2fx the fleet median (skew "
            "threshold %.2f) - %s-side (data-work p95 %s, data-fetch p95 %s)",
            host, entry["step_time_p95"] or float("nan"), summary["skew"], self.skew_factor,
            summary["side"], f"{work:.4f}s" if work is not None else "n/a",
            f"{entry['data_fetch_p95']:.4f}s" if entry["data_fetch_p95"] is not None else "n/a")

    def snapshot(self, counters: Mapping[str, int] | None = None) -> dict:
        """A collective-free payload for abnormal exits: the last gathered
        summary, else this rank alone; never blocks."""
        if self._last is not None:
            return dict(self._last, emergency=True)
        try:
            index, _ = self._topology()
        except Exception:  # pragma: no cover - dying anyway; best effort
            index = 0
        vec = self.local_vector(counters or {})
        return {"hosts": [{"host": index, **{k: _num(vec[i]) for i, k in enumerate(VECTOR_KEYS)}}],
                "slowest_host": None, "skew": None, "side": None, "straggler": False,
                "emergency": True}
