"""The Telemetry object a ``Trainer.fit`` owns: the port of the
single-process part of ``tensorflow_examples_tpu/telemetry/hub.py``.

Each log window it snapshots the registry (counters as deltas from the
fit's start, gauges, the step-time histogram) into a schema line
(``telemetry/schema.py``), derives throughput, step-time percentiles,
the 6ND MFU and goodput (``telemetry/accounting.py``), and fans the line
out to the sinks (``telemetry/sinks.py``). ``final_window`` lands the
partial window with an ``exit_reason`` on every exit path; ``close``
writes the span timeline as Chrome-trace JSON and closes the metrics
server. The hub owns the fit's ``MemoryMonitor``
(``telemetry/memory.py``): the fit-start ``kind="memory"`` line, and the
``"memory"`` watermark fields of every window and final line. The
latest window, eval or final line is ``last_line``, which the metrics
server (``telemetry/serve.MetricsServer``, attached as ``server``)
serves at ``/window``. A post-warmup recompile of the training step
(``telemetry/compilation.py``) lands as a ``kind="compile_warning"``
line, a completed profiler window (``telemetry/profiling.py``) rides
the final line as ``"profile"``, and the watchdog's fatal exit calls
``emergency_flush``.

Every window line is followed by a ``kind="fleet"`` line when the hub
has a ``FleetMonitor`` (``telemetry/fleet.py``; ``from_config`` makes
one): the ranks' health vectors allgathered, a collective at every
rank's window. It is ``last_fleet_line``, which the server answers at
``/fleet``; the watchdog's fatal path writes the monitor's cached
snapshot instead, with no collective. On a mesh only rank 0 writes
sinks and the trace (``from_config`` gives any other ``host`` none),
every line carries its rank as ``host``, and the final line carries the
``sharding`` object (``sharding_info``: mesh shape, param-sharding
digest, ZeRO-1).
"""

from __future__ import annotations

import logging
import time
from typing import Mapping

import torch

from tensorflow_examples_torch.telemetry import accounting, schema
from tensorflow_examples_torch.telemetry import memory as memory_mod
from tensorflow_examples_torch.telemetry import registry as registry_mod
from tensorflow_examples_torch.telemetry import sinks as sinks_mod
from tensorflow_examples_torch.telemetry import spans as spans_mod

log = logging.getLogger(__name__)


class Telemetry:
    def __init__(self, sinks: list, *, flops_per_step: float = 0.0,
                 peak_flops_total: float = 0.0, peak_is_estimate: bool = True,
                 tokens_per_example: int = 1, trace_file: str | None = None,
                 flush_every: int = 1, device: torch.device | None = None,
                 memory: memory_mod.MemoryMonitor | None = None, fleet=None, host: int = 0):
        self.sinks = sinks
        self.registry = registry_mod.default_registry()
        self.tracer = spans_mod.default_tracer()
        self.flops_per_step = float(flops_per_step)
        self.peak_flops_total = float(peak_flops_total)
        self.tokens_per_example = max(int(tokens_per_example), 1)
        self.trace_file = trace_file
        self.flush_every = max(int(flush_every), 1)
        self.device = device if device is not None else torch.device("cpu")
        self.memory = memory
        self.fleet = fleet  # a telemetry/fleet.FleetMonitor, or None: no fleet lines
        self.host = int(host)
        self.sharding_info: dict | None = None  # the final line's "sharding" object
        self.server = None  # a started telemetry/serve.MetricsServer, closed with the hub
        self.last_line: dict | None = None  # the latest window, eval or final line
        self.last_fleet_line: dict | None = None
        self._emergency = False  # on the watchdog's fatal path: cached memory fields only
        self._windows_since_flush = 0
        self._closed = False
        self._last_step = 0  # the step of the latest line: labels an emergency flush
        self.profile_info: dict | None = None
        # Counters are process-global; every line carries deltas from here.
        self._counter_base = dict(self.registry.counter_values())
        self._session_start = time.time()
        if self.flops_per_step > 0:
            self.registry.gauge("telemetry/flops_per_step").set(self.flops_per_step)
        if self.peak_flops_total > 0:
            self.registry.gauge("telemetry/peak_flops_total").set(self.peak_flops_total)
            self.registry.gauge("telemetry/peak_is_estimate").set(float(peak_is_estimate))

    @classmethod
    def from_config(cls, cfg, *, n_params: int = 0, device: torch.device | None = None,
                    host: int = 0, n_devices: int = 1) -> "Telemetry":
        """From the TrainConfig's sink spec, trace toggle, flush cadence
        and peak override, and the workload's size; ``host`` is this
        rank (only rank 0 writes files) and ``n_devices`` the mesh's
        size (the MFU's peak is the whole mesh's)."""
        from tensorflow_examples_torch.telemetry import fleet as fleet_mod

        device = device if device is not None else torch.device("cpu")
        primary = host == 0
        sinks = sinks_mod.make_sinks(cfg.telemetry_sinks, cfg.workdir) if primary else []
        # Processed tokens per example: seq_len for token workloads.
        tokens = int(getattr(cfg, "seq_len", 0) or 0) or 1
        if cfg.telemetry_peak_tflops > 0:
            peak, known = cfg.telemetry_peak_tflops * 1e12, True
        else:
            name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
            peak, known = accounting.peak_flops_per_device(name)
        trace = (sinks_mod.trace_path(cfg.workdir)
                 if cfg.workdir and cfg.telemetry_trace and primary else None)
        return cls(sinks, flops_per_step=accounting.train_step_flops(
                       n_params, cfg.global_batch_size, tokens),
                   peak_flops_total=peak * n_devices, peak_is_estimate=not known,
                   tokens_per_example=tokens, trace_file=trace,
                   flush_every=cfg.telemetry_flush_every, device=device,
                   memory=memory_mod.MemoryMonitor(device=device),
                   fleet=fleet_mod.FleetMonitor.from_config(cfg), host=host)

    # ------------------------------------------------------------ intake

    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    def note_steps(self, n: int) -> None:
        """Count stepped work, skipped and replayed steps included."""
        self.registry.counter("train/steps_total").inc(n)

    def record_step_time(self, seconds: float, k: int = 1) -> None:
        """One loop iteration's wall; a bundle of ``k`` steps records its
        per-step share."""
        self.registry.histogram("step_time").record(seconds / max(k, 1))

    # ----------------------------------------------------------- windows

    def fit_counters(self) -> dict[str, int]:
        base = self._counter_base
        return {k: max(v - base.get(k, 0), 0) for k, v in self.registry.counter_values().items()}

    def _derived(self, metrics: Mapping[str, float], counters: Mapping[str, int]) -> dict:
        examples_per_sec = metrics.get("examples_per_sec")
        steps = self.registry.histogram("step_time").summary()
        return {
            "examples_per_sec": examples_per_sec,
            "tokens_per_sec": (examples_per_sec * self.tokens_per_example
                               if examples_per_sec is not None and self.tokens_per_example > 1
                               else None),
            "step_time_p50": steps["p50"],
            "step_time_p95": steps["p95"],
            "goodput": accounting.goodput(counters),
            "mfu": accounting.mfu(self.flops_per_step, metrics.get("steps_per_sec"),
                                  self.peak_flops_total),
        }

    def log_window(self, step: int, metrics: Mapping[str, float], *, prefix: str = "train",
                   kind: str = "window", exit_reason: str | None = None,
                   extra: Mapping | None = None) -> dict:
        """Emit one line to every sink; returns the line."""
        counters = self.fit_counters()
        line = {
            "schema_version": schema.SCHEMA_VERSION,
            "kind": kind,
            "host": self.host,
            "step": int(step),
            "time_unix": time.time(),
            "session_start_unix": self._session_start,
            "metrics": {(f"{prefix}/{k}" if prefix else k): (None if v is None else float(v))
                        for k, v in metrics.items()},
            "counters": counters,
            "gauges": self.registry.gauge_values(),
            "derived": self._derived(metrics, counters),
        }
        if kind == "final":
            line["exit_reason"] = exit_reason or "complete"
            if self.profile_info is not None:
                line["profile"] = dict(self.profile_info)
            if self.sharding_info is not None:
                line["sharding"] = dict(self.sharding_info)
        if self.memory is not None and kind in ("window", "final"):
            try:
                if not self._emergency:
                    self.memory.sample()
                line["memory"] = self.memory.window_fields()
            except Exception:  # pragma: no cover - accounting is best effort
                log.exception("memory sampling failed (continuing)")
        if extra:
            line.update(extra)
        self._last_step = int(step)
        for sink in self.sinks:
            try:
                sink.write(line)
            except Exception:
                log.exception("telemetry sink %s failed to write (continuing)",
                              type(sink).__name__)
        if kind == "fleet":
            self.last_fleet_line = line
        elif kind in ("window", "eval", "final"):
            self.last_line = line  # /window serves scalar lines only
        if kind == "window" and self.fleet is not None:
            self._emit_fleet(step, counters)
        if kind != "fleet":  # the fleet line rides its window's flush
            self._windows_since_flush += 1
            if self._windows_since_flush >= self.flush_every:
                self.flush()
        return line

    def _emit_fleet(self, step: int, counters: Mapping[str, int]) -> None:
        try:
            payload = self.fleet.gather(counters)
        except Exception:  # pragma: no cover - collective teardown races
            log.exception("fleet gather failed (continuing)")
            return
        self.log_window(step, {}, kind="fleet", extra={"fleet": payload})

    def last_window_age(self) -> float | None:
        """Seconds since the last window, eval or final line (``/health``)."""
        if self.last_line is None:
            return None
        return max(time.time() - self.last_line["time_unix"], 0.0)

    def final_window(self, step: int, metrics: Mapping[str, float], *,
                     exit_reason: str) -> dict:
        """The partial in-flight window on an exit path."""
        return self.log_window(step, metrics, kind="final", exit_reason=exit_reason)

    def note_memory_init(self, state, step: int = 0) -> dict | None:
        """The fit-start memory line: params, optimizer, model-state and
        other bytes (``MemoryMonitor.init_breakdown``)."""
        if self.memory is None:
            return None
        try:
            breakdown = self.memory.init_breakdown(state)
        except Exception:  # pragma: no cover - accounting is best effort
            log.exception("memory init snapshot failed (continuing)")
            return None
        return self.log_window(step, {}, kind="memory", extra={"memory": breakdown})

    def compile_warning(self, event: Mapping) -> dict:
        """A post-warmup recompilation as a ``kind="compile_warning"``
        line carrying the sentinel's event (fn, count, wall, delta)."""
        event = dict(event)
        step = int(event.pop("step", self._last_step))
        return self.log_window(step, {}, kind="compile_warning", extra={"compile": event})

    def note_profile(self, info: Mapping) -> None:
        """Link a completed profiler window from the final line."""
        self.profile_info = dict(info)

    def emergency_flush(self) -> None:
        """The watchdog's fatal path, from its own thread while the loop
        is wedged: a final line (exit reason ``watchdog_fatal``, with the
        memory fields of the last sample), the metrics server closed, the
        trace and every sink to disk."""
        self._emergency = True
        if self.fleet is not None:  # the last known fleet state, no collective
            try:
                self.log_window(self._last_step, {}, kind="fleet",
                                extra={"fleet": self.fleet.snapshot(self.fit_counters())})
            except Exception:  # pragma: no cover - the process exits next; best effort
                log.exception("watchdog-fatal fleet snapshot failed")
        try:
            self.final_window(self._last_step, {}, exit_reason="watchdog_fatal")
        except Exception:  # pragma: no cover - the process exits next; best effort
            log.exception("watchdog-fatal final line failed")
        self.close_server()
        self.write_trace()
        self.flush()

    def close_server(self) -> None:
        """Shut the metrics server down (idempotent; every exit path: a
        dead run must not answer scrapes as if live)."""
        server, self.server = self.server, None
        if server is not None:
            try:
                server.close()
            except Exception:  # pragma: no cover - socket teardown races
                log.exception("metrics server close failed (continuing)")

    # ------------------------------------------------------------- flush

    def flush(self) -> None:
        self._windows_since_flush = 0
        for sink in self.sinks:
            try:
                sink.flush()
            except Exception:  # pragma: no cover - sink teardown races
                log.exception("telemetry sink flush failed (continuing)")

    def write_trace(self) -> None:
        if self.trace_file:
            try:
                self.tracer.write_chrome_trace(self.trace_file)
            except Exception:  # pragma: no cover - disk full and the like
                log.exception("chrome trace export failed (continuing)")

    def close(self) -> None:
        """Close the metrics server, write the trace and close every sink;
        idempotent."""
        if self._closed:
            return
        self._closed = True
        self.close_server()
        self.write_trace()
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:  # pragma: no cover - sink teardown races
                log.exception("telemetry sink close failed (continuing)")
