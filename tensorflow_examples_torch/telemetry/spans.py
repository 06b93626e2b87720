"""Span tracer: a host-side timeline of the training loop, exportable as
Chrome trace. The port of ``tensorflow_examples_tpu/telemetry/spans.py``.

``with span("data_fetch"): ...`` brackets a loop phase. Each completed
span becomes a Chrome-trace "complete" event (phase ``"X"``) in a
bounded buffer, written by :meth:`Tracer.write_chrome_trace` (load it in
``chrome://tracing`` or ui.perfetto.dev), and a duration sample in the
registry histogram ``span/<name>``. The open spans of every thread are
readable from another thread (:meth:`Tracer.active_span_names`).

Host-side only: a span around a CUDA launch measures the enqueue, not
the kernel; device time belongs to ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Callable

from tensorflow_examples_torch.telemetry import registry as registry_mod

# Chrome-trace buffer bound: a long run keeps its first events and counts
# the rest as dropped.
MAX_EVENTS = 100_000


class Tracer:
    def __init__(self, *, now_ns: Callable[[], int] = time.perf_counter_ns):
        self._now_ns = now_ns
        self._epoch_ns = self._now_ns()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self.dropped = 0
        self._open: dict[int, list[str]] = {}  # thread id -> open span names

    @contextlib.contextmanager
    def span(self, name: str, **args):
        tid = threading.get_ident()
        t0 = self._now_ns()
        with self._lock:
            self._open.setdefault(tid, []).append(name)
        try:
            yield
        finally:
            t1 = self._now_ns()
            with self._lock:
                stack = self._open.get(tid)
                if stack and stack[-1] == name:
                    stack.pop()
                if len(self._events) < MAX_EVENTS:
                    ev = {"name": name, "ph": "X", "ts": (t0 - self._epoch_ns) / 1e3,
                          "dur": (t1 - t0) / 1e3, "pid": 0, "tid": tid}
                    if args:
                        ev["args"] = args
                    self._events.append(ev)
                else:
                    self.dropped += 1
            registry_mod.default_registry().histogram(f"span/{name}").record((t1 - t0) / 1e9)

    def active_span_names(self) -> list[str]:
        """Innermost open span of every thread that has one."""
        with self._lock:
            return [stack[-1] for stack in self._open.values() if stack]

    def chrome_trace(self) -> dict:
        with self._lock:
            trace = {"traceEvents": list(self._events), "displayTimeUnit": "ms"}
            if self.dropped:
                trace["droppedEventCount"] = self.dropped
        return trace

    def write_chrome_trace(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")


_default = Tracer()


def default_tracer() -> Tracer:
    return _default


def span(name: str, **args):
    """A span on the default tracer."""
    return _default.span(name, **args)


def active_span_names() -> list[str]:
    return _default.active_span_names()
