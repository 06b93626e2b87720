"""Failure detection and crash diagnostics: a jax-free copy of
``tensorflow_examples_tpu/utils/diagnostics.py``.

* :func:`install_crash_handlers`: faulthandler tracebacks for hard
  faults (SIGSEGV, SIGABRT) written to ``workdir/debugging/``.
* :class:`Watchdog`: a daemon thread the training loop pings every step.
  If no progress comes for ``timeout_s`` it dumps every Python thread's
  stack, naming the loop phase (``enter("input_fetch")``,
  ``enter("device_step")``, ``enter("log_flush")``) and the open
  telemetry spans, so the dump says whether the input pipeline or the
  device stalled. Detection only by default; with
  ``fatal_timeout_s > 0`` a stall that long dumps, runs ``flush_fn``
  and exits the process with :data:`HUNG_EXIT_CODE`.
"""

from __future__ import annotations

import faulthandler
import io
import logging
import os
import sys
import threading
import time
from typing import Callable

from tensorflow_examples_torch.telemetry.spans import active_span_names

log = logging.getLogger(__name__)

_fault_file = None  # faulthandler holds exactly one target


def install_crash_handlers(workdir: str = "") -> None:
    """Route hard-fault tracebacks to ``workdir/debugging/faults_<pid>.log``
    (stderr without a workdir, when stderr is a file). Idempotent."""
    global _fault_file
    if workdir:
        debug_dir = os.path.join(workdir, "debugging")
        os.makedirs(debug_dir, exist_ok=True)
        path = os.path.join(debug_dir, f"faults_{os.getpid()}.log")
        if _fault_file is None or _fault_file.name != path:
            if _fault_file is not None:
                _fault_file.close()
            _fault_file = open(path, "w")  # noqa: SIM115 - outlives the call
        faulthandler.enable(file=_fault_file)
        log.info("hard-fault tracebacks -> %s", path)
    else:
        try:
            faulthandler.enable()
        except (io.UnsupportedOperation, AttributeError, ValueError):  # stderr is no file
            log.warning("stderr has no file descriptor: hard-fault tracebacks stay off")


# Exit code of a watchdog-terminated run: apart from clean exits (0),
# Python errors (1) and signal deaths (128 + N).
HUNG_EXIT_CODE = 87


class Watchdog:
    """Detects training-loop hangs; dumps all thread stacks once per hang.

    ``ping(step)`` after each step; ``enter(phase)`` marks a loop phase and
    counts as a heartbeat; ``pause``/``resume`` bracket phases that are
    slow by design (the first step, a CUDA graph capture, eval, a
    checkpoint save). With ``fatal_timeout_s > 0`` a stall that long runs
    the dump, ``flush_fn`` and then ``on_fatal(step, stalled_s)``
    (default ``os._exit(HUNG_EXIT_CODE)``: the main thread is wedged,
    perhaps inside a C call no exception could interrupt)."""

    def __init__(self, timeout_s: float, *, fatal_timeout_s: float = 0.0,
                 on_hang: Callable[[int, float], None] | None = None,
                 on_fatal: Callable[[int, float], None] | None = None,
                 flush_fn: Callable[[], None] | None = None, poll_s: float | None = None):
        self.timeout_s = timeout_s
        self.fatal_timeout_s = fatal_timeout_s
        self._on_hang = on_hang
        self._on_fatal = on_fatal
        self._flush_fn = flush_fn
        self._poll_s = poll_s if poll_s is not None else min(timeout_s / 4, 30.0)
        if fatal_timeout_s > 0:
            self._poll_s = min(self._poll_s, max(fatal_timeout_s / 4, 0.05))
        self._last_ping = time.monotonic()
        self._last_step = -1
        self._phase = "startup"
        self._phase_since = time.monotonic()
        self._paused = False
        self._fired_for = -2  # the last step a hang was reported for
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._run, name="train-watchdog", daemon=True)
        self._thread.start()
        return self

    def ping(self, step: int) -> None:
        self._last_ping = time.monotonic()
        self._last_step = step

    def enter(self, phase: str) -> None:
        """Mark a loop phase; a phase transition is progress, so this
        refreshes the heartbeat (not the step)."""
        now = time.monotonic()
        self._phase = phase
        self._phase_since = now
        self._last_ping = now

    def status(self) -> dict:
        now = time.monotonic()
        return {"phase": self._phase, "phase_age_secs": now - self._phase_since,
                "stalled_secs": now - self._last_ping, "last_step": self._last_step,
                "paused": self._paused, "timeout_secs": self.timeout_s,
                "fatal_timeout_secs": self.fatal_timeout_s}

    def pause(self) -> None:
        """Suspend detection; the timer restarts at the next resume."""
        self._paused = True

    def resume(self) -> None:
        # The ping first: the watcher must never see "unpaused" with a
        # stale timestamp.
        self._last_ping = time.monotonic()
        self._paused = False

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _dump(self, stalled: float, *, fatal: bool) -> None:
        log.error("WATCHDOG%s: no training progress for %.1fs (last step %d, phase %r for "
                  "%.1fs, open spans %s) - dumping all thread stacks", " FATAL" if fatal else "",
                  stalled, self._last_step, self._phase, time.monotonic() - self._phase_since,
                  active_span_names())
        faulthandler.dump_traceback(file=sys.stderr)
        if _fault_file is not None:
            faulthandler.dump_traceback(file=_fault_file)
            _fault_file.flush()

    def _run(self) -> None:
        fatal_fired = False
        while not self._stop.wait(self._poll_s):
            if self._paused:
                continue
            stalled = time.monotonic() - self._last_ping
            fatal_now = (self.fatal_timeout_s > 0 and stalled >= self.fatal_timeout_s
                         and not fatal_fired)
            if not fatal_now and stalled >= self.timeout_s and self._fired_for != self._last_step:
                self._fired_for = self._last_step
                self._dump(stalled, fatal=False)
                if self._on_hang is not None:
                    self._on_hang(self._last_step, stalled)
            if fatal_now:
                fatal_fired = True
                self._dump(stalled, fatal=True)
                if self._flush_fn is not None:
                    try:
                        self._flush_fn()
                    except Exception:  # pragma: no cover - best effort before the exit
                        log.exception("pre-exit telemetry flush failed")
                if self._on_fatal is not None:
                    self._on_fatal(self._last_step, stalled)
                else:
                    log.critical("WATCHDOG: failing fast with exit code %d rather than hanging",
                                 HUNG_EXIT_CODE)
                    if _fault_file is not None:
                        _fault_file.flush()
                    os._exit(HUNG_EXIT_CODE)
