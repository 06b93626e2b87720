"""Preemption safety and bad-step escalation: the port of
``tensorflow_examples_tpu/train/resilience.py``.

* :class:`PreemptionGuard`: SIGTERM/SIGINT set a flag; the training loop
  notices it at the next step boundary, checkpoints synchronously and
  raises :class:`Preempted`, a ``SystemExit`` with code 0, so a
  preempted CLI run exits cleanly and the next run resumes bit for bit
  (the input order is a function of the step, dropout keys too). A
  second signal while one is pending restores the old handler and
  re-raises, so a wedged run can still be killed.
* :class:`BadStepGuard`: the trainer's step drops a step whose loss or
  gradient norm is not finite on the device and reports ``bad_step``.
  The guard reads those metrics on the host without blocking: each
  step's entry carries a ``torch.cuda.Event`` recorded after it, and
  :meth:`BadStepGuard.poll` consumes only entries whose event has
  completed (on the CPU every entry is ready). It counts consecutive bad
  steps, keeps a loss EMA for spike detection and escalates per
  ``TrainConfig.bad_step_policy``: ``skip`` aborts after
  ``bad_step_patience`` consecutive bad steps, ``rollback`` restores the
  latest checkpoint there (twice onto the same step aborts), ``abort``
  raises at the first bad step, ``off`` has no guard.

The guard publishes ``resilience/bad_steps``, ``resilience/rollbacks``
and ``resilience/steps_lost`` to the registry; the loop counts
``resilience/preemptions``, never the signal handler.
"""

from __future__ import annotations

import collections
import logging
import os
import signal
import threading
from typing import Any

import numpy as np
import torch

from tensorflow_examples_torch.telemetry.registry import default_registry

log = logging.getLogger(__name__)

POLICIES = ("off", "skip", "rollback", "abort")
EMA_DECAY = 0.9  # of the loss EMA that spike detection compares against
MAX_PENDING = 64  # entries waiting before the oldest is read regardless


class Preempted(SystemExit):
    """Clean-exit signal: the checkpoint is saved, the process should
    stop with code 0."""

    def __init__(self, step: int, signum: int | None = None):
        super().__init__(0)
        self.step = step
        self.signum = signum

    def __str__(self):
        name = signal.Signals(self.signum).name if self.signum else "request"
        return f"preempted by {name}; resumable checkpoint at step {self.step}"


class BadStepError(RuntimeError):
    """The bad-step policy decided the run cannot go on."""


class PreemptionGuard:
    """SIGTERM/SIGINT -> "checkpoint at the next step boundary". Installs
    only from the main thread; elsewhere it stays inert."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.requested = False
        self.signum: int | None = None
        self._old: dict[int, Any] = {}

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            log.warning("preemption guard not installed (not on the main thread)")
            return self
        for sig in self.SIGNALS:
            if sig not in self._old:  # installing twice keeps the first old handler
                self._old[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self) -> None:
        for sig, old in self._old.items():
            signal.signal(sig, old)
        self._old.clear()

    def _handle(self, signum, frame):
        if self.requested:
            # A second signal: restore the old handler and re-raise.
            self.uninstall()
            if signal.getsignal(signum) in (self._handle, None):
                signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        self.requested = True
        self.signum = signum
        log.warning("%s received: will checkpoint at the next step boundary and exit cleanly "
                    "(send again to force-quit)", signal.Signals(signum).name)


def _ready(event) -> bool:
    return event is None or event.query()


def _value(x) -> float:
    return float(x) if x is not None else 0.0


class BadStepGuard:
    """Host-side divergence monitor over the step metrics the device
    emits. ``observe`` enqueues a step's (loss, bad_step); ``poll``
    consumes the entries that are done, forcing the oldest once more
    than ``MAX_PENDING`` wait, and all of them with ``drain=True``."""

    def __init__(self, policy: str, *, patience: int = 5, spike_factor: float = 0.0):
        if policy not in POLICIES:
            raise ValueError(f"bad_step_policy={policy!r}; expected one of {POLICIES}")
        self.policy = policy
        self.patience = max(int(patience), 1)
        self.spike_factor = float(spike_factor)
        self._pending: collections.deque = collections.deque()
        self._consecutive = 0
        self._ema: float | None = None
        self.rollbacks = 0
        self.bad_steps_seen = 0
        self._last_rollback_step: int | None = None
        self._last_bad: tuple[int, float] | None = None  # (step, loss)

    @classmethod
    def from_config(cls, cfg) -> "BadStepGuard | None":
        if cfg.bad_step_policy == "off":
            return None
        return cls(cfg.bad_step_policy, patience=cfg.bad_step_patience,
                   spike_factor=cfg.loss_spike_factor)

    def observe(self, step: int, metrics) -> None:
        """Enqueue step ``step``'s metrics (0-d tensors or floats)."""
        loss, bad = metrics.get("loss"), metrics.get("bad_step")
        event = None
        if torch.is_tensor(loss) and loss.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(loss.device))
        self._pending.append((step, loss, bad, event))

    def poll(self, *, drain: bool = False) -> str | None:
        """Inspect finished entries: None, ``"rollback"``, or raises
        :class:`BadStepError` for the abort outcomes."""
        while self._pending:
            step, loss, bad, event = self._pending[0]
            if not (drain or len(self._pending) > MAX_PENDING or _ready(event)):
                break
            self._pending.popleft()
            action = self._inspect(step, _value(loss), _value(bad))
            if action is not None:
                return action
        return None

    def reset(self) -> None:
        """After a rollback: pending entries are of replayed steps."""
        self._pending.clear()
        self._consecutive = 0
        self._ema = None

    def note_rollback(self, restored_step: int) -> None:
        if self._last_rollback_step == restored_step:
            raise BadStepError(f"bad steps recurred after rolling back to step {restored_step} "
                               f"twice - fault is not transient; aborting. {self.status()}")
        self._last_rollback_step = restored_step
        self.rollbacks += 1
        default_registry().counter("resilience/rollbacks").inc()
        # Replayed work past the restored step, net of the consecutive bad
        # steps already counted as bad (goodput's two loss terms).
        if self._last_bad is not None:
            lost = self._last_bad[0] - restored_step - self._consecutive
            if lost > 0:
                default_registry().counter("resilience/steps_lost").inc(lost)
        self.reset()

    def status(self) -> str:
        where = (f"last bad step {self._last_bad[0]} (loss={self._last_bad[1]:g})"
                 if self._last_bad else "no bad step recorded")
        return (f"policy={self.policy} patience={self.patience} "
                f"bad_steps_seen={self.bad_steps_seen} consecutive={self._consecutive} "
                f"rollbacks={self.rollbacks}; {where}")

    def _inspect(self, step: int, loss: float, bad: float) -> str | None:
        is_bad = bad > 0 or not np.isfinite(loss)
        if not is_bad and self.spike_factor > 0 and self._ema is not None:
            is_bad = loss > self.spike_factor * max(abs(self._ema), 1e-8)
        if not is_bad:
            self._consecutive = 0
            self._ema = loss if self._ema is None else (
                EMA_DECAY * self._ema + (1 - EMA_DECAY) * loss)
            return None
        self.bad_steps_seen += 1
        default_registry().counter("resilience/bad_steps").inc()
        self._consecutive += 1
        self._last_bad = (step, loss)
        if self.policy == "abort":
            raise BadStepError(f"bad train step {step} (loss={loss:g}) with policy=abort. "
                               f"{self.status()}")
        if self._consecutive >= self.patience:
            if self.policy == "rollback":
                return "rollback"
            raise BadStepError(f"{self._consecutive} consecutive bad steps ending at {step} "
                               f"exceeded patience={self.patience} with policy=skip. "
                               f"{self.status()}")
        return None
