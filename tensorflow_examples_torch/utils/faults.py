"""Deterministic fault injection and bounded-retry IO: a jax-free copy of
``tensorflow_examples_tpu/utils/faults.py`` (the training half and the
serving half).

Fault specs are comma-separated ``kind@arg`` tokens, deterministic by
construction (keyed on step or fetch index, never wall clock), read from
the same ``TPU_FAULT_INJECT`` variable as the reference:

  ``sigterm@N``    deliver SIGTERM to this process right before train
                   step N runs (the loop finishes the in-flight chunk,
                   checkpoints and exits cleanly with code 0).
  ``nan@N``        poison the float leaves of step N's batch with NaN.
  ``nan@N:M``      ... for M consecutive steps starting at N.
  ``slow@N:S``     sleep S seconds while fetching train-pipeline batch
                   number N (0-based fetch index; eval fetches opt out).
                   With ``steps_per_launch=k > 1`` the pipeline fetches
                   k-batch bundles, so index N is the Nth bundle; the
                   same holds for ``badbatch@N``.
  ``ioerr@K``      the first K filesystem operations routed through
                   ``retry_io`` raise OSError.
  ``badbatch@N``   corrupt host batch number N so its host-to-device
                   transfer fails (the poisoned-batch skip counter).

Each step- or index-keyed fault fires once: a rollback that replays step
N does not re-poison it. ``install(spec)`` arms a plan in-process; else
``active()`` reads the environment variable on its first call.

**Serving faults.** The serving tier has its own plan: the failure unit
is a replica, so specs are ``kind@replica:arg`` tokens read from
``TPU_SERVE_FAULT_INJECT`` (or ``serve_install``), keyed on each
replica's own decode-step and request counters, never wall clock:

  ``crash@R:N``      replica R dies before its Nth decode step (0-based):
                     its registered crash callback (``register_serve_crash``)
                     resets its frontend's connections and the step raises
                     :class:`InjectedCrash`.
  ``slowrep@R:S``    every decode step on replica R sleeps S seconds.
  ``transport@R:K``  the first K POST requests replica R's frontend
                     receives are dropped with no response bytes.
  ``kvexhaust@R:N``  replica R's Nth decode step raises a forced
                     ``BlockExhausted`` naming the step's slots.
  ``badhealth@R:K``  replica R's next K ``/health`` answers are non-JSON
                     garbage with a 200.
  ``killrouter@T``   parsed for the router (the fleet control plane,
                     not ported yet).

A prefill-role replica counts prefills where other roles count decode
steps (``engine._prefill_fault_tick``).
"""

from __future__ import annotations

import dataclasses
import gzip
import logging
import os
import signal
import threading
import time
from typing import Callable

import numpy as np
import torch

from tensorflow_examples_torch.telemetry.registry import default_registry

log = logging.getLogger(__name__)

ENV_VAR = "TPU_FAULT_INJECT"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    sigterm_at: frozenset[int] = frozenset()
    nan_at: frozenset[int] = frozenset()  # expanded: nan@N:M -> {N..N+M-1}
    slow_at: dict[int, float] = dataclasses.field(default_factory=dict)
    io_errors: int = 0
    bad_batch_at: frozenset[int] = frozenset()


def parse_spec(spec: str) -> FaultPlan:
    """Parse ``"sigterm@10,nan@5:2,slow@3:8,ioerr@2,badbatch@1"``."""
    kinds = ("sigterm", "nan", "slow", "ioerr", "badbatch")
    sigterm, nan, slow, bad = set(), set(), {}, set()
    io_errors = 0
    for token in filter(None, (t.strip() for t in spec.split(","))):
        kind, _, arg = token.partition("@")
        if kind not in kinds:
            raise ValueError(f"unknown fault kind {kind!r} (one of {'/'.join(kinds)})")
        if not arg:
            raise ValueError(f"fault token {token!r} needs '@<arg>'")
        head, _, tail = arg.partition(":")
        try:
            if kind == "sigterm":
                sigterm.add(int(head))
            elif kind == "nan":
                start, count = int(head), int(tail) if tail else 1
                nan.update(range(start, start + count))
            elif kind == "slow":
                slow[int(head)] = float(tail) if tail else 5.0
            elif kind == "ioerr":
                io_errors += int(head)
            else:
                bad.add(int(head))
        except ValueError as e:
            raise ValueError(f"malformed fault token {token!r}: {e}") from None
    return FaultPlan(sigterm_at=frozenset(sigterm), nan_at=frozenset(nan), slow_at=slow,
                     io_errors=io_errors, bad_batch_at=frozenset(bad))


class _Unconvertible:
    """A leaf no tensor can be made from: the poisoned-batch payload."""

    def __repr__(self):  # pragma: no cover - repr only surfaces in logs
        return "<injected-corrupt-leaf>"


def _is_float(x) -> bool:
    if torch.is_tensor(x):
        return torch.is_floating_point(x)
    return np.issubdtype(np.asarray(x).dtype, np.floating)


class Engine:
    """Runtime state of one armed FaultPlan (counters, fired-once sets)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._fetch_idx = 0
        self._io_fails_left = plan.io_errors
        self._fired_sigterm: set[int] = set()
        self._fired_nan: set[int] = set()
        self._fired_bad: set[int] = set()
        self._fired_slow: set[int] = set()

    # ----------------------------------------------------- loop-side hooks

    def step_hook(self, first_step: int, k: int = 1) -> None:
        """At the top of each train chunk covering steps
        ``[first_step, first_step + k)``."""
        for s in range(first_step, first_step + k):
            if s in self.plan.sigterm_at and s not in self._fired_sigterm:
                self._fired_sigterm.add(s)
                log.warning("FAULT: delivering SIGTERM before step %d", s)
                os.kill(os.getpid(), signal.SIGTERM)

    def nan_hook(self, first_step: int, k: int, batch):
        """Poison the float leaves of any planned step in the chunk (a
        bundle's leaves are [k, ...]: only the planned rows)."""
        hits = [s in self.plan.nan_at and s not in self._fired_nan
                for s in range(first_step, first_step + k)]
        if not any(hits):
            return batch
        steps = [first_step + i for i, hit in enumerate(hits) if hit]
        self._fired_nan.update(steps)
        floats = [key for key, x in batch.items() if _is_float(x)]
        if not floats:
            raise RuntimeError(
                f"nan fault requested for step {steps} but the batch has no float leaves to "
                "poison (token-only workloads cannot carry a NaN input)")
        mult = np.ones(k, np.float32)
        mult[[i for i, hit in enumerate(hits) if hit]] = np.nan

        def poison(x):
            scale = mult[0] if k == 1 else mult.reshape((k,) + (1,) * (np.ndim(x) - 1))
            if torch.is_tensor(x):
                return x * torch.as_tensor(scale, dtype=x.dtype).to(x.device)
            return x * scale

        log.warning("FAULT: poisoned batch floats with NaN for steps %s", steps)
        return {key: poison(x) if key in floats else x for key, x in batch.items()}

    # ------------------------------------------------------ data-side hooks

    def batch_hook(self, batch):
        """Once per host batch fetch, before the host-to-device transfer.
        May sleep (slow) or corrupt (badbatch)."""
        idx = self._fetch_idx
        self._fetch_idx += 1
        s = self.plan.slow_at.get(idx)
        if s is not None and idx not in self._fired_slow:
            self._fired_slow.add(idx)
            log.warning("FAULT: stalling batch fetch %d for %.1fs", idx, s)
            time.sleep(s)
        if idx in self.plan.bad_batch_at and idx not in self._fired_bad:
            self._fired_bad.add(idx)
            log.warning("FAULT: corrupting batch fetch %d", idx)
            return {k: _Unconvertible() for k in batch}
        return batch

    def io_check(self, what: str) -> None:
        """Per filesystem attempt inside ``retry_io``."""
        if self._io_fails_left > 0:
            self._io_fails_left -= 1
            raise OSError(f"injected io error for {what} ({self._io_fails_left} more to come)")


_engine: Engine | None = None
_env_checked = False


def install(spec_or_plan: str | FaultPlan) -> Engine:
    """Arm a fault plan in-process."""
    global _engine, _env_checked
    plan = parse_spec(spec_or_plan) if isinstance(spec_or_plan, str) else spec_or_plan
    _engine = Engine(plan)
    _env_checked = True
    return _engine


def clear() -> None:
    global _engine, _env_checked
    _engine = None
    _env_checked = False


def active() -> Engine | None:
    """The armed engine, read from ``$TPU_FAULT_INJECT`` on first call."""
    global _engine, _env_checked
    if _engine is None and not _env_checked:
        _env_checked = True
        spec = os.environ.get(ENV_VAR, "")
        if spec:
            _engine = Engine(parse_spec(spec))
            log.info("fault injection armed from $%s=%s", ENV_VAR, spec)
    return _engine


# ------------------------------------------------------------ IO retries

# Defaults; ``train/cli.py`` sets them from TrainConfig (io_retries,
# io_backoff_secs) through configure_io_retry.
_io_retry = {"attempts": 3, "backoff": 0.25}


def configure_io_retry(attempts: int, backoff_secs: float) -> None:
    _io_retry["attempts"] = max(int(attempts), 0)
    _io_retry["backoff"] = max(float(backoff_secs), 0.0)


def retry_io(fn: Callable, what: str, *, attempts: int | None = None,
             backoff_secs: float | None = None, sleep: Callable[[float], None] = time.sleep):
    """Run a filesystem operation with bounded retry and exponential
    backoff (``backoff * 2**attempt``). Retries only OSError (a corrupt
    gzip stream is data, not a flaky store, and raises at once);
    ``attempts`` counts the retries after the first try. An armed fault
    engine's ``io_check`` runs before each attempt; each retry counts in
    ``io/retries``."""
    attempts = _io_retry["attempts"] if attempts is None else attempts
    backoff = _io_retry["backoff"] if backoff_secs is None else backoff_secs
    for attempt in range(attempts + 1):
        try:
            eng = active()
            if eng is not None:
                eng.io_check(what)
            return fn()
        except OSError as e:
            if isinstance(e, gzip.BadGzipFile) or attempt >= attempts:
                raise
            default_registry().counter("io/retries").inc()
            delay = backoff * (2**attempt)
            log.warning("io error on %s (attempt %d/%d), retrying in %.2fs: %s", what,
                        attempt + 1, attempts + 1, delay, e)
            sleep(delay)


# ------------------------------------------------------- serving faults

SERVE_ENV_VAR = "TPU_SERVE_FAULT_INJECT"

SERVE_KINDS = ("crash", "slowrep", "transport", "kvexhaust", "badhealth", "killrouter")


class InjectedCrash(RuntimeError):
    """Raised inside a replica's decode step by a ``crash@R:N`` fault: the
    serving loop fails the in-flight batch as after any step error, but
    the replica's transport is already dead, so clients see a reset."""


@dataclasses.dataclass(frozen=True)
class ServeFaultPlan:
    crash_at: dict[int, int] = dataclasses.field(default_factory=dict)
    slow_replica: dict[int, float] = dataclasses.field(default_factory=dict)
    transport_drop: dict[int, int] = dataclasses.field(default_factory=dict)
    kvexhaust_at: dict[int, int] = dataclasses.field(default_factory=dict)
    bad_health: dict[int, int] = dataclasses.field(default_factory=dict)
    kill_router_at: int | None = None  # killrouter@T: the router's fault


def parse_serve_spec(spec: str) -> ServeFaultPlan:
    """Parse ``"crash@1:4,slowrep@0:0.2,transport@2:1,badhealth@0:3"``
    (``kind@replica:arg`` tokens, comma separated; ``killrouter@T`` takes
    no replica index)."""
    crash: dict[int, int] = {}
    slow: dict[int, float] = {}
    transport: dict[int, int] = {}
    kvex: dict[int, int] = {}
    badhealth: dict[int, int] = {}
    kill_router_at: int | None = None
    for token in filter(None, (t.strip() for t in spec.split(","))):
        kind, _, arg = token.partition("@")
        if kind not in SERVE_KINDS:
            raise ValueError(f"unknown serve fault kind {kind!r} (one of {'/'.join(SERVE_KINDS)})")
        if kind == "killrouter":
            try:
                kill_router_at = int(arg)
            except ValueError:
                raise ValueError(f"malformed serve fault token {token!r}: "
                                 "killrouter needs '@<dispatch count>'") from None
            continue
        head, sep, tail = arg.partition(":")
        if not head or not sep or not tail:
            raise ValueError(f"serve fault token {token!r} needs '@<replica>:<arg>'")
        try:
            replica = int(head)
            if kind == "crash":
                crash[replica] = int(tail)
            elif kind == "slowrep":
                slow[replica] = float(tail)
            elif kind == "transport":
                transport[replica] = int(tail)
            elif kind == "kvexhaust":
                kvex[replica] = int(tail)
            else:
                badhealth[replica] = int(tail)
        except ValueError as e:
            raise ValueError(f"malformed serve fault token {token!r}: {e}") from None
    return ServeFaultPlan(crash_at=crash, slow_replica=slow, transport_drop=transport,
                          kvexhaust_at=kvex, bad_health=badhealth, kill_router_at=kill_router_at)


class ServeEngine:
    """Runtime state of one armed :class:`ServeFaultPlan` (per-replica
    counters, fired-once sets). Every hook takes the lock: decode hooks
    run on each replica's batcher thread, transport and health hooks on
    frontend handler threads."""

    def __init__(self, plan: ServeFaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._decode_steps: dict[int, int] = {}
        self._transport_left = dict(plan.transport_drop)
        self._health_left = dict(plan.bad_health)
        self._fired_crash: set[int] = set()
        self._fired_kvex: set[int] = set()
        self.fired: list[tuple[str, int, int]] = []  # (kind, replica, index)

    def decode_step(self, replica: int, slots) -> None:
        """Called at the top of every decode step; may sleep (slowrep),
        raise a forced BlockExhausted (kvexhaust) or kill the replica and
        raise InjectedCrash (crash)."""
        with self._lock:
            step = self._decode_steps.get(replica, 0)
            self._decode_steps[replica] = step + 1
            delay = self.plan.slow_replica.get(replica)
            crash = self.plan.crash_at.get(replica) == step and replica not in self._fired_crash
            kvex = (self.plan.kvexhaust_at.get(replica) == step
                    and replica not in self._fired_kvex)
            if crash:
                self._fired_crash.add(replica)
                self.fired.append(("crash", replica, step))
            if kvex:
                self._fired_kvex.add(replica)
                self.fired.append(("kvexhaust", replica, step))
            kill = _serve_crash_cbs.get(replica)
        if delay:
            log.warning("SERVE FAULT: replica %d decode step %d sleeping %.2fs",
                        replica, step, delay)
            time.sleep(delay)
        if kvex:
            from tensorflow_examples_torch.serving.paged_kv import BlockExhausted

            log.warning("SERVE FAULT: forced BlockExhausted on replica %d decode step %d "
                        "(slots %s)", replica, step, list(slots))
            raise BlockExhausted(f"injected KV block exhaustion on replica {replica}",
                                 slots=tuple(slots))
        if crash:
            log.warning("SERVE FAULT: crashing replica %d before decode step %d", replica, step)
            if kill is not None:
                kill()
            raise InjectedCrash(f"injected crash of replica {replica}")

    def transport_fault(self, replica: int) -> bool:
        """True: the frontend drops this request with no response bytes."""
        with self._lock:
            left = self._transport_left.get(replica, 0)
            if left <= 0:
                return False
            self._transport_left[replica] = left - 1
            self.fired.append(("transport", replica, left))
        log.warning("SERVE FAULT: dropping request on replica %d at the transport level "
                    "(%d more to come)", replica, left - 1)
        return True

    def health_fault(self, replica: int) -> bool:
        """True: /health answers non-JSON garbage this time."""
        with self._lock:
            left = self._health_left.get(replica, 0)
            if left <= 0:
                return False
            self._health_left[replica] = left - 1
            self.fired.append(("badhealth", replica, left))
        return True


# Replica id -> the callable that kills that replica at the transport
# level; module-level, so a replica registers at build time whether the
# plan is armed before or after the fleet comes up.
_serve_crash_cbs: dict[int, Callable[[], None]] = {}


def register_serve_crash(replica: int, kill: Callable[[], None]) -> None:
    """Register replica ``replica``'s transport-kill callable."""
    _serve_crash_cbs[replica] = kill


_serve_engine: ServeEngine | None = None
_serve_env_checked = False


def serve_install(spec_or_plan: str | ServeFaultPlan) -> ServeEngine:
    """Arm a serve fault plan in-process."""
    global _serve_engine, _serve_env_checked
    plan = parse_serve_spec(spec_or_plan) if isinstance(spec_or_plan, str) else spec_or_plan
    _serve_engine = ServeEngine(plan)
    _serve_env_checked = True
    return _serve_engine


def serve_clear() -> None:
    global _serve_engine, _serve_env_checked
    _serve_engine = None
    _serve_env_checked = False


def serve_active() -> ServeEngine | None:
    """The armed serve engine, read from ``$TPU_SERVE_FAULT_INJECT`` on
    first call."""
    global _serve_engine, _serve_env_checked
    if _serve_engine is None and not _serve_env_checked:
        _serve_env_checked = True
        spec = os.environ.get(SERVE_ENV_VAR, "")
        if spec:
            _serve_engine = ServeEngine(parse_serve_spec(spec))
            log.info("serve fault injection armed from $%s=%s", SERVE_ENV_VAR, spec)
    return _serve_engine
