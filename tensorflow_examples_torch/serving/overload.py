"""Brownout overload controller: the port of
``tensorflow_examples_tpu/serving/overload.py`` (host code only).

When load outruns a replica, service degrades one rung at a time and
recovers the same way:

    level 0  normal
    level 1  shed batch       new batch-class submits are shed (503, retryable)
    level 2  cap tokens       + generate budgets capped at
                                ``brownout_max_new_tokens`` (the stream is a
                                prefix of the uncapped one,
                                ``truncated="brownout"``)
    level 3  no speculation   + plain one-token decode steps (same tokens)
    level 4  shed interactive + new interactive submits are shed

The batcher loop ticks :meth:`OverloadController.update` once an
iteration with the queue depth and KV occupancy; the controller keeps
its own recent-window TTFT p95. Hysteresis both ways: one rung up per
``hold_s`` (the first hot tick escalates at once), one rung down only
after every signal has stayed under its clear watermark (``clear_frac``
x its high watermark) for a full ``hold_s``. Each transition is counted
(``serving/brownout_transitions_total``, ``..._escalations_total``),
gauged (``serving/brownout_level``), logged and kept in ``events``.
``clock`` is injectable, so a test drives the ladder deterministically.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

log = logging.getLogger(__name__)

LADDER = ("normal", "shed_batch", "cap_tokens", "no_spec", "shed_interactive")
MAX_LEVEL = len(LADDER) - 1

LEVEL_SHED_BATCH = 1
LEVEL_CAP_TOKENS = 2
LEVEL_NO_SPEC = 3
LEVEL_SHED_INTERACTIVE = 4

# Recent-window TTFT samples kept for the p95 signal.
_TTFT_WINDOW = 256
_TTFT_WINDOW_S = 5.0

# The event tail kept; the full count lives in _transitions.
_MAX_EVENTS = 4096


class OverloadController:
    """The brownout ladder as a tickable state machine. :meth:`update` runs
    on the batcher loop thread only; ``level`` reads are plain int loads
    (submit threads read it) and :meth:`note_ttft` takes the sample lock."""

    def __init__(self, *, registry, enabled: bool = True, queue_hi: int = 16,
                 kv_hi: float = 0.92, ttft_hi_s: float = 0.0, clear_frac: float = 0.5,
                 hold_s: float = 0.5, max_new_tokens_cap: int = 8, clock=time.monotonic):
        self.registry = registry
        self.enabled = bool(enabled)
        self.queue_hi = max(1, int(queue_hi))
        self.kv_hi = float(kv_hi)
        self.ttft_hi_s = float(ttft_hi_s)
        self.clear_frac = float(clear_frac)
        self.hold_s = float(hold_s)
        self.max_new_tokens_cap = max(1, int(max_new_tokens_cap))
        self._clock = clock
        self.level = 0
        # (wall_unix, from_level, to_level, reason)
        self.events: list[tuple[float, int, int, str]] = []
        self._transitions = 0
        # Backdated one hold: the first hot tick escalates immediately.
        self._last_change = clock() - self.hold_s
        self._clear_since: float | None = None
        self._ttft_lock = threading.Lock()
        self._ttft: collections.deque = collections.deque(maxlen=_TTFT_WINDOW)
        registry.gauge("serving/brownout_level").set(0)

    # --------------------------------------------------------- signals

    def note_ttft(self, value_s: float) -> None:
        """Feed one TTFT observation."""
        with self._ttft_lock:
            self._ttft.append((self._clock(), float(value_s)))

    def ttft_p95(self, window_s: float = _TTFT_WINDOW_S) -> float | None:
        """p95 over the TTFT samples of the last ``window_s`` seconds (None
        with no recent sample)."""
        cutoff = self._clock() - window_s
        with self._ttft_lock:
            vals = sorted(v for t, v in self._ttft if t >= cutoff)
        if not vals:
            return None
        return vals[min(len(vals) - 1, int(0.95 * len(vals)))]

    # ----------------------------------------------------- enforcement

    def sheds(self, slo: str) -> bool:
        """Does the current level shed new submits of this class?"""
        if slo == "batch":
            return self.level >= LEVEL_SHED_BATCH
        return self.level >= LEVEL_SHED_INTERACTIVE

    def max_new_cap(self) -> int | None:
        """The generation-budget cap at the current level (None: no cap)."""
        if self.level >= LEVEL_CAP_TOKENS:
            return self.max_new_tokens_cap
        return None

    def spec_disabled(self) -> bool:
        """Level 3 and up: skip speculation's verify work."""
        return self.level >= LEVEL_NO_SPEC

    # ------------------------------------------------------------ tick

    def update(self, *, queue_depth: int, kv_occupancy: float) -> int:
        """One controller tick; returns the (possibly changed) level."""
        if not self.enabled:
            return 0
        now = self._clock()
        p95 = self.ttft_p95() if self.ttft_hi_s > 0 else None
        hot_reasons = []
        if queue_depth >= self.queue_hi:
            hot_reasons.append(f"queue_depth {queue_depth} >= {self.queue_hi}")
        if kv_occupancy >= self.kv_hi:
            hot_reasons.append(f"kv_occupancy {kv_occupancy:.2f} >= {self.kv_hi:.2f}")
        if p95 is not None and p95 >= self.ttft_hi_s:
            hot_reasons.append(f"ttft_p95 {p95:.3f}s >= {self.ttft_hi_s:.3f}s")
        clear = (queue_depth <= self.clear_frac * self.queue_hi
                 and kv_occupancy <= self.clear_frac * self.kv_hi
                 and (self.ttft_hi_s <= 0 or p95 is None
                      or p95 <= self.clear_frac * self.ttft_hi_s))
        if hot_reasons:
            self._clear_since = None
            if self.level < MAX_LEVEL and now - self._last_change >= self.hold_s:
                self._step(+1, "; ".join(hot_reasons), now)
        elif clear and self.level > 0:
            if self._clear_since is None:
                self._clear_since = now
            elif now - self._clear_since >= self.hold_s:
                self._step(-1, "pressure cleared", now)
                self._clear_since = now  # a full hold per rung down
        else:
            self._clear_since = None
        return self.level

    def _step(self, delta: int, reason: str, now: float) -> None:
        old, new = self.level, self.level + delta
        self.level = new
        self._last_change = now
        self._transitions += 1
        self.events.append((time.time(), old, new, reason))
        if len(self.events) > _MAX_EVENTS:
            del self.events[:_MAX_EVENTS // 2]
        reg = self.registry
        reg.counter("serving/brownout_transitions_total").inc()
        if delta > 0:
            reg.counter("serving/brownout_escalations_total").inc()
        reg.gauge("serving/brownout_level").set(new)
        msg = ("BROWNOUT level %d -> %d (%s): %s", old, new, LADDER[new], reason)
        if delta > 0:
            log.warning(*msg)
        else:
            log.info(*msg)

    # ------------------------------------------------------------ stats

    def transitions(self) -> int:
        return max(self._transitions, len(self.events))
