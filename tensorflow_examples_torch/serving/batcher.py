"""Continuous-batching request queue over the inference engine.

The port of ``tensorflow_examples_tpu/serving/batcher.py`` (one SLO
class; no speculation, chunked prefill, brownout or tracing yet). The
decode step always runs at the engine's fixed ``[max_slots]`` shape, and
requests join (prefill into a free slot) and leave (retire at eos, limit
or deadline) between steps.

Flow control, outermost first:

* **Backpressure**: the submit queue is bounded (``max_queue``); a full
  queue sheds at once (:class:`QueueFull`, ``serving/shed_total``).
* **Admission**: a prompt plus generation budget that cannot fit
  ``max_len``, or an out-of-vocabulary token id, is rejected up front
  (``serving/rejected_total``); a request whose deadline passed while
  queued expires without device work (``serving/expired_total``); a
  paged pool that cannot back the prompt fails the request with
  ``BlockExhausted``.
* **Coalescing**: from idle, the first arrival opens a ``max_delay_s``
  window so a burst prefills together; under load admission happens
  between decode steps with no added delay.
* **Deadlines**: a request past its deadline mid-generation retires with
  what it has (``truncated="deadline"``).

Latency histograms: ``serving/queue_wait`` (submit -> admitted),
``serving/prefill``, ``serving/ttft`` (submit -> first token),
``serving/tpot`` (decode wall per generated token), ``serving/e2e``.

The loop runs on one daemon thread. The per-request bookkeeping
(``_active``) is written by that thread only; submit threads touch only
the thread-safe queue, the arrival event and the locked registry.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import queue
import threading
import time

from tensorflow_examples_torch.serving.paged_kv import BlockExhausted

log = logging.getLogger(__name__)


class QueueFull(RuntimeError):
    """Bounded submit queue is full: request load-shed (HTTP 503)."""


class Draining(RuntimeError):
    """Batcher is draining for shutdown: new requests rejected (503)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before any token was produced."""


@dataclasses.dataclass
class Request:
    """One generate request (token ids in, token ids out)."""

    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    eos_id: int | None = None
    deadline_s: float | None = None  # relative to submit time


@dataclasses.dataclass
class Result:
    """Resolved request payload (the frontend serializes this)."""

    tokens: list[int]
    prompt_len: int
    truncated: str | None = None  # None | "deadline" | "max_len" | "shutdown"
    queue_wait_s: float = 0.0
    ttft_s: float | None = None
    total_s: float = 0.0


class _InFlight:
    __slots__ = ("req", "future", "slot", "t_submit", "t_admit", "t_first",
                 "deadline", "tokens", "last_token")

    def __init__(self, req: Request, future, t_submit: float):
        self.req = req
        self.future = future
        self.slot: int | None = None
        self.t_submit = t_submit
        self.t_admit: float | None = None
        self.t_first: float | None = None
        self.deadline = t_submit + req.deadline_s if req.deadline_s is not None else None
        self.tokens: list[int] = []
        self.last_token: int | None = None


class ContinuousBatcher:
    def __init__(self, engine, *, registry=None):
        self.engine = engine
        cfg = engine.cfg
        self.max_batch = min(cfg.max_batch or cfg.max_slots, cfg.max_slots)
        self.max_delay_s = cfg.max_delay_s
        self.registry = registry if registry is not None else engine.registry
        self._queue: queue.Queue = queue.Queue(maxsize=cfg.max_queue)
        self._arrival = threading.Event()
        self._active: dict[int, _InFlight] = {}  # loop thread only
        # Dequeued but not yet admitted: close(drain=True) must count them.
        self._staged = 0
        self._draining = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ intake

    def submit(self, req: Request) -> concurrent.futures.Future:
        """Enqueue; resolves to :class:`Result`. Raises :class:`Draining`
        or :class:`QueueFull` instead of queueing when the request cannot
        be served promptly; fails the future at once on a request
        admission can never serve."""
        reg = self.registry
        reg.counter("serving/requests_total").inc()
        if self._draining or self._stop.is_set():
            reg.counter("serving/rejected_total").inc()
            raise Draining("serving is draining; retry against a live host")
        fut: concurrent.futures.Future = concurrent.futures.Future()
        max_len = self.engine.model_cfg.max_len
        vocab = self.engine.model_cfg.vocab_size
        error = None
        if not req.prompt or len(req.prompt) + req.max_new_tokens > max_len:
            error = (f"prompt ({len(req.prompt)}) + max_new_tokens must fit "
                     f"1..max_len={max_len}")
        elif any(t < 0 or t >= vocab for t in req.prompt):
            # An out-of-range id would index past the embedding table.
            error = f"prompt token ids must be in [0, {vocab})"
        if error is not None:
            fut.set_exception(ValueError(error))
            reg.counter("serving/rejected_total").inc()
            return fut
        item = _InFlight(req, fut, time.monotonic())
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            reg.counter("serving/shed_total").inc()
            raise QueueFull(
                f"request queue at capacity ({self._queue.maxsize}); load shed"
            ) from None
        self._arrival.set()
        if self._draining or self._stop.is_set():
            # Raced close(): its sweep may have passed already. Pull the
            # item back out unless the loop took it first.
            with self._queue.mutex:
                try:
                    self._queue.queue.remove(item)
                    removed = True
                except ValueError:
                    removed = False
            if removed:
                reg.counter("serving/rejected_total").inc()
                raise Draining("serving is draining; retry against a live host")
        reg.gauge("serving/queue_depth").set(self.queue_depth())
        return fut

    def queue_depth(self) -> int:
        return self._queue.qsize()

    @property
    def active_requests(self) -> int:
        return len(self._active)

    # --------------------------------------------------------- lifecycle

    def start(self) -> "ContinuousBatcher":
        self._thread = threading.Thread(target=self._loop, name="serving-batcher",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self, *, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop accepting; with ``drain`` finish everything already
        accepted first; then stop the loop thread and fail or retire
        whatever is left."""
        self._draining = True
        if drain:
            deadline = time.monotonic() + timeout

            def busy():
                return bool(self._active or self._staged or self.queue_depth())

            while (time.monotonic() < deadline and self._thread is not None
                   and self._thread.is_alive()):
                if not busy():
                    # A request dequeued this instant may not have bumped
                    # _staged yet; confirm after a tick.
                    time.sleep(0.01)
                    if not busy():
                        break
                time.sleep(0.005)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        while True:
            try:
                self._queue.get_nowait().future.set_exception(
                    Draining("serving shut down before drain"))
            except queue.Empty:
                break
        for item in list(self._active.values()):
            self._retire(item, truncated="shutdown")

    @property
    def draining(self) -> bool:
        return self._draining

    # -------------------------------------------------------------- loop

    def _loop(self) -> None:
        reg = self.registry
        while not self._stop.is_set():
            for item in self._gather():
                try:
                    self._admit(item)
                except Exception as e:  # noqa: BLE001 — one bad request must
                    # not take the serve loop down
                    if not isinstance(e, BlockExhausted):
                        log.exception("prefill failed; failing request")
                    if item.slot is not None:
                        self.engine.pool.free(item.slot)
                        item.slot = None
                    if not item.future.done():
                        item.future.set_exception(e)
                    reg.counter("serving/errors_total").inc()
                finally:
                    self._staged -= 1
            if not self._active:
                continue
            t0 = time.perf_counter()
            try:
                out = self.engine.decode([
                    (it.slot, it.last_token, it.req.seed, it.req.temperature,
                     it.req.top_k)
                    for it in self._active.values()
                ])
            except BlockExhausted as e:
                # Host-side, before the device step: only the slots that
                # could not grow fail; freeing them returns their blocks.
                log.warning("KV block exhaustion: failing %d of %d active "
                            "request(s): %s", len(e.slots), len(self._active), e)
                reg.counter("serving/errors_total").inc()
                for slot in e.slots:
                    item = self._active.pop(slot, None)
                    if item is None:
                        continue
                    self.engine.pool.free(slot)
                    if not item.future.done():
                        item.future.set_exception(e)
                continue
            except Exception as e:  # noqa: BLE001 — fail the batch, keep serving
                log.exception("decode step failed; failing active batch")
                reg.counter("serving/errors_total").inc()
                for it in list(self._active.values()):
                    del self._active[it.slot]
                    self.engine.pool.free(it.slot)
                    if not it.future.done():
                        it.future.set_exception(e)
                continue
            dt = time.perf_counter() - t0
            reg.histogram("serving/decode_step").record(dt)
            tpot = reg.histogram("serving/tpot")
            for slot, token in out.items():
                item = self._active[slot]
                item.tokens.append(token)
                item.last_token = token
                tpot.record(dt)
                self._maybe_finish(item)
            reg.gauge("serving/active_requests").set(len(self._active))

    def _gather(self) -> list[_InFlight]:
        """Pull admissible requests without over-committing slots. Idle:
        block briefly for the first arrival, then hold ``max_delay_s`` so
        a burst prefills together. Busy: take what is queued, no wait."""
        free = min(self.max_batch - len(self._active),
                   self.engine.pool.num_slots - self.engine.pool.active_slots)
        staged: list[_InFlight] = []
        if not self._active:
            if not self._take(staged, timeout=0.05):
                return staged
            window_end = time.monotonic() + self.max_delay_s
            while len(staged) < free:
                remaining = window_end - time.monotonic()
                if remaining <= 0 or not self._take(staged, timeout=remaining):
                    break
        else:
            while len(staged) < free and self._take(staged):
                pass
        self.registry.gauge("serving/queue_depth").set(self.queue_depth())
        return staged

    def _take(self, staged: list, timeout: float | None = None) -> bool:
        """Dequeue one request into ``staged``, counted in ``_staged`` the
        moment it leaves the queue. With a timeout, wait on the arrival
        event; returns whether a request was taken."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                if deadline is None:
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                # Clear-then-recheck closes the missed-wakeup race with
                # submit()'s put-then-set.
                self._arrival.clear()
                if not self._queue.empty():
                    continue
                if not self._arrival.wait(timeout=remaining):
                    return False
                continue
            self._staged += 1
            staged.append(item)
            return True

    def _admit(self, item: _InFlight) -> None:
        reg = self.registry
        now = time.monotonic()
        if item.deadline is not None and now > item.deadline:
            reg.counter("serving/expired_total").inc()
            item.future.set_exception(DeadlineExceeded(
                f"deadline ({item.req.deadline_s:.3f}s) passed after "
                f"{now - item.t_submit:.3f}s in queue"))
            return
        slot = self.engine.pool.alloc()
        if slot is None:  # _gather bounds by free slots; belt-and-braces
            reg.counter("serving/shed_total").inc()
            item.future.set_exception(QueueFull("no free KV slot"))
            return
        item.slot = slot
        item.t_admit = now
        reg.histogram("serving/queue_wait").record(now - item.t_submit)
        req = item.req
        t0 = time.perf_counter()
        first, _ = self.engine.prefill(slot, req.prompt, seed=req.seed,
                                       temperature=req.temperature, top_k=req.top_k)
        reg.histogram("serving/prefill").record(time.perf_counter() - t0)
        item.t_first = time.monotonic()
        reg.histogram("serving/ttft").record(item.t_first - item.t_submit)
        item.tokens.append(first)
        item.last_token = first
        self._active[slot] = item
        self._maybe_finish(item)

    # ----------------------------------------------------------- retire

    def _maybe_finish(self, item: _InFlight) -> None:
        req, truncated = item.req, None
        done = (len(item.tokens) >= req.max_new_tokens
                or (req.eos_id is not None and item.last_token == req.eos_id))
        if not done and item.deadline is not None and time.monotonic() > item.deadline:
            done, truncated = True, "deadline"
        if not done and len(req.prompt) + len(item.tokens) >= self.engine.model_cfg.max_len:
            done, truncated = True, "max_len"  # admission makes this rare
        if done:
            self._retire(item, truncated=truncated)

    def _retire(self, item: _InFlight, *, truncated: str | None) -> None:
        if item.slot is not None:
            self._active.pop(item.slot, None)
            self.engine.pool.free(item.slot)
            item.slot = None
        now = time.monotonic()
        result = Result(
            tokens=item.tokens, prompt_len=len(item.req.prompt), truncated=truncated,
            queue_wait_s=(item.t_admit or now) - item.t_submit,
            ttft_s=item.t_first - item.t_submit if item.t_first else None,
            total_s=now - item.t_submit,
        )
        reg = self.registry
        reg.histogram("serving/e2e").record(result.total_s)
        reg.counter("serving/completed_total").inc()
        reg.counter("serving/generated_tokens_total").inc(len(result.tokens))
        if item.future.set_running_or_notify_cancel():
            item.future.set_result(result)
