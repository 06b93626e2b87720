"""Continuous-batching request queue over the inference engine.

The port of ``tensorflow_examples_tpu/serving/batcher.py`` (one SLO
class; no brownout, preemption or tracing yet). The decode step always
runs at the engine's fixed ``[max_slots]`` shape, and requests join
(prefill into a free slot) and leave (retire at eos, limit or deadline)
between steps.

Two decode-loop modes, the reference's:

* **Speculation** (``spec_decode_k`` > 0): each step a draft source
  (``serving/speculative.py``; ``draft=`` injects one) proposes up to k
  tokens a request, capped at its remaining budget less one, and one
  ``engine.verify`` step commits the agreeing prefix; a step where no
  request has a draft runs the plain ``engine.decode``. Tokens past an
  eos inside a window are dropped, so streams equal the non-speculative
  ones. Each request tallies ``spec_drafted`` / ``spec_accepted``; the
  ``serving/spec_*`` counters and the serving line's ``spec_k``,
  ``draft_hit_rate`` and ``accepted_per_step`` measure the verify steps.
* **Chunk turns** (``prefill_chunk_tokens`` > 0): a prompt whose cold
  tail is longer than a chunk is admitted with ``engine.prefill_open``
  and prefilled one chunk a loop iteration, oldest admission first, so
  decode steps run between its chunks.

A step that fails with ``EngineStepError`` took the KV pool with it
(the engine reallocated it): every in-flight request fails, decoding and
mid-prefill alike.

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

from tensorflow_examples_torch.serving.engine import EngineStepError
from tensorflow_examples_torch.serving.paged_kv import BlockExhausted
from tensorflow_examples_torch.serving.speculative import make_draft
from tensorflow_examples_torch.telemetry.schema import SERVING_KEYS_V11, SERVING_SCHEMA_VERSION

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
    # Speculation (zeros with it off): drafts offered to verify steps and
    # drafts accepted; len(tokens) - 1 - spec_accepted came one a step.
    spec_drafted: int = 0
    spec_accepted: int = 0


class _InFlight:
    __slots__ = ("req", "future", "slot", "t_submit", "t_admit", "t_first",
                 "deadline", "tokens", "last_token", "spec_drafted", "spec_accepted")

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
        self.spec_drafted = 0
        self.spec_accepted = 0


class ContinuousBatcher:
    def __init__(self, engine, *, registry=None, draft=None):
        self.engine = engine
        cfg = engine.cfg
        self.max_batch = min(cfg.max_batch or cfg.max_slots, cfg.max_slots)
        self.max_delay_s = cfg.max_delay_s
        self.spec_k = int(cfg.spec_decode_k)
        self._draft = (draft or make_draft(cfg)) if self.spec_k > 0 else None
        self.registry = registry if registry is not None else engine.registry
        self._start_unix = time.time()
        self._queue: queue.Queue = queue.Queue(maxsize=cfg.max_queue)
        self._arrival = threading.Event()
        self._active: dict[int, _InFlight] = {}  # loop thread only
        # Mid chunked prefill, oldest admission first: slot -> (item,
        # engine ChunkedPrefill). Loop thread only.
        self._prefilling: dict[int, tuple] = {}
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
                return bool(self._active or self._prefilling or self._staged
                            or self.queue_depth())

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
        for item, _ in list(self._prefilling.values()):
            self._prefilling.pop(item.slot, None)
            self.engine.pool.free(item.slot)
            item.slot = None
            if not item.future.done():
                item.future.set_exception(Draining("serving shut down mid-prefill"))
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
                        self._prefilling.pop(item.slot, None)
                        self.engine.pool.free(item.slot)
                        self._drop_draft(item.slot)
                        item.slot = None
                    if not item.future.done():
                        item.future.set_exception(e)
                    reg.counter("serving/errors_total").inc()
                    if isinstance(e, EngineStepError):
                        self._fail_active(e)  # the pool went with the step
                finally:
                    self._staged -= 1
            if self._prefilling:
                # One chunk a loop iteration: the decode step below runs
                # between chunks.
                self._chunk_step()
            if not self._active:
                continue
            t0 = time.perf_counter()
            drafts_by_slot: dict[int, int] = {}
            try:
                out = self._decode_step(drafts_by_slot)
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
                    self._drop_draft(slot)
                    if not item.future.done():
                        item.future.set_exception(e)
                continue
            except Exception as e:  # noqa: BLE001 — fail the batch, keep serving
                log.exception("decode step failed; failing active batch")
                reg.counter("serving/errors_total").inc()
                self._fail_active(e)
                continue
            dt = time.perf_counter() - t0
            reg.histogram("serving/decode_step").record(dt)
            tpot = reg.histogram("serving/tpot")
            for slot, toks in out.items():
                item = self._active[slot]
                item.spec_drafted += drafts_by_slot.get(slot, 0)
                item.spec_accepted += len(toks) - 1
                committed: list[int] = []
                for token in toks:
                    item.tokens.append(token)
                    item.last_token = token
                    committed.append(token)
                    tpot.record(dt / len(toks))
                    if item.req.eos_id is not None and token == item.req.eos_id:
                        break  # tokens past eos in a window are dropped
                if self._draft is not None:
                    if drafts_by_slot:  # a verify step, not a fallback
                        reg.histogram("serving/accepted_per_step").record(float(len(toks)))
                    self._draft.extend(slot, committed)
                self._maybe_finish(item)
            reg.gauge("serving/active_requests").set(len(self._active))

    def _decode_step(self, drafts_by_slot: dict[int, int]) -> dict[int, list[int]]:
        """One device step over the active set: {slot: committed tokens}.
        Speculation on: propose each request's drafts (at most its budget
        less the token the verify samples) and verify; a step where no
        request has a draft takes the plain decode rung, same tokens."""
        if self._draft is None:
            out = self.engine.decode([
                (it.slot, it.last_token, it.req.seed, it.req.temperature, it.req.top_k)
                for it in self._active.values()
            ])
            return {slot: [tok] for slot, tok in out.items()}
        entries, proposed = [], {}
        for it in self._active.values():
            k_eff = min(self.spec_k, it.req.max_new_tokens - len(it.tokens) - 1)
            drafts = self._draft.propose(it.slot, k_eff) if k_eff > 0 else []
            proposed[it.slot] = len(drafts)
            entries.append((it.slot, it.last_token, drafts, it.req.seed,
                            it.req.temperature, it.req.top_k))
        if not any(e[2] for e in entries):
            out = self.engine.decode([(slot, tok, seed, temp, tk)
                                      for slot, tok, _, seed, temp, tk in entries])
            return {slot: [tok] for slot, tok in out.items()}
        drafts_by_slot.update(proposed)
        return self.engine.verify(entries)

    def _gather(self) -> list[_InFlight]:
        """Pull admissible requests without over-committing slots. Idle:
        block briefly for the first arrival, then hold ``max_delay_s`` so
        a burst prefills together. Busy: take what is queued, no wait."""
        free = min(self.max_batch - len(self._active) - len(self._prefilling),
                   self.engine.pool.num_slots - self.engine.pool.active_slots)
        staged: list[_InFlight] = []
        if not self._active and not self._prefilling:
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
        state = self.engine.prefill_open(slot, req.prompt, seed=req.seed,
                                         temperature=req.temperature, top_k=req.top_k)
        if state is not None and len(state.spans) > 1:
            # Chunked admission: the slot's blocks are claimed; the loop
            # runs one chunk an iteration and the last one finishes it.
            self._prefilling[slot] = (item, state)
            return
        t0 = time.perf_counter()
        if state is not None:
            # The cold tail fits one chunk: run it inline.
            _, first, _ = self.engine.prefill_step(state)
        else:
            first, _ = self.engine.prefill(slot, req.prompt, seed=req.seed,
                                           temperature=req.temperature, top_k=req.top_k)
        reg.histogram("serving/prefill").record(time.perf_counter() - t0)
        self._finish_prefill(item, first)

    def _finish_prefill(self, item: _InFlight, first: int) -> None:
        """Single-shot and chunked prefill's shared tail: TTFT, then the
        request joins the decode set."""
        item.t_first = time.monotonic()
        self.registry.histogram("serving/ttft").record(item.t_first - item.t_submit)
        item.tokens.append(first)
        item.last_token = first
        if self._draft is not None:
            self._draft.begin(item.slot, list(item.req.prompt) + [first])
        self._active[item.slot] = item
        self._maybe_finish(item)

    def _chunk_step(self) -> None:
        """Run one chunk of the oldest in-flight chunked prefill; after the
        last one the request joins the decode set as a single-shot
        admission would (the last chunk samples with the unchunked key)."""
        reg = self.registry
        slot = next(iter(self._prefilling))
        item, state = self._prefilling[slot]
        if item.deadline is not None and time.monotonic() > item.deadline:
            # Abandon a dead stream now rather than stall decode steps for
            # its remaining chunks.
            del self._prefilling[slot]
            self.engine.pool.free(slot)
            item.slot = None
            reg.counter("serving/expired_total").inc()
            if not item.future.done():
                item.future.set_exception(DeadlineExceeded(
                    f"deadline ({item.req.deadline_s:.3f}s) passed mid-chunked-prefill"))
            return
        try:
            done, first, _ = self.engine.prefill_step(state)
        except Exception as e:  # noqa: BLE001 — one bad chunk must not
            # take the serve loop down
            log.exception("prefill chunk failed; failing request")
            self._prefilling.pop(slot, None)
            self.engine.pool.free(slot)
            item.slot = None
            if not item.future.done():
                item.future.set_exception(e)
            reg.counter("serving/errors_total").inc()
            if isinstance(e, EngineStepError):
                self._fail_active(e)
            return
        if not done:
            return
        del self._prefilling[slot]
        # Chunked prefill wall: admission to the last chunk, decode steps
        # interleaved inside it.
        reg.histogram("serving/prefill").record(time.monotonic() - item.t_admit)
        self._finish_prefill(item, first)

    def _fail_active(self, exc: Exception) -> None:
        """Fail and free every in-flight request, decoding and mid chunked
        prefill: their KV state went with the failed step."""
        for it, _ in list(self._prefilling.values()):
            del self._prefilling[it.slot]
            self.engine.pool.free(it.slot)
            it.slot = None
            if not it.future.done():
                it.future.set_exception(exc)
        for it in list(self._active.values()):
            del self._active[it.slot]
            self.engine.pool.free(it.slot)
            self._drop_draft(it.slot)
            if not it.future.done():
                it.future.set_exception(exc)

    def _drop_draft(self, slot: int | None) -> None:
        if self._draft is not None and slot is not None:
            self._draft.end(slot)

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
            self._drop_draft(item.slot)
            item.slot = None
        now = time.monotonic()
        result = Result(
            tokens=item.tokens, prompt_len=len(item.req.prompt), truncated=truncated,
            queue_wait_s=(item.t_admit or now) - item.t_submit,
            ttft_s=item.t_first - item.t_submit if item.t_first else None,
            total_s=now - item.t_submit,
            spec_drafted=item.spec_drafted, spec_accepted=item.spec_accepted,
        )
        reg = self.registry
        reg.histogram("serving/e2e").record(result.total_s)
        reg.counter("serving/completed_total").inc()
        reg.counter("serving/generated_tokens_total").inc(len(result.tokens))
        if item.future.set_running_or_notify_cancel():
            item.future.set_result(result)

    # ------------------------------------------------------------- stats

    def stats_line(self) -> dict:
        """A ``kind="serving"`` line stamped ``SERVING_SCHEMA_VERSION`` (14,
        the reference's): the registry's serving counters, gauges and
        latency percentiles, and the ``serving`` object (pool
        occupancy, ``post_warmup_recompiles``, the paged pool's fields,
        the speculation keys ``SERVING_KEYS_V8`` when speculation is on
        and the precision keys ``SERVING_KEYS_V11`` when the weights are
        quantized), as the reference's ``stats_line`` writes them
        (``telemetry/schema.SERVING_KEYS_V8`` and ``SERVING_KEYS_V11``)."""
        reg = self.registry
        counters = {k: v for k, v in reg.counter_values().items()
                    if k.startswith(("serving/", "compile/"))}
        gauges = {k: v for k, v in reg.gauge_values().items() if k.startswith("serving/")}
        hists = reg.histogram_summaries()
        derived = {}
        for name in ("queue_wait", "prefill", "ttft", "tpot", "e2e"):
            h = hists.get(f"serving/{name}")
            if h and h["count"]:
                derived[f"{name}_p50"] = h["p50"]
                derived[f"{name}_p95"] = h["p95"]
        serving = {
            "active_requests": len(self._active) + len(self._prefilling),
            "queue_depth": self.queue_depth(),
            "slots": self.engine.pool.num_slots,
            "kv_occupancy": self.engine.pool.occupancy,
            "post_warmup_recompiles": self.engine.post_warmup_recompiles(),
            "draining": 1 if self._draining else 0,
        }
        if self.spec_k > 0:
            steps = counters.get("serving/spec_request_steps", 0)
            drafted = counters.get("serving/spec_drafted_total", 0)
            accepted = counters.get("serving/spec_accepted_total", 0)
            serving.update({
                "spec_k": self.spec_k,
                "draft_hit_rate": accepted / drafted if drafted else 0.0,
                "accepted_per_step": (steps + accepted) / steps if steps else 0.0,
            })
        paged = getattr(self.engine.pool, "paged_stats", None)
        if callable(paged):
            serving.update(paged())
        pstats = self.engine.precision_stats()
        if pstats:
            serving.update({k: pstats[k] for k in SERVING_KEYS_V11})
        return {
            "schema_version": SERVING_SCHEMA_VERSION,
            "kind": "serving", "step": int(counters.get("serving/decode_steps", 0)),
            "time_unix": time.time(), "session_start_unix": self._start_unix, "host": 0,
            "metrics": {}, "counters": counters, "gauges": gauges, "derived": derived,
            "serving": serving,
        }
