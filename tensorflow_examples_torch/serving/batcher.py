"""Continuous-batching request queue over the inference engine.

The port of ``tensorflow_examples_tpu/serving/batcher.py``. The decode step always runs at the engine's fixed
``[max_slots]`` shape, and requests join (prefill into a free slot) and
leave (retire at eos, limit or deadline) between steps.

Request kinds: ``generate``; ``classify`` (the top-n next-token
distribution after the prompt, ``Result.top``); and the disaggregated
hand-off pair on the paged pool: ``prefill`` runs the prompt to its
first token and resolves with the slot's serialized KV pages
(``Result.pages``, ``engine.export_kv_pages``; ``skip_tokens`` leaves
the importer's cached leading blocks off the wire), and ``resume``
imports a prefill replica's ``pages`` (``engine.import_kv_pages``) and
continues the stream from its ``first_token``.

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
  and prefilled one chunk a loop iteration, interactive before batch
  and then oldest admission first, so decode steps run between chunks.

**SLO classes.** Every request is ``interactive`` (default) or ``batch``,
with one bounded queue each. Interactive comes first at every decision:
admission drains its queue first, chunk turns prefer it, and when the
slots are full a queued interactive request preempts the most recently
admitted batch request (mid chunked prefill first): its slot is freed
(``pool.free`` points the slot's table at the null block, so the next
graph replay writes nothing through it) and the request goes back to the
end of the batch queue. Its replay from the prompt gives the same tokens,
since sampling keys on (seed, position): preemption costs latency, never
content. Under pressure the brownout ladder (``serving/overload.py``,
``ServeConfig.brownout``) sheds batch first, then caps generation
budgets, then turns speculation off, and sheds interactive last.

A step that fails with ``EngineStepError`` took the KV pool with it
(the engine reallocated it): every in-flight request fails, decoding and
mid-prefill alike.

Flow control, outermost first:

* **Backpressure**: a full class queue (``max_queue``) or a brownout
  shed refuses at once (:class:`QueueFull`, ``serving/shed_total`` and
  ``serving/shed_<class>_total``).
* **Admission**: a prompt plus generation budget that cannot fit
  ``max_len``, an out-of-vocabulary token id, or a hand-off verb without
  the paged pool, is rejected up front (``serving/rejected_total``); a
  request whose deadline passed while queued expires without device work
  (``serving/expired_total``); a paged pool that cannot back the prompt
  fails the request with ``BlockExhausted``.
* **Coalescing**: from idle, the first arrival opens a ``max_delay_s``
  window so a burst prefills together; under load admission happens
  between decode steps with no added delay.
* **Deadlines**: a request past its deadline mid-generation retires with
  what it has (``truncated="deadline"``).

Latency histograms: ``serving/queue_wait`` (submit -> admitted),
``serving/prefill``, ``serving/ttft`` (submit -> first token; a resume's
is its import), ``serving/tpot`` and ``serving/e2e``, each but prefill
also per class (``serving/ttft_interactive`` ...). With
``watchdog_secs`` > 0 a ``utils/diagnostics.Watchdog`` sees the loop's
phases (``serve_idle``, ``serve_admit``, ``serve_prefill``,
``serve_decode``).

**Per-request tracing.** A request that carries the router's trace
context (``Request.trace``) collects its replica-side spans, the
reference's names and tags: ``queue_wait`` (tagged with the SLO class and
the brownout level at admission), ``prefill`` (admission to first token),
one ``prefill_chunk`` a chunk, ``resume_import`` for a hand-off, one
``decode_segment`` a slot residency (a preempted request shows each, the
cut one tagged ``preempted``) and a ``preempted`` marker for an eviction
mid-prefill. They come back on ``Result.spans`` with no parent; the
router parents them under its dispatch span. The TTFT and e2e of traced
requests feed the batcher's :class:`ExemplarStore`. An untraced request
costs one ``is None`` test a phase.

The loop runs on one daemon thread. The per-request bookkeeping
(``_active``, ``_prefilling``, ``_staged``) is written by that thread
only; submit threads touch only the thread-safe queues, the arrival
event, the controller's level and the locked registry.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import queue
import threading
import time

from tensorflow_examples_torch.serving.engine import EngineStepError, top_logprobs
from tensorflow_examples_torch.serving.overload import OverloadController
from tensorflow_examples_torch.serving.paged_kv import BlockExhausted
from tensorflow_examples_torch.serving.speculative import make_draft
from tensorflow_examples_torch.telemetry.schema import SERVING_KEYS_V11, SERVING_SCHEMA_VERSION
from tensorflow_examples_torch.telemetry.tracing import ExemplarStore, close_span
from tensorflow_examples_torch.utils.diagnostics import Watchdog

log = logging.getLogger(__name__)

# SLO classes in service order: admission, chunk turns and preemption
# prefer earlier classes.
SLO_CLASSES = ("interactive", "batch")
KINDS = ("generate", "classify", "prefill", "resume")


class QueueFull(RuntimeError):
    """Bounded submit queue is full: request load-shed (HTTP 503)."""


class Draining(RuntimeError):
    """Batcher is draining for shutdown: new requests rejected (503)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before any token was produced."""


@dataclasses.dataclass
class Request:
    """One request (token ids in, token ids out) of a kind in ``KINDS``."""

    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    eos_id: int | None = None
    deadline_s: float | None = None  # relative to submit time
    kind: str = "generate"           # generate | classify | prefill | resume
    classify_top_n: int = 5
    pages: dict | None = None        # resume: the handed-off KV pages
    first_token: int | None = None   # resume: the prefill's sampled token
    skip_tokens: int = 0             # prefill: leading prompt tokens the
    #                                  importer already caches (left off
    #                                  the wire)
    slo: str = "interactive"         # interactive | batch
    trace: dict | None = None        # the router's trace context ({"trace_id",
    #                                  "parent_span_id", "sampled"}): collect
    #                                  this request's spans on Result.spans


@dataclasses.dataclass
class Result:
    """Resolved request payload (the frontend serializes this)."""

    tokens: list[int]                # generated tokens (prefill: the first)
    prompt_len: int
    top: list[dict] | None = None    # classify payload
    truncated: str | None = None     # None | "deadline" | "max_len" | "shutdown"
    #                                  | "brownout" (the level-2 cap: a prefix
    #                                  of the uncapped stream)
    queue_wait_s: float = 0.0
    ttft_s: float | None = None
    total_s: float = 0.0
    # Speculation (zeros with it off): drafts offered to verify steps and
    # drafts accepted; len(tokens) - 1 - spec_accepted came one a step.
    spec_drafted: int = 0
    spec_accepted: int = 0
    pages: dict | None = None        # prefill: the serialized KV pages
    spans: list | None = None        # traced requests: the replica-side spans


class _InFlight:
    __slots__ = ("req", "future", "slot", "t_submit", "t_admit", "t_first", "deadline",
                 "tokens", "last_token", "spec_drafted", "spec_accepted", "max_new_eff",
                 "spans", "t_decode0", "decode_seg", "decode_tok0")

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
        # The generation budget in force: the brownout cap at admission.
        self.max_new_eff = req.max_new_tokens
        # Traced requests only; the list survives preemption resets, so a
        # preempted request's trace shows every decode segment it ran.
        self.spans: list | None = [] if req.trace is not None else None
        self.t_decode0: float | None = None  # the open decode segment's start
        self.decode_seg = 0
        self.decode_tok0 = 0  # committed tokens when the segment opened


class ContinuousBatcher:
    def __init__(self, engine, *, registry=None, watchdog=None, draft=None):
        self.engine = engine
        cfg = engine.cfg
        self.max_batch = min(cfg.max_batch or cfg.max_slots, cfg.max_slots)
        self.max_delay_s = cfg.max_delay_s
        self.spec_k = int(cfg.spec_decode_k)
        self._draft = (draft or make_draft(cfg)) if self.spec_k > 0 else None
        self.registry = registry if registry is not None else engine.registry
        self._start_unix = time.time()
        self._queues: dict[str, queue.Queue] = {
            cls: queue.Queue(maxsize=cfg.max_queue) for cls in SLO_CLASSES}
        self._arrival = threading.Event()
        self._overload = OverloadController(
            registry=self.registry, enabled=cfg.brownout,
            queue_hi=cfg.brownout_queue_hi or 2 * cfg.max_slots, kv_hi=cfg.brownout_kv_hi,
            ttft_hi_s=cfg.brownout_ttft_hi_s, clear_frac=cfg.brownout_clear_frac,
            hold_s=cfg.brownout_hold_s, max_new_tokens_cap=cfg.brownout_max_new_tokens,
        )
        # Worst recent TTFT/e2e of traced requests with their trace ids
        # (``/metrics`` exemplars); one store a batcher, so replicas in one
        # process keep their own.
        self.exemplars = ExemplarStore()
        self._active: dict[int, _InFlight] = {}  # loop thread only
        # Mid chunked prefill: slot -> (item, engine ChunkedPrefill), in
        # admission order. Loop thread only.
        self._prefilling: dict[int, tuple] = {}
        # Dequeued but not yet admitted: close(drain=True) must count them.
        self._staged = 0
        self._draining = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._watchdog = watchdog
        if watchdog is None and cfg.watchdog_secs > 0:
            self._watchdog = Watchdog(cfg.watchdog_secs, fatal_timeout_s=4 * cfg.watchdog_secs)

    # ------------------------------------------------------------ intake

    def _reject(self, fut, error: Exception):
        fut.set_exception(error)
        self.registry.counter("serving/rejected_total").inc()
        return fut

    def submit(self, req: Request) -> concurrent.futures.Future:
        """Enqueue; resolves to :class:`Result`. Raises :class:`Draining`
        or :class:`QueueFull` instead of queueing when the request cannot
        be served promptly (a brownout shed is a ``QueueFull``); fails the
        future at once on a request admission can never serve."""
        reg = self.registry
        reg.counter("serving/requests_total").inc()
        if self._draining or self._stop.is_set():
            reg.counter("serving/rejected_total").inc()
            raise Draining("serving is draining; retry against a live host")
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if req.slo not in SLO_CLASSES:
            return self._reject(fut, ValueError(
                f"unknown slo class {req.slo!r}; one of {SLO_CLASSES}"))
        if self._overload.sheds(req.slo):
            reg.counter("serving/shed_total").inc()
            reg.counter(f"serving/shed_{req.slo}_total").inc()
            reg.counter("serving/brownout_shed_total").inc()
            raise QueueFull(f"brownout level {self._overload.level}: shedding "
                            f"{req.slo} traffic; retry later")
        max_len = self.engine.model_cfg.max_len
        vocab = self.engine.model_cfg.vocab_size
        budget = len(req.prompt) + (req.max_new_tokens if req.kind in ("generate", "resume")
                                    else 0)
        if req.kind not in KINDS:
            return self._reject(fut, ValueError(f"unknown kind {req.kind!r}"))
        if req.kind in ("prefill", "resume") and not self.engine.paged:
            return self._reject(fut, ValueError(
                "disaggregated prefill/decode requires the paged KV pool (set kv_block_size)"))
        if not req.prompt or budget > max_len:
            return self._reject(fut, ValueError(
                f"prompt ({len(req.prompt)}) + max_new_tokens must fit 1..max_len={max_len}"))
        if any(t < 0 or t >= vocab for t in req.prompt):
            # An out-of-range id would index past the embedding table.
            return self._reject(fut, ValueError(f"prompt token ids must be in [0, {vocab})"))
        if req.kind == "resume":
            if not isinstance(req.pages, dict):
                return self._reject(fut, ValueError(
                    "resume requires the prefill replica's 'pages' payload"))
            ft = req.first_token
            if not isinstance(ft, int) or isinstance(ft, bool) or not 0 <= ft < vocab:
                return self._reject(fut, ValueError(
                    f"resume 'first_token' must be a token id in [0, {vocab})"))
        item = _InFlight(req, fut, time.monotonic())
        q = self._queues[req.slo]
        try:
            q.put_nowait(item)
        except queue.Full:
            reg.counter("serving/shed_total").inc()
            reg.counter(f"serving/shed_{req.slo}_total").inc()
            raise QueueFull(f"{req.slo} request queue at capacity ({q.maxsize}); "
                            "load shed") from None
        self._arrival.set()
        if self._draining or self._stop.is_set():
            # Raced close(): its sweep may have passed already. Pull the
            # item back out unless the loop took it first.
            with q.mutex:
                try:
                    q.queue.remove(item)
                    removed = True
                except ValueError:
                    removed = False
            if removed:
                reg.counter("serving/rejected_total").inc()
                raise Draining("serving is draining; retry against a live host")
        reg.gauge("serving/queue_depth").set(self.queue_depth())
        return fut

    def queue_depth(self) -> int:
        """Queued requests across the SLO classes."""
        return sum(q.qsize() for q in self._queues.values())

    @property
    def active_requests(self) -> int:
        """Decoding and mid chunked prefill: both hold a slot."""
        return len(self._active) + len(self._prefilling)

    @property
    def brownout_level(self) -> int:
        return self._overload.level

    # --------------------------------------------------------- lifecycle

    def start(self) -> "ContinuousBatcher":
        if self._watchdog is not None:
            self._watchdog.start()
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
        if self._watchdog is not None:
            self._watchdog.stop()
        self._fail_pending(Draining("serving shut down before drain"))

    @property
    def draining(self) -> bool:
        return self._draining

    def _fail_pending(self, exc: Exception) -> None:
        for q in self._queues.values():
            while True:
                try:
                    q.get_nowait().future.set_exception(exc)
                except queue.Empty:
                    break
        for item, _ in list(self._prefilling.values()):
            self._prefilling.pop(item.slot, None)
            self._retire(item, truncated="shutdown")
        for item in list(self._active.values()):
            self._retire(item, truncated="shutdown")

    # -------------------------------------------------------------- loop

    def _wd(self, phase: str) -> None:
        if self._watchdog is not None:
            self._watchdog.enter(phase)

    def _loop(self) -> None:
        reg = self.registry
        decode_steps = 0
        while not self._stop.is_set():
            self._overload.update(queue_depth=self.queue_depth(),
                                  kv_occupancy=float(self.engine.pool.occupancy))
            # Free slots for waiting interactive requests before this
            # iteration's admission takes them.
            self._preempt_for_interactive()
            staged = self._gather()
            if staged:
                self._wd("serve_prefill")
            for item in staged:
                try:
                    self._admit(item)
                except Exception as e:  # noqa: BLE001 — one bad request must
                    # not take the serve loop down
                    if isinstance(e, (BlockExhausted, ValueError)):
                        log.warning("request refused at admission: %s", e)
                    else:
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
                self._wd("serve_prefill")
                self._chunk_step()
            if not self._active:
                continue
            self._wd("serve_decode")
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
            decode_steps += 1
            if self._watchdog is not None:
                self._watchdog.ping(decode_steps)
            reg.histogram("serving/decode_step").record(dt)
            tpot = reg.histogram("serving/tpot")
            for slot, toks in out.items():
                item = self._active[slot]
                cls_tpot = reg.histogram(f"serving/tpot_{item.req.slo}")
                item.spec_drafted += drafts_by_slot.get(slot, 0)
                item.spec_accepted += len(toks) - 1
                committed: list[int] = []
                for token in toks:
                    item.tokens.append(token)
                    item.last_token = token
                    committed.append(token)
                    tpot.record(dt / len(toks))
                    cls_tpot.record(dt / len(toks))
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
        request has a draft takes the plain decode rung, same tokens.
        Brownout level 3 and up takes the plain rung every step."""
        if self._draft is None or self._overload.spec_disabled():
            out = self.engine.decode([
                (it.slot, it.last_token, it.req.seed, it.req.temperature, it.req.top_k)
                for it in self._active.values()
            ])
            return {slot: [tok] for slot, tok in out.items()}
        entries, proposed = [], {}
        for it in self._active.values():
            k_eff = min(self.spec_k, it.req.max_new_tokens - len(it.tokens) - 1,
                        it.max_new_eff - len(it.tokens) - 1)
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

    def _free_slots(self) -> int:
        return min(self.max_batch - len(self._active) - len(self._prefilling),
                   self.engine.pool.num_slots - self.engine.pool.active_slots)

    def _gather(self) -> list[_InFlight]:
        """Pull admissible requests without over-committing slots. Idle:
        block briefly for the first arrival, then hold ``max_delay_s`` so
        a burst prefills together. Busy: take what is queued, no wait."""
        free = self._free_slots()
        staged: list[_InFlight] = []
        if not self._active and not self._prefilling:
            self._wd("serve_idle")
            if not self._take(staged, timeout=0.05):
                return staged
            window_end = time.monotonic() + self.max_delay_s
            while len(staged) < free:
                remaining = window_end - time.monotonic()
                if remaining <= 0 or not self._take(staged, timeout=remaining):
                    break
        else:
            self._wd("serve_admit")
            while len(staged) < free and self._take(staged):
                pass
        self.registry.gauge("serving/queue_depth").set(self.queue_depth())
        return staged

    def _take(self, staged: list, timeout: float | None = None) -> bool:
        """Dequeue one request into ``staged``, interactive first, counted
        in ``_staged`` the moment it leaves its queue. With a timeout,
        wait on the arrival event; returns whether a request was taken."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            for cls in SLO_CLASSES:
                try:
                    item = self._queues[cls].get_nowait()
                except queue.Empty:
                    continue
                self._staged += 1
                staged.append(item)
                return True
            if deadline is None:
                return False
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            # Clear-then-recheck closes the missed-wakeup race with
            # submit()'s put-then-set.
            self._arrival.clear()
            if any(not q.empty() for q in self._queues.values()):
                continue
            if not self._arrival.wait(timeout=remaining):
                return False

    # ------------------------------------------------------- preemption

    def _preempt_for_interactive(self) -> None:
        """When interactive requests wait and the slots are exhausted,
        evict batch requests, mid chunked prefill first, then the most
        recently admitted (least sunk work), and re-queue them."""
        waiting = self._queues["interactive"].qsize()
        if not waiting:
            return
        need = waiting - max(self._free_slots(), 0)
        if need <= 0:
            return
        victims = [it for it, _ in self._prefilling.values() if it.req.slo == "batch"]
        victims += sorted((it for it in self._active.values() if it.req.slo == "batch"),
                          key=lambda it: it.t_admit or 0.0, reverse=True)
        for item in victims[:need]:
            self._preempt(item)

    def _preempt(self, item: _InFlight) -> None:
        reg = self.registry
        slot = item.slot
        self._prefilling.pop(slot, None)
        self._active.pop(slot, None)
        # free() points the slot's table at the null block: the next
        # decode graph replay writes nothing through the freed slot.
        self.engine.pool.free(slot)
        self._drop_draft(slot)
        if item.spans is not None:
            if item.t_decode0 is not None:
                self._close_decode_segment(item, preempted=True)
            else:
                # Evicted mid-prefill: a point marker keeps the preemption
                # in the trace (and forces it kept).
                item.spans.append(close_span("preempted", time.monotonic(),
                                             tags={"preempted": True, "phase": "prefill"}))
        # Replay from the prompt; the original t_submit keeps queue-wait
        # and deadline accounting honest about the whole wait.
        item.slot = None
        item.t_admit = None
        item.t_first = None
        item.tokens = []
        item.last_token = None
        item.spec_drafted = 0
        item.spec_accepted = 0
        item.max_new_eff = item.req.max_new_tokens
        reg.counter("serving/preempted_total").inc()
        try:
            self._queues["batch"].put_nowait(item)
        except queue.Full:
            # The batch queue is full: the preemption becomes a shed.
            reg.counter("serving/shed_total").inc()
            reg.counter("serving/shed_batch_total").inc()
            if not item.future.done():
                item.future.set_exception(QueueFull(
                    "preempted for interactive traffic and the batch queue is full; load shed"))

    # -------------------------------------------------------- admission

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
        req = item.req
        reg.histogram("serving/queue_wait").record(now - item.t_submit)
        reg.histogram(f"serving/queue_wait_{req.slo}").record(now - item.t_submit)
        if item.spans is not None:
            item.spans.append(close_span("queue_wait", item.t_submit, tags={
                "slo": req.slo, "brownout_level": self._overload.level}))
        cap = self._overload.max_new_cap()
        if cap is not None and req.kind in ("generate", "resume"):
            item.max_new_eff = min(req.max_new_tokens, cap)
        if req.kind == "resume":
            # No prefill: map the handed-off pages in and continue from
            # the prefill replica's first token.
            t_import = time.monotonic()
            self.engine.import_kv_pages(slot, req.pages, req.prompt)
            self._record_ttft(item)
            if item.spans is not None:
                item.spans.append(close_span("resume_import", t_import,
                                             tags={"tokens": len(req.prompt)}))
                self._start_decode_segment(item)  # the first token is in it
            self._enter_decode(item, req.first_token)
            return
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
            _, first, last_logits = self.engine.prefill_step(state)
        else:
            first, last_logits = self.engine.prefill(slot, req.prompt, seed=req.seed,
                                                     temperature=req.temperature,
                                                     top_k=req.top_k)
        reg.histogram("serving/prefill").record(time.perf_counter() - t0)
        self._finish_prefill(item, first, last_logits)

    def _record_ttft(self, item: _InFlight) -> None:
        item.t_first = time.monotonic()
        ttft = item.t_first - item.t_submit
        self.registry.histogram("serving/ttft").record(ttft)
        self.registry.histogram(f"serving/ttft_{item.req.slo}").record(ttft)
        self._overload.note_ttft(ttft)
        if item.spans is not None:
            self.exemplars.record("serving/ttft", ttft, item.req.trace["trace_id"])

    def _start_decode_segment(self, item: _InFlight) -> None:
        """Open a decode segment span: one continuous slot residency."""
        item.t_decode0 = time.monotonic()
        item.decode_seg += 1
        item.decode_tok0 = len(item.tokens)

    def _close_decode_segment(self, item: _InFlight, *, preempted: bool = False) -> None:
        if item.spans is None or item.t_decode0 is None:
            return
        tags = {"segment": item.decode_seg, "tokens": len(item.tokens) - item.decode_tok0}
        if preempted:
            tags["preempted"] = True
        item.spans.append(close_span("decode_segment", item.t_decode0, tags=tags))
        item.t_decode0 = None

    def _enter_decode(self, item: _InFlight, first: int) -> None:
        item.tokens.append(first)
        item.last_token = first
        if item.spans is not None and item.t_decode0 is None:
            self._start_decode_segment(item)
        if self._draft is not None:
            self._draft.begin(item.slot, list(item.req.prompt) + [first])
        self._active[item.slot] = item
        self._maybe_finish(item)

    def _finish_prefill(self, item: _InFlight, first: int, last_logits) -> None:
        """Single-shot and chunked prefill's shared tail: TTFT, then by
        kind: classify resolves the logits head, prefill exports the KV
        pages, generate joins the decode set."""
        self._record_ttft(item)
        req, slot = item.req, item.slot
        if item.spans is not None:
            # Admission to first token: the one prefill dispatch, or the
            # chunks with the decode steps between them.
            item.spans.append(close_span("prefill", item.t_admit,
                                         tags={"prompt_tokens": len(req.prompt)}))
        if req.kind in ("classify", "prefill"):
            if req.kind == "classify":
                result = Result(tokens=[], prompt_len=len(req.prompt),
                                top=top_logprobs(last_logits, req.classify_top_n))
            else:
                result = Result(tokens=[first], prompt_len=len(req.prompt),
                                pages=self.engine.export_kv_pages(
                                    slot, req.prompt, skip_tokens=req.skip_tokens))
            self.engine.pool.free(slot)
            item.slot = None
            self._resolve(item, result)
            return
        self._enter_decode(item, first)

    def _chunk_step(self) -> None:
        """Run one chunk of the first in-flight chunked prefill
        (interactive before batch, then admission order); after the last
        one the request goes on as a single-shot admission would (the last
        chunk samples with the unchunked key)."""
        reg = self.registry
        slot = next((s for s, (it, _) in self._prefilling.items()
                     if it.req.slo == "interactive"), next(iter(self._prefilling)))
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
        t_chunk = time.monotonic()
        try:
            done, first, last_logits = self.engine.prefill_step(state)
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
        if item.spans is not None:
            item.spans.append(close_span("prefill_chunk", t_chunk, tags={"chunk": state.idx}))
        if not done:
            return
        del self._prefilling[slot]
        # Chunked prefill wall: admission to the last chunk, decode steps
        # interleaved inside it.
        reg.histogram("serving/prefill").record(time.monotonic() - item.t_admit)
        self._finish_prefill(item, first, last_logits)

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
        if not done and len(item.tokens) >= item.max_new_eff:
            # The brownout cap: a prefix of the full stream, labeled so.
            done, truncated = True, "brownout"
            self.registry.counter("serving/brownout_truncated_total").inc()
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
        self._close_decode_segment(item)
        self._resolve(item, Result(tokens=item.tokens, prompt_len=len(item.req.prompt),
                                   truncated=truncated, spec_drafted=item.spec_drafted,
                                   spec_accepted=item.spec_accepted))

    def _resolve(self, item: _InFlight, result: Result) -> None:
        now = time.monotonic()
        result.queue_wait_s = (item.t_admit or now) - item.t_submit
        result.ttft_s = item.t_first - item.t_submit if item.t_first else None
        result.total_s = now - item.t_submit
        reg = self.registry
        reg.histogram("serving/e2e").record(result.total_s)
        reg.histogram(f"serving/e2e_{item.req.slo}").record(result.total_s)
        reg.counter("serving/completed_total").inc()
        # The delivering replica owns the whole stream (a resume counts
        # its first token too); the prefill leg counts none.
        reg.counter("serving/generated_tokens_total").inc(
            0 if item.req.kind == "prefill" else len(result.tokens))
        if item.spans is not None:
            result.spans = item.spans
            self.exemplars.record("serving/e2e", result.total_s, item.req.trace["trace_id"])
        if item.future.set_running_or_notify_cancel():
            item.future.set_result(result)

    # ------------------------------------------------------------- stats

    def stats_line(self) -> dict:
        """A ``kind="serving"`` line stamped ``SERVING_SCHEMA_VERSION`` (14,
        the reference's): the registry's serving counters, gauges and
        latency percentiles, and the ``serving`` object as the reference's
        ``stats_line`` writes it: pool occupancy, ``post_warmup_recompiles``,
        the speculation keys ``SERVING_KEYS_V8`` when speculation is on,
        the overload keys ``SERVING_KEYS_V10``, the paged pool's fields
        (``SERVING_KEYS_V9`` among them) and the precision keys
        ``SERVING_KEYS_V11`` when the weights are quantized. A sharded
        engine's line also carries ``mesh_shape`` and
        ``param_sharding_digest`` (the reference's ``SHARDING_KEYS``) at
        the top level, since the ``serving`` object holds only numbers."""
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
        for cls in SLO_CLASSES:
            for name in ("queue_wait", "ttft", "tpot"):
                h = hists.get(f"serving/{name}_{cls}")
                if h and h["count"]:
                    serving[f"{name}_p95_{cls}"] = h["p95"]
        serving.update(
            shed_interactive=int(counters.get("serving/shed_interactive_total", 0)),
            shed_batch=int(counters.get("serving/shed_batch_total", 0)),
            preempted_batch=int(counters.get("serving/preempted_total", 0)),
            brownout_level=int(self._overload.level),
            brownout_transitions=int(self._overload.transitions()),
        )
        paged = getattr(self.engine.pool, "paged_stats", None)
        if callable(paged):
            serving.update(paged())
        pstats = self.engine.precision_stats()
        if pstats:
            serving.update({k: pstats[k] for k in SERVING_KEYS_V11})
        line = {
            "schema_version": SERVING_SCHEMA_VERSION,
            "kind": "serving", "step": int(counters.get("serving/decode_steps", 0)),
            "time_unix": time.time(), "session_start_unix": self._start_unix, "host": 0,
            "metrics": {}, "counters": counters, "gauges": gauges, "derived": derived,
            "serving": serving,
        }
        if getattr(self.engine, "param_sharding_digest", None):
            line.update(mesh_shape=self.engine.mesh_shape,
                        param_sharding_digest=self.engine.param_sharding_digest)
        return line
