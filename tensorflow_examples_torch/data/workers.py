"""Background decode and augment workers: the port of
``tensorflow_examples_tpu/data/workers.py``.

A :class:`WorkerPool` runs a host stage of the input pipeline (ImageNet's
JPEG decode and augmentation) on worker threads, with the reference's
three properties:

* **Order.** Items carry sequence numbers and results come back in
  submission order, so the stream is the one a sequential pipeline
  makes, bit for bit, whatever the worker count.
* **Bounded queues.** At most ``depth`` items are in flight, so a slow
  consumer holds the pipeline back instead of buffering the dataset.
* **Poison-pill shutdown.** ``close()`` drops queued work, sends one
  pill a worker and joins them; it is idempotent, and ``shutdown_all``
  runs at interpreter exit, so no worker thread outlives the run.

Threads, not processes: the JPEG stage (``data/csrc/jpeg.cpp`` through ctypes)
releases the GIL. While a pool is open the interpreter's switch interval
is 1 ms (restored when the last pool closes), since the pipeline lives
on per-item hand-offs between threads. Workers time their work as
``data_work`` spans from their own threads; a consumer of a
:class:`PipelinedIterator` (``background = True``) times its pops as
``data_wait`` (``data/prefetch.py``). The gauges ``data/input_workers``
and ``data/workers_busy`` and the counter ``data/worker_items`` are on
the port's registry.
"""

from __future__ import annotations

import atexit
import logging
import queue
import sys
import threading
import weakref
from typing import Callable, Iterable, Iterator

from tensorflow_examples_torch.telemetry import registry as _registry
from tensorflow_examples_torch.telemetry import spans as _spans

log = logging.getLogger(__name__)

_POISON = object()  # the shutdown sentinel; never a user item

# Pools still open at exit (weak: a collected pool's finalizer closed it).
_LIVE_POOLS: "weakref.WeakSet[WorkerPool]" = weakref.WeakSet()


def shutdown_all() -> None:
    """Close every live pool (the atexit hook)."""
    for pool in list(_LIVE_POOLS):
        pool.close()


atexit.register(shutdown_all)

# The switch interval, refcounted over open pools.
_SWITCH_LOCK = threading.Lock()
_SWITCH_DEPTH = 0  # guard: _SWITCH_LOCK
_SAVED_SWITCH_INTERVAL: float | None = None  # guard: _SWITCH_LOCK

# Pools share the worker gauges (a rollback briefly overlaps the old
# pipeline's pool and its replacement), so they move by deltas.
_GAUGE_LOCK = threading.Lock()


def _adjust_gauge(reg, name: str, delta: float) -> None:
    with _GAUGE_LOCK:
        gauge = reg.gauge(name)
        gauge.set(max((gauge.value or 0.0) + delta, 0.0))


def _enter_fast_switch() -> None:
    global _SWITCH_DEPTH, _SAVED_SWITCH_INTERVAL
    with _SWITCH_LOCK:
        _SWITCH_DEPTH += 1
        if _SWITCH_DEPTH == 1 and sys.getswitchinterval() > 0.001:
            _SAVED_SWITCH_INTERVAL = sys.getswitchinterval()
            sys.setswitchinterval(0.001)


def _exit_fast_switch() -> None:
    global _SWITCH_DEPTH, _SAVED_SWITCH_INTERVAL
    with _SWITCH_LOCK:
        _SWITCH_DEPTH = max(_SWITCH_DEPTH - 1, 0)
        if _SWITCH_DEPTH == 0 and _SAVED_SWITCH_INTERVAL is not None:
            sys.setswitchinterval(_SAVED_SWITCH_INTERVAL)
            _SAVED_SWITCH_INTERVAL = None


class WorkerError(RuntimeError):
    """A worker's exception, raised at the item's place in the stream, so
    a failure lands at the same batch on every run."""

    def __init__(self, seq: int, cause: BaseException):
        super().__init__(f"input worker failed on item {seq}: {cause!r}")
        self.seq = seq


class WorkerPool:
    """A fixed pool of threads applying ``fn`` to submitted items; results
    come back in submission order."""

    def __init__(self, fn: Callable, num_workers: int, *, depth: int = 0,
                 name: str = "input_worker", registry=None):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.fn = fn
        self.num_workers = int(num_workers)
        # Two items a worker by default: one running, one queued behind it.
        self.depth = int(depth) if depth else 2 * self.num_workers
        self.name = name
        self._registry = registry
        _enter_fast_switch()  # restored when the last pool closes
        self._in: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._cond = threading.Condition()
        self._results: dict[int, tuple[bool, object]] = {}  # guard: self._cond
        self._closed = False  # guard: self._cond
        self._threads = [threading.Thread(target=self._work, name=f"{name}-{i}", daemon=True)
                         for i in range(self.num_workers)]
        for t in self._threads:
            t.start()
        _LIVE_POOLS.add(self)
        _adjust_gauge(self._reg(), "data/input_workers", self.num_workers)

    def _reg(self):
        return self._registry if self._registry is not None else _registry.default_registry()

    def submit(self, seq: int, item) -> None:
        """Queue one item; blocks while ``depth`` items are in flight."""
        if self._closed:  # best effort: result() re-checks under the lock
            raise RuntimeError(f"WorkerPool {self.name!r} is closed")
        self._in.put((seq, item))

    def result(self, seq: int):
        """Item ``seq``'s result, once ready; its worker's exception is
        raised here as :class:`WorkerError`."""
        with self._cond:
            while seq not in self._results:
                if self._closed:
                    raise RuntimeError(f"WorkerPool {self.name!r} closed with item {seq} "
                                       "outstanding")
                self._cond.wait(timeout=0.1)
            ok, value = self._results.pop(seq)
        if not ok:
            raise WorkerError(seq, value) from value
        return value

    def map_ordered(self, items: Iterable) -> Iterator:
        """``map(fn, items)`` with ``depth`` items in flight: the same
        results in the same order."""
        it = iter(items)
        submitted = served = 0
        exhausted = False
        try:
            while True:
                while not exhausted and submitted - served < self.depth:
                    try:
                        item = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    self.submit(submitted, item)
                    submitted += 1
                if served == submitted and exhausted:
                    return
                yield self.result(served)
                served += 1
        finally:
            # Closing this generator unwinds the source's own finally
            # (the shard readers' shutdown) now, not at a later GC pass.
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _work(self) -> None:
        reg = self._reg()
        items_ctr = reg.counter("data/worker_items")
        while True:
            got = self._in.get()
            if got is _POISON:
                return
            seq, item = got
            _adjust_gauge(reg, "data/workers_busy", +1)
            try:
                with _spans.span("data_work"):
                    out = (True, self.fn(item))
                items_ctr.inc()
            except BaseException as e:  # noqa: BLE001 - raised at seq
                out = (False, e)
            _adjust_gauge(reg, "data/workers_busy", -1)
            with self._cond:
                self._results[seq] = out
                self._cond.notify_all()

    def close(self, *, timeout: float = 5.0) -> None:
        """Drop queued work, stop every worker and wake a waiting
        ``result()``; idempotent, safe from finalizers and ``atexit``."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        try:  # make room for the pills
            while True:
                self._in.get_nowait()
        except queue.Empty:
            pass
        for _ in self._threads:
            self._in.put(_POISON)
        for t in self._threads:
            t.join(timeout)
            if t.is_alive():  # pragma: no cover - a wedged C call
                log.warning("worker thread %s did not exit within %.1fs (daemon; will not "
                            "block interpreter exit)", t.name, timeout)
        _adjust_gauge(self._reg(), "data/input_workers", -self.num_workers)
        _exit_fast_switch()

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PipelinedIterator:
    """An iterator over ``pool.map_ordered(items)`` with
    ``background = True``, the marker ``data/prefetch.py`` reads to time
    its pops as ``data_wait``. Closing it (explicitly, through ``with``,
    at its end or by its finalizer) closes the source and the pool."""

    background = True

    def __init__(self, pool: WorkerPool, items: Iterable):
        self._pool = pool
        self._gen = pool.map_ordered(items)
        self._finalizer = weakref.finalize(self, pool.close)

    def __iter__(self) -> "PipelinedIterator":
        return self

    def __next__(self):
        try:
            return next(self._gen)
        except StopIteration:
            self.close()
            raise

    def close(self) -> None:
        try:
            self._gen.close()
        finally:
            self._finalizer()  # pool.close(), once

    def __enter__(self) -> "PipelinedIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
