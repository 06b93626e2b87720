"""Rank 0's engine calls, replayed on every other rank of a sharded engine.

The reference has no counterpart of this module. It serves a sharded
model from one process: a single controller places the params and the
KV pool on the mesh, and GSPMD puts the tensor-parallel collectives into
each compiled step. The port's mesh is one process a rank
(``core/mesh.py``), so its sharded engine is SPMD code: every rank holds
an ``InferenceEngine`` over its own pieces of the params and its own
heads of the KV pool, and every rank must make the same engine calls,
in the same order, with the same arguments, or their ``model`` psums
pair up wrong. This module is that structure, not a feature.

Rank 0 alone runs the batcher and the HTTP frontend, over
:meth:`MeshDriver.leader`'s proxy of its engine. Before the proxy runs
a call that does device work or changes the pool's host state (the
engine's ``warmup``, ``prefill``, ``prefill_open``, ``prefill_step``,
``decode``, ``verify``, ``export_kv_pages`` and reference forwards; the
pool's ``alloc``, ``free``, ``reset`` and ``reallocate``), it publishes
the call and its arguments to every other rank with a
``torch.distributed`` object broadcast over a gloo group of its own
(host objects, on the CPU). The other ranks run
:meth:`MeshDriver.follow`, which replays each call on their engine until
rank 0 sends the stop (:meth:`MeshDriver.stop`). Every other attribute
is read from rank 0's engine as it is. After the ``model`` psums every
rank holds the same logits, so every rank samples the same token from
the same key, takes the same blocks and keeps the same block tables,
free lists and prefix-cache hashes; rank 0's result is the one returned.

``import_kv_pages`` is published otherwise (:meth:`MeshDriver.import_pages`),
so that no follower is sent the heads it does not hold: rank 0 decodes
and checks the payload (``engine.check_pages``), publishes the meta (or
the refusal, which then raises the same ``ValueError`` on every rank),
and scatters each rank its heads of k, v and the int8 scales over the
driver's group, as bytes; every rank then maps them
(``engine.map_pages``), whose claim raises a ``BlockExhausted`` or
refuses a cold delta alike everywhere.

Each message also carries how rank 0's previous call ended (None, or
the name of the exception it raised). A call that raises on every rank
alike (a ``BlockExhausted`` at admission, a prompt that is too long) is
a request's failure and the replay goes on. A follower whose call ends
otherwise than rank 0's raises :class:`ReplayDiverged`, chained to its
own exception if it had one: the rank's process exits and brings the
world down (``torchrun`` stops the other ranks); it is never swallowed.
A rank that fails inside a step leaves its peers waiting in a psum
until the process group's timeout. The MeshDriver's own group waits
without such a limit, since a server may idle for as long as it likes.
"""

from __future__ import annotations

import collections
import datetime
import functools
import logging
import threading
import time

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# The calls rank 0 publishes before it runs them.
ENGINE_CALLS = ("warmup", "prefill", "prefill_open", "prefill_step", "decode", "verify",
                "export_kv_pages", "reference_logits", "reference_generate",
                "reference_classify")
POOL_CALLS = ("alloc", "free", "reset", "reallocate")
# How long a follower waits for rank 0's next call (the MeshDriver group's timeout).
IDLE_TIMEOUT = datetime.timedelta(days=365)


class ReplayDiverged(RuntimeError):
    """A follower's replayed call ended otherwise than rank 0's."""


class MeshDriver:
    """Publishes rank 0's engine calls and replays them on the other ranks.

    Every rank of the process group constructs one, in the same order
    relative to its other ``new_group`` calls (after its engine). On rank
    0, ``calls`` counts the calls published and ``publish_s`` their
    broadcasts' host seconds. On the other ranks, ``raised`` counts the
    replayed calls that raised (as rank 0's did), by exception name."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self._group = dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT)
        self._lock = threading.Lock()
        self._outcome = None
        self.calls = 0
        self.publish_s = 0.0
        self.raised: collections.Counter = collections.Counter()

    # -------------------------------------------------------------- rank 0

    def leader(self, engine) -> "LeaderEngine":
        """Rank 0's engine as the batcher and frontend use it."""
        if self.rank != 0:
            raise RuntimeError(f"rank {self.rank} follows; only rank 0 leads")
        return LeaderEngine(engine, self)

    def _publish(self, kind: str, name, args=(), kwargs=None) -> None:
        t0 = time.perf_counter()
        dist.broadcast_object_list([(kind, name, args, kwargs or {}, self._outcome)], src=0,
                                   group=self._group)
        self.publish_s += time.perf_counter() - t0

    def call(self, target, kind: str, name, *args, **kwargs):
        """Publish ``(kind, name, args)``, then run ``target(*args)`` here
        and record how it ended for the next message."""
        with self._lock:
            self._publish(kind, name, args, kwargs)
            self.calls += 1
            try:
                out = target(*args, **kwargs)
            except Exception as e:
                self._outcome = type(e).__name__
                raise
            self._outcome = None
            return out

    def run(self, engine, fn, *args):
        """``fn(engine, *args)`` on every rank, in call order: a
        module-level function (it is pickled by name), such as a
        measurement window around the next calls. Rank 0's result is
        returned."""
        return self.call(functools.partial(fn, engine), "run", fn, *args)

    def import_pages(self, engine, slot: int, payload, prompt):
        """Rank 0's ``engine.import_kv_pages``: the payload decoded and
        checked here, each rank sent only its heads (see the module)."""
        try:
            meta, arrays = engine.check_pages(payload, prompt)
        except ValueError as e:
            refusal, meta, arrays, layout = e, None, None, None
        else:
            refusal = None
            heads = engine.head_slice()
            layout = {name: (a.dtype, tuple(a[:, :, heads].shape)) for name, a in arrays.items()}
        lead = functools.partial(self._import, engine, arrays, refusal)
        return self.call(lead, "import", "import_kv_pages", slot, meta, prompt, layout,
                         None if refusal is None else str(refusal))

    def _import(self, engine, arrays, refusal, slot, meta, prompt, layout, message) -> None:
        if message is not None:
            raise refusal if refusal is not None else ValueError(message)
        pieces = {}
        for name, (dtype, shape) in layout.items():
            out = torch.empty(shape, dtype=dtype).view(torch.uint8)
            chunks = None
            if self.rank == 0:
                chunks = [arrays[name][:, :, engine.head_slice(r)].contiguous().view(torch.uint8)
                          for r in range(self.world_size)]
            dist.scatter(out, chunks, src=0, group=self._group)
            pieces[name] = out.view(dtype)
        engine.map_pages(slot, meta, pieces, prompt)

    def stop(self) -> None:
        """End every follower's replay (rank 0, once, after the last call)."""
        with self._lock:
            self._publish("stop", None)

    # --------------------------------------------------------- other ranks

    def follow(self, engine) -> int:
        """Replay rank 0's calls on ``engine`` until the stop; returns the
        number of calls replayed."""
        if self.rank == 0:
            raise RuntimeError("rank 0 leads; the other ranks follow")
        outcome, error, replayed, last = None, None, 0, None
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self._group)
            kind, name, args, kwargs, leader_outcome = box[0]
            if leader_outcome != outcome:
                raise ReplayDiverged(
                    f"rank {self.rank}: call {replayed - 1} ({last}) ended with "
                    f"{outcome or 'success'} here but with {leader_outcome or 'success'} on "
                    "rank 0") from error
            if kind == "stop":
                return replayed
            if kind == "engine" and name in ENGINE_CALLS:
                target = getattr(engine, name)
            elif kind == "pool" and name in POOL_CALLS:
                target = getattr(engine.pool, name)
            elif kind == "run":
                target = functools.partial(name, engine)
            elif kind == "import":
                target = functools.partial(self._import, engine, None, None)
            else:
                raise ReplayDiverged(f"rank {self.rank}: rank 0 published an unknown call "
                                     f"{kind}.{name}")
            last = f"{kind}.{getattr(name, '__name__', name)}"
            try:
                target(*args, **kwargs)
                outcome, error = None, None
            except Exception as e:
                outcome, error = type(e).__name__, e
                self.raised[outcome] += 1
                log.info("rank %d: replayed %s.%s raised %s (as rank 0's must have)",
                         self.rank, kind, name, outcome)
            replayed += 1


class _LeaderPool:
    """Rank 0's KV pool: ``alloc``/``free``/``reset``/``reallocate``
    published, everything else read as it is."""

    def __init__(self, pool, driver: MeshDriver):
        self._pool = pool
        self._driver = driver

    def __getattr__(self, name):
        attr = getattr(self._pool, name)
        if name in POOL_CALLS:
            return functools.partial(self._driver.call, attr, "pool", name)
        return attr


class LeaderEngine:
    """Rank 0's engine behind the driver: the calls of :data:`ENGINE_CALLS`
    published before they run, ``import_kv_pages`` through
    :meth:`MeshDriver.import_pages`, the pool's through
    :class:`_LeaderPool`, every other attribute the engine's own."""

    def __init__(self, engine, driver: MeshDriver):
        self.engine = engine
        self.driver = driver
        self.pool = _LeaderPool(engine.pool, driver)

    def import_kv_pages(self, slot: int, payload, prompt):
        return self.driver.import_pages(self.engine, slot, payload, prompt)

    def __getattr__(self, name):
        attr = getattr(self.engine, name)
        if name in ENGINE_CALLS:
            return functools.partial(self.driver.call, attr, "engine", name)
        return attr
