"""Device prefetch: the port of ``tensorflow_examples_tpu/data/prefetch.py``
(``bundle_batches``, ``DepthController`` and ``device_prefetch``; the
multi-host ``put_local_batch`` waits for the mesh port).

A look-ahead queue holds batches already on their way to the device. On
the card each host batch is staged in pinned host memory and copied on a
side CUDA stream; the consuming stream waits on that copy's event when
the batch leaves the queue (and the batch's memory is recorded on it),
so batch N+1 streams in while step N runs and no step reads a batch
before its copy is done. On the CPU a batch is simply made a tensor.

Each fetch runs through the fault-injection hook (``utils/faults.py``:
``slow@N`` and ``badbatch@N`` land here). A batch whose conversion or
transfer fails is skipped and counted, up to ``max_skips``
(``TrainConfig.max_skipped_batches``; 0 fails fast with the original
error). Fetches and skips count in ``data/batches_fetched`` and
``data/batches_skipped``; the host work of a fetch is the ``data_work``
span. ``depth_max > depth`` arms :class:`DepthController`, which deepens
the queue while the ``data_fetch`` span's p95 dominates the
``device_step`` p95 and shrinks it back when the queue stays ahead; the
live depth is the ``data/prefetch_depth`` gauge.
"""

from __future__ import annotations

import collections
import contextlib
import logging
from typing import Iterator, Mapping

import numpy as np
import torch

from tensorflow_examples_torch.telemetry import registry as registry_mod
from tensorflow_examples_torch.telemetry.spans import span
from tensorflow_examples_torch.utils import faults

log = logging.getLogger(__name__)

# Re-derive the depth every N fetches, and the fetch-p95 / step-p95
# ratios above which the queue grows and below which it shrinks: the
# reference's values.
ADAPT_EVERY = 16
GROW_RATIO = 1.0
SHRINK_RATIO = 0.1


def _host_tensor(x) -> torch.Tensor:
    """A CPU tensor of a host leaf; raises on a leaf no tensor holds."""
    return x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def put_batch(batch: Mapping, device: torch.device) -> dict[str, torch.Tensor]:
    """One synchronous host-to-device placement (the eval path); device
    tensors pass through."""
    return {k: _host_tensor(v).to(device) for k, v in batch.items()}


def bundle_batches(it: Iterator, k: int) -> Iterator:
    """Stack ``k`` consecutive host batches along a new leading axis, for
    the ``steps_per_launch`` step: leaves ``[k, batch, ...]``. Ending
    mid-bundle raises (dropping a partial bundle would skip steps); a
    stream that ends on a bundle boundary ends cleanly."""
    while True:
        group = []
        for _ in range(k):
            try:
                group.append(next(it))
            except StopIteration:
                if group:
                    raise ValueError(
                        f"input stream ended mid-bundle ({len(group)}/{k} batches); size the "
                        "stream to a multiple of steps_per_launch") from None
                return
        yield {key: np.stack([np.asarray(b[key]) for b in group]) for key in group[0]}


class DepthController:
    """Sizes the prefetch queue within ``[depth, depth_max]`` from the
    observed ``data_fetch`` p95 against the ``device_step`` p95; a fixed
    ``depth`` unless ``depth_max > depth``."""

    def __init__(self, depth: int = 2, depth_max: int = 0, *, registry=None,
                 adapt_every: int = ADAPT_EVERY):
        self.floor = max(int(depth), 1)
        self.depth = self.floor
        self.depth_max = int(depth_max)
        self.adaptive = self.depth_max > self.floor
        self._adapt_every = max(int(adapt_every), 1)
        self._registry = registry if registry is not None else registry_mod.default_registry()
        self._fetches = 0
        self._registry.gauge("data/prefetch_depth").set(float(self.depth))

    def observe(self) -> int:
        """Count one fetch; every ``adapt_every`` fetches re-derive the
        depth. Returns the current depth."""
        self._fetches += 1
        if not self.adaptive or self._fetches % self._adapt_every:
            return self.depth
        fetch_p95 = self._registry.histogram("span/data_fetch").summary()["p95"]
        step_p95 = self._registry.histogram("span/device_step").summary()["p95"]
        if fetch_p95 is None or step_p95 is None or step_p95 <= 0:
            return self.depth
        ratio = fetch_p95 / step_p95
        before = self.depth
        if ratio >= GROW_RATIO and self.depth < self.depth_max:
            self.depth += 1
        elif ratio < SHRINK_RATIO and self.depth > self.floor:
            self.depth -= 1
        if self.depth != before:
            self._registry.gauge("data/prefetch_depth").set(float(self.depth))
            log.info("prefetch depth %d -> %d (data_fetch p95 %.4fs vs device_step p95 %.4fs)",
                     before, self.depth, fetch_p95, step_p95)
        return self.depth


_END = object()


def device_prefetch(it: Iterator, device: torch.device, *, depth: int = 2, depth_max: int = 0,
                    max_skips: int = 0) -> Iterator:
    """Batches of ``it`` as device tensors, ``depth`` (or the controller's
    live depth) ahead of the consumer."""
    device = torch.device(device)
    reg = registry_mod.default_registry()
    fetched_ctr = reg.counter("data/batches_fetched")
    skipped_ctr = reg.counter("data/batches_skipped")
    ctl = DepthController(depth, depth_max)
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    queue: collections.deque = collections.deque()
    skipped = 0

    def put(batch):
        """Start one batch's transfer: (device tensors, copy event)."""
        if copy_stream is None:
            return {k: _host_tensor(v) for k, v in batch.items()}, None
        host = {k: _host_tensor(v).pin_memory() for k, v in batch.items()}
        with torch.cuda.stream(copy_stream):
            out = {k: t.to(device, non_blocking=True) for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(copy_stream)
        return out, event

    def fetch():
        """The next transfer in flight, or _END. With ``max_skips`` > 0 a
        batch that fails its conversion is skipped and counted; a fault
        of the source iterator itself always propagates."""
        nonlocal skipped
        while True:
            from_source = True
            try:
                with span("data_work"):
                    batch = next(it)
                    from_source = False
                    eng = faults.active()
                    if eng is not None:
                        batch = eng.batch_hook(batch)
                    out = put(batch)
            except StopIteration:
                return _END
            except Exception as e:
                if from_source or max_skips <= 0:
                    raise
                skipped += 1
                skipped_ctr.inc()
                if skipped > max_skips:
                    raise RuntimeError(f"poisoned input batch ({skipped} bad, budget "
                                       f"max_skipped_batches={max_skips} exhausted): {e}") from e
                log.warning("skipping poisoned input batch %d/%d: %s", skipped, max_skips, e)
                continue
            fetched_ctr.inc()
            return out

    def refill(done: bool) -> bool:
        while not done and len(queue) < ctl.depth:
            entry = fetch()
            if entry is _END:
                return True
            queue.append(entry)
        return done

    try:
        done = refill(False)
        while queue:
            out, event = queue.popleft()
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for t in out.values():
                    t.record_stream(stream)
            ctl.observe()
            done = refill(done)
            yield out
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            with contextlib.suppress(Exception):
                close()
