"""Device and host memory accounting: the port of
``tensorflow_examples_tpu/telemetry/memory.py``.

* ``MemoryMonitor.init_breakdown(state)``: at fit start (after the
  restore) the live bytes and their attribution to params, optimizer
  state, non-trainable model state and the rest, as the
  ``kind="memory"`` line.
* ``MemoryMonitor.sample()``: a live-byte poll at every log window; it
  keeps the run's peak watermark (the ``memory/peak_live_bytes`` gauge)
  and the ``"memory"`` fields of every window and final line.
* ``oom_report()``: who held the memory, logged before an OOM re-raises
  (``train/loop.py`` calls ``maybe_log_oom_report`` as ``fit`` unwinds):
  the largest live tensors, the fit-start breakdown and the allocator's
  statistics.

The reference reads ``jax.live_arrays()``. Here live bytes on a CUDA
device are the caching allocator's allocated bytes
(``torch.cuda.memory_allocated``: every live tensor of the process on
that card), and the peak is the allocator's high-water mark, which
holds the activations inside a step that no poll between steps sees.
On the CPU, where no allocator counts, live bytes are ``tree_bytes`` of
what the owner registers in ``tracked`` (the trainer's state and its
current batch), which gives the nonzero watermark the CPU tests read.
The allocator's statistics (``device_memory_stats``) exist on the card
only.
"""

from __future__ import annotations

import gc
import logging
import re
from typing import Any, Callable

import numpy as np
import torch

from tensorflow_examples_torch.telemetry import registry as registry_mod

log = logging.getLogger(__name__)

# The reference's patterns of an out-of-memory failure, matched without
# case against the exception's type and text ("oom" as a word), plus
# PyTorch's OutOfMemoryError.
_OOM_PATTERNS = (
    "resource_exhausted",
    "out of memory",
    r"\boom\b",
    "memory_limit",
    "allocation failure",
    "outofmemoryerror",
)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _leaves(getattr(tree, name))
    elif tree is not None:
        yield tree


def tree_bytes(tree: Any, *, per_device: bool = False, pieces: Any = None) -> int:
    """Total bytes of the tensors and arrays of a nested structure (dicts,
    lists, tuples, dataclasses such as ``TrainState``). On a mesh a leaf
    is this rank's piece of a tensor cut into ``pieces`` (a tree of ints
    of ``tree``'s structure, ``sharding/layout.StateLayout.pieces``; None:
    every leaf whole): ``per_device=True`` counts the pieces this rank
    holds, ``False`` the whole tensors' bytes, as the reference's."""
    counts = [1] * len(list(_leaves(tree))) if pieces is None or per_device else list(
        _leaves(pieces))
    total = 0
    for leaf, n in zip(_leaves(tree), counts):
        if torch.is_tensor(leaf):
            total += leaf.numel() * leaf.element_size() * n
        elif isinstance(leaf, np.ndarray):
            total += int(leaf.nbytes) * n
    return total


def live_array_bytes(device: torch.device | None = None,
                     tracked: Callable[[], Any] | None = None) -> int:
    """Live tensor bytes: the allocator's count on a CUDA ``device``;
    elsewhere ``tree_bytes`` of ``tracked()`` (0 without it)."""
    if device is not None and device.type == "cuda":
        return int(torch.cuda.memory_allocated(device))
    return tree_bytes(tracked()) if tracked is not None else 0


def device_memory_stats(device: torch.device | None = None) -> dict[str, int] | None:
    """The caching allocator's statistics for a CUDA ``device`` (None
    elsewhere): ``bytes_in_use`` and ``peak_bytes_in_use`` (tensor
    bytes), ``bytes_reserved`` and ``peak_bytes_reserved`` (what the
    allocator holds from the CUDA runtime), ``bytes_limit`` (the card's
    memory), and the counts of OOMs, allocation retries and allocations."""
    if device is None or device.type != "cuda":
        return None
    s = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
        "peak_bytes_reserved": int(s.get("reserved_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
        "num_ooms": int(s.get("num_ooms", 0)),
        "num_alloc_retries": int(s.get("num_alloc_retries", 0)),
        "num_allocs": int(s.get("allocation.all.allocated", 0)),
    }


def is_oom(exc: BaseException) -> bool:
    """Does this exception look like a device or host OOM?"""
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(re.search(pat, text) for pat in _OOM_PATTERNS)


def _live_tensors(device: torch.device | None) -> list[torch.Tensor]:
    """Every live tensor on ``device``'s kind the garbage collector can
    reach, one per storage (views share it), largest first."""
    kind = device.type if device is not None else "cpu"
    seen, out = set(), []
    for obj in gc.get_objects():
        try:
            if not torch.is_tensor(obj) or obj.device.type != kind:
                continue
            storage = obj.untyped_storage()
            key = (storage.data_ptr(), storage.nbytes())
        except Exception:  # noqa: BLE001 - sparse, meta and other exotic tensors
            continue
        if key not in seen:
            seen.add(key)
            out.append(obj)
    return sorted(out, key=lambda t: -t.untyped_storage().nbytes())


class MemoryMonitor:
    """Per-fit memory bookkeeping: the breakdown at init, the watermark
    every window, the report on an OOM. ``device``: the fit's device;
    ``tracked``: a callable returning what the owner holds, counted as
    live bytes off the card."""

    def __init__(self, registry=None, *, device: torch.device | None = None,
                 tracked: Callable[[], Any] | None = None):
        self._registry = registry
        self.device = device
        self.tracked = tracked
        self._peak_live = 0
        self._last_live = 0
        self._last_device_stats: dict[str, int] | None = None
        self._breakdown: dict[str, int] = {}

    def _reg(self):
        return self._registry if self._registry is not None else registry_mod.default_registry()

    def sample(self) -> int:
        """Poll live bytes; update the last and peak gauges."""
        live = live_array_bytes(self.device, self.tracked)
        stats = device_memory_stats(self.device)
        self._last_live = live
        self._peak_live = max(self._peak_live, live,
                              stats["peak_bytes_in_use"] if stats else 0)
        self._last_device_stats = stats
        reg = self._reg()
        reg.gauge("memory/live_bytes").set(live)
        reg.gauge("memory/peak_live_bytes").set(self._peak_live)
        if stats:
            reg.gauge("memory/device_bytes_in_use").set(stats["bytes_in_use"])
            reg.gauge("memory/device_peak_bytes_in_use").set(stats["peak_bytes_in_use"])
        return live

    def init_breakdown(self, state) -> dict[str, int]:
        """Live bytes at fit start: params, optimizer state, model state
        and everything else."""
        sizes = (state.byte_breakdown() if hasattr(state, "byte_breakdown") else {
            "params": tree_bytes(getattr(state, "params", None)),
            "opt_state": tree_bytes(getattr(state, "opt_state", None)),
            "model_state": tree_bytes(getattr(state, "model_state", None)),
        })
        live = self.sample()
        accounted = sum(sizes.get(k, 0) for k in ("params", "opt_state", "model_state"))
        breakdown = {
            "params_bytes": sizes.get("params", 0),
            "opt_bytes": sizes.get("opt_state", 0),
            "model_state_bytes": sizes.get("model_state", 0),
            "other_bytes": max(live - accounted, 0),
            "live_bytes": live,
        }
        stats = self._last_device_stats
        if stats:
            breakdown["device_bytes_in_use"] = stats["bytes_in_use"]
            breakdown["device_bytes_limit"] = stats["bytes_limit"]
        self._breakdown = breakdown
        reg = self._reg()
        for key in ("params_bytes", "opt_bytes", "model_state_bytes"):
            reg.gauge(f"memory/{key}").set(breakdown[key])
        log.info("memory at fit start: %.1f MiB live (params %.1f, opt %.1f, model_state %.1f, "
                 "other %.1f)", live / 2**20, breakdown["params_bytes"] / 2**20,
                 breakdown["opt_bytes"] / 2**20, breakdown["model_state_bytes"] / 2**20,
                 breakdown["other_bytes"] / 2**20)
        return breakdown

    @property
    def peak_live_bytes(self) -> int:
        return self._peak_live

    def window_fields(self) -> dict[str, int]:
        """The ``"memory"`` object of a window or final line, from the
        last ``sample()`` only (the watchdog's fatal path calls this from
        its own thread)."""
        fields = {"live_bytes": self._last_live, "peak_live_bytes": self._peak_live}
        stats = self._last_device_stats
        if stats:
            fields["device_bytes_in_use"] = stats["bytes_in_use"]
            fields["device_peak_bytes_in_use"] = stats["peak_bytes_in_use"]
        return fields

    def oom_report(self, top: int = 15) -> str:
        """Who holds the memory, now: live tensors on the device by size,
        the fit-start breakdown and the allocator's statistics."""
        lines = ["== OOM allocation forensics =="]
        stats = device_memory_stats(self.device)
        if stats:  # the failed step's own high-water mark, which no window sampled
            self._peak_live = max(self._peak_live, stats["peak_bytes_in_use"])
        live = _live_tensors(self.device)
        total = sum(t.untyped_storage().nbytes() for t in live)
        lines.append(f"live arrays: {len(live)} holding {total / 2**20:,.1f} MiB "
                     f"(run peak watermark {self._peak_live / 2**20:,.1f} MiB)")
        if self._breakdown:
            b = self._breakdown
            lines.append("fit-start breakdown: params %.1f MiB / opt %.1f MiB / model_state "
                         "%.1f MiB / other %.1f MiB" % (
                             b.get("params_bytes", 0) / 2**20, b.get("opt_bytes", 0) / 2**20,
                             b.get("model_state_bytes", 0) / 2**20,
                             b.get("other_bytes", 0) / 2**20))
        if stats:
            lines.append("device allocator: "
                         + ", ".join(f"{k}={v:,}" for k, v in sorted(stats.items())))
        lines.append(f"top {min(top, len(live))} live arrays by size:")
        for t in live[:top]:
            lines.append(f"  {t.untyped_storage().nbytes() / 2**20:>10,.2f} MiB  "
                         f"{str(t.dtype):>14}  shape {tuple(t.shape)}")
        return "\n".join(lines)


def maybe_log_oom_report(exc: BaseException | None, monitor: "MemoryMonitor | None") -> bool:
    """The fit's teardown hook: log the report when ``exc`` is an OOM
    (the exception re-raises afterwards). Returns whether it logged."""
    if exc is None or monitor is None or not is_oom(exc):
        return False
    try:
        log.error("%s", monitor.oom_report())
    except Exception:  # pragma: no cover - dying anyway; best effort
        log.exception("OOM forensics report failed")
    return True
