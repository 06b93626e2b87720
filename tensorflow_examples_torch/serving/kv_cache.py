"""Slot-granular KV cache pool and variable-length decode attention.

The port of ``tensorflow_examples_tpu/serving/kv_cache.py``:

* :class:`KVCachePool` preallocates ``[layers, slots, heads, max_len,
  head_dim]`` K and V once and hands out slots, one per in-flight
  request, with host-side alloc/free and per-slot populated lengths. Slot
  state is published as ``serving/kv_*`` gauges on every transition.
* :func:`varlen_decode_attention` is the per-slot generalization of
  ``ops/decode``'s scalar-length contract: each slot's query attends its
  own populated prefix; :func:`varlen_verify_attention` is its
  multi-token form for the speculative verify step. In the reference
  both are XLA, not Pallas kernels, so here they stay plain PyTorch.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from tensorflow_examples_torch.ops.attention import NEG_INF
from tensorflow_examples_torch.telemetry import registry as registry_mod


def bucket_ladder(floor: int, max_len: int) -> list[int]:
    """Power-of-two padding buckets ``floor, 2*floor, ...`` capped at (and
    always including) ``max_len``."""
    if floor < 1 or max_len < 1:
        raise ValueError(f"floor={floor} and max_len={max_len} must be >= 1")
    ladder: list[int] = []
    b = min(floor, max_len)
    while b < max_len:
        ladder.append(b)
        b *= 2
    ladder.append(max_len)
    return ladder


def pick_bucket(ladder: list[int], needed: int) -> int:
    """Smallest rung >= needed (ladder ascending; last rung = max)."""
    for b in ladder:
        if b >= needed:
            return b
    raise ValueError(f"needed={needed} exceeds the largest bucket {ladder[-1]}")


def gather_block_kv(blocks: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Per-slot contiguous cache views out of a paged block pool.

    blocks: [NB, H, BS, D], one layer's pool. block_tables: [S, nb] int,
    each slot's logical -> physical block map (entries past a slot's
    allocation point at the null block 0, which length masking never
    admits). Returns [S, H, nb*BS, D]."""
    s, nb = block_tables.shape
    _, h, bs, d = blocks.shape
    g = blocks[block_tables.long()]  # [S, nb, H, BS, D]
    return g.transpose(1, 2).reshape(s, h, nb * bs, d)


def varlen_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    sm_scale: float | None = None,
    block_tables: torch.Tensor | None = None,
) -> torch.Tensor:
    """Single-token attention over per-slot populated cache prefixes.

    q: [S, H, D], one new query per slot at position ``lengths[s] - 1``.
    k_cache / v_cache: [S, H, Kb, D], the cache sliced to the active KV
    bucket (rows >= a slot's length are garbage and masked), or with
    ``block_tables`` [S, nb] a paged pool [NB, H, BS, D] gathered first.
    Returns [S, H, D]: f32 scores and softmax, probabilities cast to the
    cache dtype, f32 accumulation, output in q's dtype."""
    if block_tables is not None:
        k_cache = gather_block_kv(k_cache, block_tables)
        v_cache = gather_block_kv(v_cache, block_tables)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("shd,shkd->shk", q.float(), k_cache.float()) * sm_scale
    col = torch.arange(s.shape[-1], device=q.device)
    s = torch.where(col[None, None, :] < lengths.to(q.device)[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    return torch.einsum("shk,shkd->shd", p.float(), v_cache.float()).to(q.dtype)


def varlen_verify_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    positions: torch.Tensor,
    *,
    sm_scale: float | None = None,
    block_tables: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-token :func:`varlen_decode_attention` for the speculative
    verify step.

    q: [S, T, H, D], T new queries a slot at positions ``positions[s] ..
    positions[s] + T - 1``, their K/V already written. Row t of slot s
    attends columns ``<= positions[s] + t`` (T=1 is
    ``varlen_decode_attention`` at ``lengths = positions + 1``). The
    caches are [S, H, Kb, D] bucket slices, or with ``block_tables`` a
    paged pool [NB, H, BS, D] gathered first. Returns [S, T, H, D] with
    the decode path's numerics, so a verify row samples what a decode
    step at that position would have."""
    if block_tables is not None:
        k_cache = gather_block_kv(k_cache, block_tables)
        v_cache = gather_block_kv(v_cache, block_tables)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("sthd,shkd->shtk", q.float(), k_cache.float()) * sm_scale
    col = torch.arange(s.shape[-1], device=q.device)
    row = torch.arange(s.shape[2], device=q.device)
    limit = positions.to(q.device)[:, None, None, None] + row[None, None, :, None]
    s = torch.where(col <= limit, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("shtk,shkd->shtd", p.float(), v_cache.float()).to(q.dtype)
    return out.transpose(1, 2)


class KVCachePool:
    """Preallocated per-request KV slots with host-side bookkeeping.

    Device state: ``k``/``v`` [L, S, H, max_len, D], written in place by
    the engine's steps. Host state: a free-slot list and the per-slot
    populated lengths. Thread-safe: the batcher loop allocates and frees
    while frontend threads read occupancy."""

    def __init__(self, *, num_layers: int, num_slots: int, num_heads: int,
                 max_len: int, head_dim: int, dtype=torch.float32,
                 device: torch.device | str = "cpu", registry=None):
        if num_slots < 1:
            raise ValueError(f"num_slots={num_slots} must be >= 1")
        self.num_layers = num_layers
        self.num_slots = num_slots
        self.num_heads = num_heads
        self.max_len = max_len
        self.head_dim = head_dim
        self.dtype = dtype
        self.device = torch.device(device)
        self._registry = registry
        self._alloc_arrays()
        self.lengths = np.zeros((num_slots,), np.int32)
        self._free = list(range(num_slots - 1, -1, -1))  # pop() -> slot 0 first
        self._lock = threading.Lock()
        self._publish()

    def _alloc_arrays(self) -> None:
        shape = (self.num_layers, self.num_slots, self.num_heads,
                 self.max_len, self.head_dim)
        self.k = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _reg(self):
        return self._registry if self._registry is not None else registry_mod.default_registry()

    def _publish(self) -> None:
        reg = self._reg()
        active = self.num_slots - len(self._free)
        # Dense pool: a claimed slot IS max_len of committed cache, so
        # slot and capacity occupancy are the same number.
        reg.gauge("serving/kv_occupancy").set(active / self.num_slots)
        reg.gauge("serving/kv_slot_occupancy").set(active / self.num_slots)
        reg.gauge("serving/kv_slots_active").set(active)
        reg.gauge("serving/kv_tokens").set(int(self.lengths.sum()))

    def alloc(self) -> int | None:
        """Claim a free slot (None when the pool is full)."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self.lengths[slot] = 0
            self._publish()
            return slot

    def free(self, slot: int) -> None:
        with self._lock:
            if slot in self._free:  # double-free is a caller bug
                raise ValueError(f"slot {slot} is already free")
            self.lengths[slot] = 0
            self._free.append(slot)
            self._publish()

    def reset(self) -> None:
        """Release every slot (the cache keeps whatever rows it holds:
        unpopulated rows are never read). Used after engine warmup."""
        with self._lock:
            self.lengths[:] = 0
            self._free = list(range(self.num_slots - 1, -1, -1))
            self._publish()

    def reallocate(self) -> None:
        """Fresh zeroed ``k``/``v`` after a failed engine step (the
        ``EngineStepError`` path): slot bookkeeping stays, since the
        batcher fails and frees the whole in-flight set right after."""
        self._alloc_arrays()

    def host_state(self) -> dict:
        """The host bookkeeping as plain values (slot lengths, the free
        list): equal on every rank of a sharded engine."""
        with self._lock:
            return {"lengths": self.lengths.tolist(), "free_slots": list(self._free)}

    def used_bytes(self) -> int:
        """K+V bytes committed to claimed slots (a slot is its max_len)."""
        per_slot = 2 * self.num_layers * self.num_heads * self.max_len * self.head_dim
        return self.active_slots * per_slot * self.k.element_size()

    @property
    def active_slots(self) -> int:
        with self._lock:
            return self.num_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.active_slots / self.num_slots
