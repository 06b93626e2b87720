"""Block-paged KV cache pool with prefix reuse and int8 KV.

The port of ``tensorflow_examples_tpu/serving/paged_kv.py`` behind the
dense pool's slot interface:

* **Paged blocks**: device tensors ``[L, NB, H, BS, D]`` of ``NB``
  physical blocks of ``BS`` token rows; each slot holds a block table
  (logical block -> physical id), so committed cache scales with the
  tokens a request uses. Physical block 0 is the **null block**: pad
  entries point at it, parked decode slots write their discarded rows
  into it, and length masking never reads it into a real request.
* **Free-list allocator** with refcounts (prefix sharing lets one block
  back several slots). Exhaustion raises :class:`BlockExhausted` after
  evicting unreferenced prefix blocks, LRU first; every claim is
  all-or-nothing.
* **Prefix cache**: immutable full prompt blocks are published under the
  exact chained key ``(parent physical id, the block's token ids)``, so a
  hit can never serve another prompt's cache; each published block also
  carries its content chain digest (``scheduler.chain_key``). A later
  prompt with the same leading full blocks maps them (refcount++) and
  prefills only its tail. Cached blocks cover a block-aligned prefix
  strictly shorter than the prompt, and every write lands at or past the
  prompt length, so a shared block is never written again. The
  content chain keys are what the replica publishes on ``/health``
  (:meth:`PagedKVPool.prefix_digest`: shallowest first, capped at
  ``scheduler.DIGEST_MAX_KEYS``, with a bloom filter over all of them
  past the cap).
* **Page import** (:meth:`PagedKVPool.write_blocks`): a prefill replica's
  exported blocks land in this pool's own tensors in place, since the
  decode and verify rungs' CUDA graphs address those tensors.
* **int8 and fp8 KV** (``kv_dtype="int8"`` / ``"fp8"``): an int8 or
  ``float8_e4m3fn`` payload with per-row f32 scales stored blockwise
  ``[L, NB, H, BS]`` (``core/precision.quantize_rows``); one write and
  gather-dequant path serves both, the store dtype riding on the arrays.

Host bookkeeping sits under one lock: the batcher loop is the only
writer, frontend threads read occupancy.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict

import numpy as np
import torch

from tensorflow_examples_torch.core import precision
from tensorflow_examples_torch.serving import scheduler
from tensorflow_examples_torch.telemetry import registry as registry_mod

log = logging.getLogger(__name__)

NULL_BLOCK = 0  # physical block 0: pad/garbage target, never allocated


class BlockExhausted(RuntimeError):
    """The block free list is empty even after evicting unreferenced
    prefix blocks. At admission it rejects the request (503); mid-decode
    ``slots`` names the requests that could not grow."""

    def __init__(self, msg: str, *, slots: tuple[int, ...] = ()):
        super().__init__(msg)
        self.slots = tuple(slots)


class PagedKVPool:
    """Paged drop-in for ``kv_cache.KVCachePool`` (``alloc``/``free``/
    ``lengths``/``occupancy``/``active_slots``) with
    block-granular storage and ``block_tables`` [num_slots,
    max_len // BS] int32 on the host."""

    def __init__(self, *, num_layers: int, num_slots: int, num_heads: int,
                 max_len: int, head_dim: int, block_size: int = 16,
                 num_blocks: int = 0, dtype=torch.float32, kv_dtype: str = "",
                 prefix_cache: bool = True, device: torch.device | str = "cpu",
                 registry=None):
        if num_slots < 1:
            raise ValueError(f"num_slots={num_slots} must be >= 1")
        if block_size < 1 or block_size & (block_size - 1):
            raise ValueError(f"block_size={block_size} must be a power of two")
        if max_len % block_size:
            raise ValueError(f"block_size={block_size} must divide max_len={max_len}")
        if kv_dtype not in ("", "int8", "fp8"):
            raise ValueError(f"kv_dtype={kv_dtype!r} not in ('', 'int8', 'fp8')")
        if kv_dtype == "fp8" and not precision.fp8_supported():
            raise ValueError("kv_dtype='fp8' requested but this torch build has no working "
                             "float8_e4m3fn; use kv_dtype='int8'")
        self.num_layers = num_layers
        self.num_slots = num_slots
        self.num_heads = num_heads
        self.max_len = max_len
        self.head_dim = head_dim
        self.block_size = block_size
        self.max_blocks_per_slot = max_len // block_size
        # Default capacity = the dense pool's worst case (+1 null block).
        self.num_blocks = (
            int(num_blocks) if num_blocks else num_slots * self.max_blocks_per_slot + 1
        )
        if self.num_blocks < 2:
            raise ValueError("num_blocks must leave at least one allocatable "
                             "block beyond the null block")
        self.dtype = dtype
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype in ("int8", "fp8")
        self.prefix_cache_enabled = bool(prefix_cache)
        self.device = torch.device(device)
        self._registry = registry
        self._alloc_arrays()
        self.lengths = np.zeros((num_slots,), np.int32)
        self.block_tables = np.full(
            (num_slots, self.max_blocks_per_slot), NULL_BLOCK, np.int32
        )
        self._slot_blocks = np.zeros((num_slots,), np.int32)
        self._free_slots = list(range(num_slots - 1, -1, -1))
        self._free_blocks = list(range(self.num_blocks - 1, 0, -1))
        self._refcount = np.zeros((self.num_blocks,), np.int32)
        # Prefix cache: (parent physical id | -1, token tuple) -> id, the
        # reverse map for eviction, each published block's content chain
        # digest, and the LRU set of published-but-unreferenced blocks.
        self._cache: dict[tuple, int] = {}
        self._cache_key: dict[int, tuple] = {}
        self._chain_hash: dict[int, str] = {}
        self._chain_depth: dict[int, int] = {}
        self._evictable: OrderedDict[int, None] = OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0
        # The digest's generation (bumped on every publish and eviction)
        # and the bloom filter built for it.
        self._digest_gen = 0
        self._bloom_cache: tuple | None = None
        self._lock = threading.Lock()
        self._publish_locked()

    # ------------------------------------------------------ device state

    def _alloc_arrays(self) -> None:
        shape = (self.num_layers, self.num_blocks, self.num_heads,
                 self.block_size, self.head_dim)
        store = precision.store_dtype(self.kv_dtype) if self.quantized else self.dtype
        self.k = torch.zeros(shape, dtype=store, device=self.device)
        self.v = torch.zeros(shape, dtype=store, device=self.device)
        if self.quantized:
            self.k_scale = torch.ones(shape[:-1], device=self.device)
            self.v_scale = torch.ones(shape[:-1], device=self.device)
        else:
            self.k_scale = self.v_scale = None

    def kv_state(self) -> tuple:
        """(k, v) or, quantized, (k, v, k_scale, v_scale): the tensors the
        engine's steps write in place."""
        if self.quantized:
            return (self.k, self.v, self.k_scale, self.v_scale)
        return (self.k, self.v)

    def reallocate(self) -> None:
        """Fresh zeroed device arrays after a failed engine step (the
        ``EngineStepError`` path). Every cached prefix lived in the old
        arrays, so the prefix cache is dropped; slot bookkeeping stays,
        since the batcher fails and frees the whole in-flight set."""
        self._alloc_arrays()
        with self._lock:
            self._drop_cache_locked()
            self._publish_locked()

    def host_state(self) -> dict:
        """The host bookkeeping as plain values: slot lengths and block
        tables, the free lists, refcounts and the prefix cache's keys,
        chain hashes and LRU order. The ranks of a sharded engine replay
        the same calls, so theirs are equal."""
        with self._lock:
            return {"lengths": self.lengths.tolist(),
                    "block_tables": self.block_tables.tolist(),
                    "slot_blocks": self._slot_blocks.tolist(),
                    "free_slots": list(self._free_slots),
                    "free_blocks": list(self._free_blocks),
                    "refcount": self._refcount.tolist(),
                    "prefix_cache": sorted(self._cache.items()),
                    "chain_hash": sorted(self._chain_hash.items()),
                    "evictable": list(self._evictable)}

    def _drop_cache_locked(self) -> None:
        for bid in list(self._evictable):
            self._free_blocks.append(bid)
        self._evictable.clear()
        self._cache.clear()
        self._cache_key.clear()
        self._chain_hash.clear()
        self._chain_depth.clear()
        self._digest_gen += 1
        self._bloom_cache = None

    # ------------------------------------------------------------- slots

    def _reg(self):
        return self._registry if self._registry is not None else registry_mod.default_registry()

    def _publish_locked(self) -> None:
        reg = self._reg()
        active = self.num_slots - len(self._free_slots)
        usable = self.num_blocks - 1
        used = int((self._refcount > 0).sum())
        reg.gauge("serving/kv_occupancy").set(used / usable)
        reg.gauge("serving/kv_slot_occupancy").set(active / self.num_slots)
        reg.gauge("serving/kv_slots_active").set(active)
        reg.gauge("serving/kv_blocks_used").set(used)
        reg.gauge("serving/kv_blocks_total").set(usable)
        reg.gauge("serving/kv_tokens").set(int(self.lengths.sum()))
        reg.gauge("serving/prefix_cache_blocks").set(len(self._cache))

    def alloc(self) -> int | None:
        """Claim a free slot (None when every slot is taken); no blocks
        yet — the prefill claims exactly what the prompt needs."""
        with self._lock:
            if not self._free_slots:
                return None
            slot = self._free_slots.pop()
            self.lengths[slot] = 0
            self.block_tables[slot, :] = NULL_BLOCK
            self._slot_blocks[slot] = 0
            self._publish_locked()
            return slot

    def free(self, slot: int) -> None:
        with self._lock:
            if slot in self._free_slots:  # double-free is a caller bug
                raise ValueError(f"slot {slot} is already free")
            for i in range(int(self._slot_blocks[slot])):
                self._release_block_locked(int(self.block_tables[slot, i]))
            self.block_tables[slot, :] = NULL_BLOCK
            self._slot_blocks[slot] = 0
            self.lengths[slot] = 0
            self._free_slots.append(slot)
            self._publish_locked()

    def reset(self) -> None:
        """Release every slot and every block."""
        with self._lock:
            self.lengths[:] = 0
            self.block_tables[:, :] = NULL_BLOCK
            self._slot_blocks[:] = 0
            self._free_slots = list(range(self.num_slots - 1, -1, -1))
            # Drop the cache first (it returns parked evictable blocks to
            # the free list), then rebuild the list wholesale; the other
            # order hands one physical block out twice.
            self._drop_cache_locked()
            self._free_blocks = list(range(self.num_blocks - 1, 0, -1))
            self._refcount[:] = 0
            self.prefix_hits = 0
            self.prefix_misses = 0
            self._publish_locked()

    @property
    def active_slots(self) -> int:
        with self._lock:
            return self.num_slots - len(self._free_slots)

    @property
    def occupancy(self) -> float:
        """Used-block fraction (slot occupancy is the separate
        ``serving/kv_slot_occupancy`` gauge)."""
        with self._lock:
            return float((self._refcount > 0).sum()) / (self.num_blocks - 1)

    # ------------------------------------------------------------ blocks

    def _alloc_block_locked(self) -> int:
        if self._free_blocks:
            return self._free_blocks.pop()
        if self._evictable:
            # Reclaim the least recently published unreferenced prefix
            # block: reuse is an optimization, never a reason to refuse.
            bid, _ = self._evictable.popitem(last=False)
            del self._cache[self._cache_key.pop(bid)]
            self._chain_hash.pop(bid, None)
            self._chain_depth.pop(bid, None)
            self._digest_gen += 1
            return bid
        self._reg().counter("serving/kv_exhausted_total").inc()
        log.warning("KV block pool exhausted (%d/%d blocks referenced) — shedding",
                    int((self._refcount > 0).sum()), self.num_blocks - 1)
        raise BlockExhausted(
            f"KV block pool exhausted: {self.num_blocks - 1} blocks "
            f"({self.block_size} tokens each) all referenced by active "
            "requests — admission must shed load"
        )

    def _release_block_locked(self, bid: int) -> None:
        if bid == NULL_BLOCK:
            return
        self._refcount[bid] -= 1
        if self._refcount[bid] > 0:
            return
        if bid in self._cache_key:
            self._evictable[bid] = None  # published: park, reclaimable
        else:
            self._free_blocks.append(bid)

    def _claim_locked(self, n: int) -> list[int]:
        got: list[int] = []
        try:
            for _ in range(n):
                got.append(self._alloc_block_locked())
        except BlockExhausted:
            self._free_blocks.extend(got)
            raise
        for bid in got:
            self._refcount[bid] = 1
        return got

    def alloc_blocks(self, n: int) -> list[int]:
        """Claim ``n`` fresh private blocks (refcount 1) or raise
        :class:`BlockExhausted` having claimed none."""
        with self._lock:
            got = self._claim_locked(n)
            self._publish_locked()
            return got

    def assign(self, slot: int, blocks: list[int]) -> None:
        """Install a slot's block table (refcounts already taken)."""
        with self._lock:
            if len(blocks) > self.max_blocks_per_slot:
                raise ValueError(f"{len(blocks)} blocks exceed the per-slot "
                                 f"table ({self.max_blocks_per_slot})")
            self.block_tables[slot, :] = NULL_BLOCK
            self.block_tables[slot, :len(blocks)] = blocks
            self._slot_blocks[slot] = len(blocks)
            self._publish_locked()

    def ensure_position(self, slot: int, position: int) -> None:
        """Grow the slot's table to cover ``position``, all-or-nothing."""
        need = position // self.block_size + 1
        with self._lock:
            have = int(self._slot_blocks[slot])
            if need <= have:
                return
            if need > self.max_blocks_per_slot:
                raise ValueError(f"position {position} exceeds max_len {self.max_len}")
            for i, bid in enumerate(self._claim_locked(need - have)):
                self.block_tables[slot, have + i] = bid
            self._slot_blocks[slot] = need
            self._publish_locked()

    def covered_positions(self, slot: int) -> int:
        """Token rows the slot's allocated blocks hold: the cap on verify
        rows that may commit when a speculative window could not be fully
        backed (rows past it land in the null block)."""
        with self._lock:
            return int(self._slot_blocks[slot]) * self.block_size

    # ------------------------------------------------------ prefix cache

    def prefix_lookup(self, prompt) -> tuple[list[int], int]:
        """Longest reusable cached prefix of ``prompt``: (physical block
        ids with refcounts taken, covered token count). Capped strictly
        below ``len(prompt)`` so at least one tail token prefills."""
        if not self.prefix_cache_enabled:
            return [], 0
        bs = self.block_size
        with self._lock:
            blocks: list[int] = []
            parent = -1
            for i in range((len(prompt) - 1) // bs):
                bid = self._cache.get((parent, tuple(int(t) for t in prompt[i * bs:(i + 1) * bs])))
                if bid is None:
                    break
                blocks.append(bid)
                parent = bid
            if blocks:
                for bid in blocks:
                    if self._refcount[bid] == 0:
                        self._evictable.pop(bid, None)
                    self._refcount[bid] += 1
                self.prefix_hits += 1
                self._reg().counter("serving/prefix_hits").inc()
            else:
                self.prefix_misses += 1
                self._reg().counter("serving/prefix_misses").inc()
            self._publish_locked()
            return blocks, len(blocks) * bs

    def release_prefix(self, blocks: list[int]) -> None:
        """Undo a ``prefix_lookup``'s refcounts."""
        with self._lock:
            for bid in blocks:
                self._release_block_locked(bid)
            self._publish_locked()

    def claim_prompt_blocks(self, slot: int, prompt) -> tuple[int, list[int]]:
        """Install ``slot``'s whole prompt table — longest cached prefix
        first, fresh private blocks for the rest — all-or-nothing.
        Returns ``(ctx, fresh)``: cached token count and fresh block ids."""
        total = -(-len(prompt) // self.block_size)
        reused, ctx = self.prefix_lookup(prompt)
        try:
            fresh = self.alloc_blocks(total - len(reused))
        except BlockExhausted:
            self.release_prefix(reused)
            raise
        self.assign(slot, reused + fresh)
        return ctx, fresh

    def insert_prefix(self, slot: int, prompt) -> None:
        """Publish the slot's full prompt blocks for reuse (idempotent per
        chain link; a block already published under another id is left
        alone — first writer wins)."""
        if not self.prefix_cache_enabled:
            return
        bs = self.block_size
        with self._lock:
            parent, parent_hash = -1, ""
            for i in range(len(prompt) // bs):
                block = tuple(int(t) for t in prompt[i * bs:(i + 1) * bs])
                key = (parent, block)
                parent_hash = scheduler.chain_key(parent_hash, block)
                existing = self._cache.get(key)
                if existing is not None:
                    parent = existing
                    continue
                bid = int(self.block_tables[slot, i])
                if bid == NULL_BLOCK:
                    break
                self._cache[key] = bid
                self._cache_key[bid] = key
                self._chain_hash[bid] = parent_hash
                self._chain_depth[bid] = i + 1
                self._digest_gen += 1
                parent = bid
            self._publish_locked()

    def _chains_locked(self) -> int:
        """Distinct chain heads: published root blocks (parent -1)."""
        return sum(1 for key in self._cache if key[0] == -1)

    def prefix_digest(self, max_keys: int = scheduler.DIGEST_MAX_KEYS) -> dict:
        """The replica's published prefix summary: the content chain keys
        of every cached block, shallowest first and capped at
        ``max_keys``; ``blocks`` (published blocks), ``chains`` (distinct
        chain heads) and ``truncated`` (the cap bit). Past the cap it also
        carries ``bloom``, a filter over the whole key set, built outside
        the lock and cached for the digest's generation."""
        with self._lock:
            items = sorted(self._chain_hash.items(),
                           key=lambda kv: (self._chain_depth[kv[0]], kv[1]))
            truncated = len(items) > max_keys
            out = {"keys": [h for _, h in items[:max_keys]], "blocks": len(self._cache),
                   "chains": self._chains_locked(), "truncated": truncated}
            gen, cached = self._digest_gen, self._bloom_cache
        if truncated:
            if cached is not None and cached[0] == gen:
                out["bloom"] = cached[1]
            else:
                bloom = scheduler.encode_bloom(h for _, h in items)
                with self._lock:
                    if self._digest_gen == gen:  # still current
                        self._bloom_cache = (gen, bloom)
                out["bloom"] = bloom
        return out

    # ------------------------------------------------------- page import

    def write_blocks(self, block_ids: list[int], arrays: dict) -> None:
        """Write imported pages into physical blocks ``block_ids``:
        ``arrays`` maps ``k``/``v`` (and, quantized, ``k_scale``/
        ``v_scale``) to tensors ``[L, len(block_ids), ...]`` of the pool's
        own dtypes. ``index_copy_`` writes the pool's tensors in place
        (through their bytes, so fp8 payloads copy bit for bit): the
        decode and verify rungs' CUDA graphs address these tensors, and a
        rebinding would leave every graph reading the old pool."""
        idx = torch.as_tensor(block_ids, dtype=torch.long, device=self.device)
        targets = {"k": self.k, "v": self.v}
        if self.quantized:
            targets.update(k_scale=self.k_scale, v_scale=self.v_scale)
        for name, dst in targets.items():
            src = arrays[name]
            if dst.element_size() == 1 and dst.dtype != torch.int8:
                dst, src = dst.view(torch.uint8), src.view(torch.uint8)
            dst.index_copy_(1, idx, src.to(self.device))

    # -------------------------------------------------- byte accounting

    @property
    def kv_bits(self) -> int:
        return 8 if self.quantized else torch.tensor([], dtype=self.dtype).element_size() * 8

    def bytes_per_block(self) -> int:
        """K+V device bytes one physical block commits (the one-byte
        payload plus its f32 row scales when quantized)."""
        row = self.num_heads * self.head_dim
        if self.quantized:
            per = self.block_size * row + self.block_size * self.num_heads * 4
        else:
            per = self.block_size * row * self.kv_bits // 8
        return int(2 * self.num_layers * per)

    def used_bytes(self) -> int:
        with self._lock:
            return int((self._refcount > 0).sum()) * self.bytes_per_block()

    def paged_stats(self) -> dict:
        with self._lock:
            used = int((self._refcount > 0).sum())
            hits, misses = self.prefix_hits, self.prefix_misses
            published = len(self._cache)
            chains = self._chains_locked()
            active = self.num_slots - len(self._free_slots)
        usable = self.num_blocks - 1
        looked = hits + misses
        return {
            "block_size": self.block_size,
            "blocks_total": usable,
            "blocks_used": used,
            "kv_block_occupancy": used / usable,
            "kv_slot_occupancy": active / self.num_slots,
            "prefix_hits": hits,
            "prefix_misses": misses,
            "prefix_hit_rate": (hits / looked) if looked else 0.0,
            "kv_bits": self.kv_bits,
            "prefix_blocks": published,
            "prefix_chains": chains,
            # 1 when the /health digest is capped below the cached chain
            # set: affinity misses on the shed tails are expected.
            "digest_truncated": int(published > scheduler.DIGEST_MAX_KEYS),
        }
