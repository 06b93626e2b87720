"""Content chain keys for the prefix cache and chunk planning for chunked
prefill (``chain_key`` and ``plan_chunks`` of
``tensorflow_examples_tpu/serving/scheduler.py``; the KV-page wire format
belongs to the fleet hand-off and is not ported yet)."""

from __future__ import annotations

import hashlib

import numpy as np


def chain_key(parent: str, block_tokens) -> str:
    """Content chain digest of one full prefix block: a pure function of
    (parent chain digest, the block's token ids). ``parent`` is "" for
    the root block. 64-bit blake2b hex, byte-identical to the
    reference's, so replicas of either package agree on a prefix."""
    h = hashlib.blake2b(digest_size=8)
    h.update(parent.encode("ascii"))
    h.update(np.asarray(block_tokens, np.int64).tobytes())
    return h.hexdigest()


def plan_chunks(n: int, ctx: int, chunk_tokens: int, block_size: int) -> list[tuple[int, int]]:
    """Split the cold tail ``[ctx, n)`` of an ``n``-token prompt into
    ``(start, end)`` spans of at most ``chunk_tokens`` each. Every span
    starts on a block boundary (the extend step writes whole blocks); only
    the last span's end may be ragged."""
    if chunk_tokens < 1 or chunk_tokens % block_size:
        raise ValueError(f"chunk_tokens={chunk_tokens} must be a positive multiple "
                         f"of block_size={block_size}")
    if ctx % block_size:
        raise ValueError(f"ctx={ctx} is not block-aligned")
    if not ctx <= n:
        raise ValueError(f"ctx={ctx} exceeds prompt length {n}")
    spans = []
    start = ctx
    while start < n:
        end = min(start + chunk_tokens, n)
        spans.append((start, end))
        start = end
    return spans
