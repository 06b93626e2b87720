"""Content chain keys for the prefix cache (the ``chain_key`` half of
``tensorflow_examples_tpu/serving/scheduler.py``; the KV-page wire format
and chunk planning are not ported yet)."""

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
