"""Cache-aware fleet scheduling primitives: the port of
``tensorflow_examples_tpu/serving/scheduler.py``.

* **Prefix chain keys**: :func:`chain_key` digests one full prompt block
  from its parent's digest and its token ids, so the key of block *i* is
  a pure function of the first ``(i+1) * block_size`` prompt tokens: two
  replicas (of either package) that cached the same prefix publish the
  same keys, and a router measures how much of a prompt a replica holds
  from its ``/health`` digest (:func:`affinity_blocks`). Past
  ``DIGEST_MAX_KEYS`` a replica also publishes a bloom filter over all
  of its keys (:func:`encode_bloom` / :func:`decode_bloom`).
* **Chunk planning**: :func:`plan_chunks` splits a cold prompt tail into
  block-aligned spans for chunked prefill.
* **KV page wire format**: :func:`encode_pages` / :func:`decode_pages`
  serialize a finished prompt's KV blocks (quantization scales ride
  along) as the JSON object a prefill-role replica returns from
  ``POST /prefill`` and a decode-role replica imports at ``POST /resume``.
  The payload is the reference's byte for byte: each array's ``dtype``
  is the JAX array's numpy dtype string (``float32``, ``bfloat16``,
  ``int8``, ``float8_e4m3fn``), its ``data`` the base64 of its raw
  bytes. The arrays here are torch tensors, written through their bytes
  and read back through a dtype-string map, so no numpy extension dtype
  (``bfloat16``, ``float8_e4m3fn``) is needed.

Stdlib, numpy and torch on the host: no device, no sockets, no locks.
"""

from __future__ import annotations

import base64
import hashlib

import numpy as np
import torch

ROLES = ("mixed", "prefill", "decode")

# Wire-format version of the KV page payload; decode_pages refuses others.
PAGE_WIRE_VERSION = 1

# Cap on the chain keys a replica publishes in its /health digest,
# shallowest first (shared system prompts are the shallowest links).
DIGEST_MAX_KEYS = 512


# ---------------------------------------------------------- chain keys


def chain_key(parent: str, block_tokens) -> str:
    """Content chain digest of one full prefix block: a pure function of
    (parent chain digest, the block's token ids). ``parent`` is "" for
    the root block. 64-bit blake2b hex, byte-identical to the
    reference's, so replicas of either package agree on a prefix."""
    h = hashlib.blake2b(digest_size=8)
    h.update(parent.encode("ascii"))
    h.update(np.asarray(block_tokens, np.int64).tobytes())
    return h.hexdigest()


def prompt_chain_keys(prompt, block_size: int) -> list[str]:
    """The chain keys of every reusable full block of ``prompt``, capped
    at ``(len - 1) // block_size`` like ``paged_kv.prefix_lookup`` (at
    least one tail token always prefills): key ``i`` in a replica's
    digest means it can serve blocks ``[0, i]`` from cache."""
    if block_size < 1:
        raise ValueError(f"block_size={block_size} must be >= 1")
    keys: list[str] = []
    parent = ""
    for i in range((len(prompt) - 1) // block_size):
        parent = chain_key(parent, prompt[i * block_size:(i + 1) * block_size])
        keys.append(parent)
    return keys


def affinity_blocks(chain_keys: list[str], digest) -> int:
    """How many leading blocks of a prompt (its :func:`prompt_chain_keys`)
    a replica's published ``digest`` holds: anything supporting ``in``
    (a frozenset of keys, or a :class:`BloomDigest`). The walk stops at
    the first miss: cached blocks map only as a chain from the root."""
    n = 0
    for key in chain_keys:
        if key not in digest:
            break
        n += 1
    return n


# ------------------------------------------------------- bloom digest
#
# Past DIGEST_MAX_KEYS a replica publishes a bloom filter over its whole
# chain-key set (about 1.25 KiB per 1k keys). False positives only
# overstate affinity (a load-guarded preference; a wrong delta skip is
# refused by the importer), and there are no false negatives.

BLOOM_BITS_PER_KEY = 10   # ~1% false-positive rate at 7 hashes
BLOOM_HASHES = 7
BLOOM_MIN_BITS = 64
BLOOM_MAX_BITS = 1 << 20  # 128 KiB cap on the /health payload


def _bloom_indices(key: str, m: int, k: int) -> list[int]:
    """Double hashing from one blake2b digest: k bit indices in [0, m)."""
    h = hashlib.blake2b(key.encode("ascii"), digest_size=16).digest()
    a = int.from_bytes(h[:8], "big")
    b = int.from_bytes(h[8:], "big") | 1  # odd: never collapses
    return [(a + i * b) % m for i in range(k)]


def encode_bloom(keys) -> dict:
    """Bloom filter over chain keys as a JSON-safe /health payload
    ``{m, k, n, bits}``, the bit array base64'd."""
    keys = list(keys)
    m = min(BLOOM_MAX_BITS, max(BLOOM_MIN_BITS, len(keys) * BLOOM_BITS_PER_KEY))
    m = (m + 7) // 8 * 8  # whole bytes
    bits = bytearray(m // 8)
    for key in keys:
        for idx in _bloom_indices(key, m, BLOOM_HASHES):
            bits[idx // 8] |= 1 << (idx % 8)
    return {"m": m, "k": BLOOM_HASHES, "n": len(keys),
            "bits": base64.b64encode(bytes(bits)).decode("ascii")}


class BloomDigest:
    """Read side of :func:`encode_bloom`: ``key in digest`` and ``len()``
    (the published key count, so an empty filter is falsy)."""

    __slots__ = ("m", "k", "n", "_bits")

    def __init__(self, m: int, k: int, n: int, bits: bytes):
        self.m = m
        self.k = k
        self.n = n
        self._bits = bits

    def __contains__(self, key) -> bool:
        if not isinstance(key, str) or self.n == 0:
            return False
        return all(self._bits[idx // 8] & (1 << (idx % 8))
                   for idx in _bloom_indices(key, self.m, self.k))

    def __len__(self) -> int:
        return self.n

    def __repr__(self):
        return f"BloomDigest(m={self.m}, k={self.k}, n={self.n})"


def decode_bloom(payload) -> BloomDigest:
    """Parse a published bloom payload; every malformation raises
    ``ValueError``."""
    if not isinstance(payload, dict):
        raise ValueError("bloom digest must be a JSON object")
    try:
        m, k, n = int(payload["m"]), int(payload["k"]), int(payload["n"])
        bits = base64.b64decode(payload["bits"], validate=True)
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed bloom digest: {e}") from None
    if m < 8 or m % 8 or m > BLOOM_MAX_BITS:
        raise ValueError(f"bloom m={m} out of range")
    if not 1 <= k <= 32 or n < 0:
        raise ValueError(f"bloom k={k}/n={n} out of range")
    if len(bits) != m // 8:
        raise ValueError(f"bloom bits: {len(bits)} bytes does not match m={m}")
    return BloomDigest(m, k, n, bits)


# ------------------------------------------------------- chunk planning


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


# ----------------------------------------------------- KV page payload

_PAGE_META = ("block_size", "num_layers", "num_heads", "head_dim", "length", "kv_bits")

# The wire's dtype strings (numpy's names, as the reference writes them)
# and the torch dtype each one reads back as.
WIRE_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "int32": torch.int32,
}
if hasattr(torch, "float8_e4m3fn"):
    WIRE_DTYPES["float8_e4m3fn"] = torch.float8_e4m3fn
_WIRE_NAMES = {dt: name for name, dt in WIRE_DTYPES.items()}


def wire_dtype(dtype: torch.dtype) -> str:
    """The wire string of a torch dtype (numpy's name for it)."""
    try:
        return _WIRE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"no KV page wire dtype for {dtype}") from None


def _raw_bytes(t: torch.Tensor) -> bytes:
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return flat.to("cpu").numpy().tobytes()


def encode_pages(meta: dict, arrays: dict) -> dict:
    """Serialize a slot's finished KV blocks for the prefill->decode
    hand-off. ``arrays`` maps name -> torch tensor (``k``/``v`` always,
    ``k_scale``/``v_scale`` when quantized); geometry rides in ``meta``
    so the importer validates before touching its pool.

    ``meta["start_block"]`` (optional, default 0) is the delta hand-off:
    the arrays cover only blocks ``[start_block, ceil(length /
    block_size))``, the leading blocks being ones the importer already
    caches (it checks that its prefix cache covers them)."""
    missing = [k for k in _PAGE_META if k not in meta]
    if missing:
        raise ValueError(f"page meta missing {missing}")
    payload = {"version": PAGE_WIRE_VERSION, **{k: int(meta[k]) for k in _PAGE_META}}
    start = int(meta.get("start_block", 0))
    if start < 0:
        raise ValueError(f"start_block={start} must be >= 0")
    if start:
        payload["start_block"] = start
    payload["arrays"] = {
        name: {"dtype": wire_dtype(arr.dtype), "shape": list(arr.shape),
               "data": base64.b64encode(_raw_bytes(arr)).decode("ascii")}
        for name, arr in arrays.items()
    }
    return payload


def decode_pages(payload) -> tuple[dict, dict]:
    """Inverse of :func:`encode_pages`: ``(meta, arrays)``, the arrays as
    CPU torch tensors. Every malformation (wrong version, missing
    geometry, torn base64, a shape/bytes mismatch) raises ``ValueError``
    with the reference's client-facing message (the frontend answers
    400)."""
    if not isinstance(payload, dict):
        raise ValueError("pages payload must be a JSON object")
    if payload.get("version") != PAGE_WIRE_VERSION:
        raise ValueError(f"unsupported pages wire version {payload.get('version')!r} "
                         f"(this replica speaks {PAGE_WIRE_VERSION})")
    meta = {}
    for key in _PAGE_META:
        v = payload.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(f"pages meta {key!r} = {v!r} is not a positive int")
        meta[key] = v
    if "start_block" in payload:
        start = payload["start_block"]
        if not isinstance(start, int) or isinstance(start, bool) or start < 0:
            raise ValueError(f"pages meta 'start_block' = {start!r} is not a non-negative int")
        if start * meta["block_size"] >= meta["length"]:
            raise ValueError(f"pages start_block={start} skips the whole "
                             f"{meta['length']}-token prompt")
        meta["start_block"] = start
    raw = payload.get("arrays")
    if not isinstance(raw, dict) or "k" not in raw or "v" not in raw:
        raise ValueError("pages payload is missing the k/v arrays")
    arrays = {}
    for name, spec in raw.items():
        if not isinstance(spec, dict):
            raise ValueError(f"pages array {name!r} is not an object")
        try:
            dtype_name = spec["dtype"]
            if dtype_name not in WIRE_DTYPES:
                raise TypeError(f"data type {dtype_name!r} not understood")
            dtype = WIRE_DTYPES[dtype_name]
            shape = tuple(int(d) for d in spec["shape"])
            data = base64.b64decode(spec["data"], validate=True)
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed pages array {name!r}: {e}") from None
        itemsize = torch.empty((), dtype=dtype).element_size()
        expect = itemsize * int(np.prod(shape, dtype=np.int64))
        if len(data) != expect:
            raise ValueError(f"pages array {name!r}: {len(data)} bytes does not "
                             f"match shape {shape} of {dtype_name}")
        flat = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data else \
            torch.empty((0,), dtype=torch.uint8)
        arrays[name] = flat.view(dtype).reshape(shape)
    return meta, arrays
