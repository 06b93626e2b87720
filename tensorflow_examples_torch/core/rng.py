"""Counter-based random numbers, bit-compatible with ``jax.random``.

The port of the pieces of ``jax.random`` the JAX package's sampling and
training step use: the threefry2x32 hash, ``PRNGKey``, ``fold_in``,
``random_bits`` (in the *partitionable* counter layout, jax's default
since 0.5), ``uniform`` (mantissa-bit construction), ``gumbel``
(``mode="low"``) and ``categorical`` as ``argmax(gumbel + logits)``. A
key is a numpy ``uint32[2]``; integer arithmetic runs in numpy, whose
``uint32`` wraps exactly like the hash needs.

Keys, bits and uniforms equal jax's bit for bit. Gumbel noise applies
two float32 ``log``s, and XLA's CPU ``log`` is not correctly rounded
while torch's is: about a fifth of gumbel values differ from jax's by
one ulp. A categorical draw therefore differs from jax's only where two
candidates are within an ulp of each other.

``split`` is ``jax.random.split`` in the partitionable layout: key ``i``
of ``n`` is the hash of the counter (0, i), so it equals
``fold_in(key, i)``. ``step_rng(root, step)`` is ``core/rng.py`` of the
JAX package: the key of training step ``step`` under root key ``root``.
``fold_in_static(key, parts)`` is flax's ``_fold_in_static``: the key a
flax module at scope path ``parts[:-1]`` gets from its ``parts[-1]``-th
``make_rng`` call (the MoE router's jitter key).

:class:`StepNoise` is the one source of a training step's random input,
staged from the step key before the step runs (``stage(key)``): dropout
uniforms at a numbered site from that site's ``torch.Generator``,
reseeded to ``fold_in(key, site)`` (``site_seed``) at offset 0, and the
MoE router jitter of block ``i`` (numpy threefry of flax's key for it,
jax's bits) copied from pinned host memory into a device buffer that
stays put. A step's noise is thus a pure function of (seed, step). The
generators and buffers live across steps, so the same object serves an
eager step and the steps of a CUDA graph (``train/graphs.py``): the
graph registers the generators and reads the buffers, and a ``stage``
before each replay sets them for the replayed steps.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_F32_TINY = np.finfo(np.float32).tiny


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block cipher (20 rounds) of counter words
    ``(x0, x1)`` under ``key`` = (k0, k1); returns the two output words,
    each shaped like ``x0``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 — jax's name
    """``jax.random.PRNGKey(seed)`` for a seed that fits int32 (jax's
    default, 32-bit mode): the key words are (0, seed mod 2**32)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit int32")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: hash the counter pair (0, data) under
    ``key``; ``data`` is taken mod 2**32 like jax's uint32 cast."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def fold_in_static(key: np.ndarray, parts) -> np.ndarray:
    """flax's ``_fold_in_static`` (with ``flax_fix_rng_separator`` off,
    flax's default): SHA-1 over the parts in order, a string as its UTF-8
    bytes and an int as its minimal big-endian bytes, then ``fold_in`` of
    the digest's first four bytes read big-endian. No parts: the key."""
    if not parts:
        return key
    digest = hashlib.sha1()
    for part in parts:
        if isinstance(part, str):
            digest.update(part.encode("utf-8"))
        elif isinstance(part, int):
            digest.update(part.to_bytes((part.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or string, got {part!r}")
    return fold_in(key, int.from_bytes(digest.digest()[:4], byteorder="big"))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``uint32[num, 2]``, key ``i`` the
    hash of the 64-bit counter ``i`` split into (hi, lo) words."""
    idx = np.arange(int(num), dtype=np.uint64)
    y0, y1 = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return np.stack([y0, y1], axis=1)


def step_rng(root_key: np.ndarray, step: int) -> np.ndarray:
    """Per-step key: ``fold_in(root_key, step)``."""
    return fold_in(root_key, step)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element in jax's partitionable layout: element
    ``i`` (row-major) hashes the 64-bit counter ``i`` split into
    (hi, lo) words, and its bits are the xor of the two output words."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (y0 ^ y1).reshape(shape)


def uniform(key: np.ndarray, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 uniforms on [minval, maxval): the top 23 random bits fill
    the mantissa of a float in [1, 2), minus 1, then scaled and clamped
    at ``minval`` as jax does. XLA fuses the scale-and-shift into one
    fused multiply-add (one rounding); it is computed in float64 here,
    where the product of two float32s is exact."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    floats = floats - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, scaled.astype(np.float32))


def gumbel(key: np.ndarray, shape) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with ``u`` uniform on
    [tiny, 1) (jax's ``mode="low"``), as a float32 CPU tensor."""
    u = torch.from_numpy(uniform(key, shape, minval=_F32_TINY, maxval=1.0))
    return -torch.log(-torch.log(u))


def categorical(key: np.ndarray, logits: torch.Tensor) -> int | torch.Tensor:
    """Draws from ``softmax(logits)`` over the last axis:
    ``argmax(gumbel + logits)`` with one Gumbel draw of ``logits``' whole
    shape (the Gumbel-max trick, as ``jax.random.categorical(key, logits,
    axis=-1)``). Computed on the CPU in float32; an int for a 1-D
    ``logits``, else an int64 tensor of its leading shape."""
    logits = logits.detach().float().cpu()
    draw = torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)
    return int(draw) if logits.dim() == 1 else draw


def site_seed(key: np.ndarray, site: int) -> int:
    """The generator seed of dropout site ``site`` under ``key``: the two
    words of ``fold_in(key, site)`` packed into one integer."""
    word = fold_in(key, site)
    return (int(word[0]) << 31) ^ int(word[1])


def router_key(key: np.ndarray, layer: int) -> np.ndarray:
    """The router jitter key of MoE block ``layer``: what flax's
    ``make_rng("dropout")`` gives the reference's ``h_<layer>/moe``."""
    return fold_in_static(key, (f"h_{layer}", "moe", 1))


class StepNoise:
    """A training step's random input (see the module docstring):
    ``stage(key)`` sets it for the step of ``key``;
    ``dropout_uniform(site, shape, device)`` draws site ``site``'s
    uniforms on [0, 1); ``router_jitter(layer, shape, lo, hi, device)``
    is block ``layer``'s jitter on [lo, hi) on the device. A site's
    generator and a block's buffer are made at their first draw."""

    def __init__(self, key: np.ndarray | None = None):
        self.key = None
        self._generators: dict[int, torch.Generator] = {}
        self._jitter: dict[int, tuple] = {}  # layer -> (device buffer, lo, hi)
        if key is not None:
            self.stage(key)

    @property
    def generators(self) -> list[torch.Generator]:
        return list(self._generators.values())

    def stage(self, key: np.ndarray) -> "StepNoise":
        """Reseed every generator and refill every jitter buffer for the
        step of ``key`` (the copies run on the current stream)."""
        self.key = key
        for site, gen in self._generators.items():
            gen.manual_seed(site_seed(key, site))
        for layer, (buf, lo, hi) in self._jitter.items():
            self._fill(layer, buf, lo, hi)
        return self

    def dropout_uniform(self, site: int, shape, device) -> torch.Tensor:
        gen = self._generators.get(site)
        if gen is None:
            gen = self._generators[site] = torch.Generator(device=device)
            gen.manual_seed(site_seed(self.key, site))
        return torch.rand(shape, generator=gen, device=device)

    def router_jitter(self, layer: int, shape, lo: float, hi: float, device) -> torch.Tensor:
        entry = self._jitter.get(layer)
        if entry is None:
            entry = self._jitter[layer] = (torch.empty(shape, device=device), lo, hi)
            self._fill(layer, *entry)
        return entry[0]

    def _fill(self, layer: int, buf: torch.Tensor, lo: float, hi: float) -> None:
        host = torch.from_numpy(uniform(router_key(self.key, layer), tuple(buf.shape), lo, hi))
        if buf.is_cuda:
            # A pinned block is reused only once its copy has run, so the
            # copy need not block the host.
            host = host.pin_memory()
        buf.copy_(host, non_blocking=True)
