"""Precision: the training policy, row quantization and the weight
quantization registry behind int8/fp8 serving.

The port of ``tensorflow_examples_tpu/core/precision.py``:

* :class:`PrecisionPolicy`: f32 master parameters, compute in f32
  (``f32``), bf16 (``bf16``, the GPT-2 default) or bf16 everything
  (``bf16_full``). :meth:`PrecisionPolicy.cast_compute` casts every
  floating tensor of a dict to the compute dtype with a differentiable
  ``.to``, so gradients arrive at the masters in f32, and the whole
  forward runs in that dtype, as flax's ``dtype`` promotion makes it in
  the reference. No ``torch.autocast``: it picks a dtype per op where
  flax applies one uniformly. LayerNorm statistics stay f32
  (``models/transformer._layer_norm``), as flax keeps them.
* ``quantize_int8_rows`` / ``dequantize_int8_rows``: each cache row (one
  token's K or V for one head) carries its own f32 scale, stored
  blockwise beside the int8 payload, so rows append one decode step at a
  time without requantizing the rest of the block. :func:`quantize_rows`
  adds fp8 (``torch.float8_e4m3fn``, rows scaled to +-448); its bytes
  equal the JAX package's.
* :class:`PrecisionConfig`: the serializable per-subtree dtype registry
  (``[(path-regex, dtype)]``, first match wins; the same JSON format as
  the reference's). :func:`quantize_tree` applies it at load time on the
  CPU, replacing each matched >= 2-D floating leaf with a
  :class:`QuantizedWeight` (int8/fp8 payload and per-row f32 scales);
  the serving forward reads every matmul weight through
  :func:`materialize` and every embedding table through
  :func:`take_rows`, which dequantize where the weight is consumed, so
  the card holds the weights at one byte an element. The dequant is plain
  PyTorch, as the reference's is XLA.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import json
import os
import re
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F


class Precision(str, enum.Enum):
    F32 = "f32"
    BF16 = "bf16"  # bf16 compute, f32 params ("mixed")
    BF16_FULL = "bf16_full"  # bf16 everything


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    param_dtype: torch.dtype
    compute_dtype: torch.dtype

    @classmethod
    def create(cls, precision: Precision | str) -> "PrecisionPolicy":
        precision = Precision(precision)
        if precision == Precision.F32:
            return cls(torch.float32, torch.float32)
        if precision == Precision.BF16:
            return cls(torch.float32, torch.bfloat16)
        return cls(torch.bfloat16, torch.bfloat16)

    def cast_compute(self, tree: Mapping) -> dict:
        """``{name: tensor}`` with every floating tensor in the compute
        dtype (differentiably); integer tensors pass through."""
        return {k: v.to(self.compute_dtype) if torch.is_floating_point(v) else v
                for k, v in tree.items()}

INT8_MAX = 127.0


def quantize_int8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [..., D]`` -> (int8 values ``[..., D]``, f32 scales ``[...]``).
    Symmetric absmax over the last axis; an all-zero row gets scale 1
    (dequantizes back to exact zeros). Rounds half to even, like
    ``jnp.round``."""
    x = x.float()
    amax = x.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / INT8_MAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale[..., None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_rows`; ``scale`` broadcasts over
    the last axis of ``q``. Dtype-generic on the payload side: an fp8
    ``q`` dequantizes through the same f32 multiply."""
    return (q.float() * scale[..., None].float()).to(dtype)


dequantize_rows = dequantize_int8_rows

# ------------------------------------------------------- fp8 + generic

FP8_MAX = 448.0  # largest finite float8_e4m3fn value: the fp8 twin of INT8_MAX

QUANT_DTYPES = ("int8", "fp8")
CAST_DTYPES = ("f32", "bf16")
_CASTS = {"f32": torch.float32, "bf16": torch.bfloat16}


def fp8_dtype():
    """``torch.float8_e4m3fn`` when this torch build has it, else None."""
    return getattr(torch, "float8_e4m3fn", None)


@functools.lru_cache(maxsize=1)
def fp8_supported() -> bool:
    """Whether fp8 storage round-trips on this build: the registry and
    the KV pool refuse fp8 loudly where it does not."""
    dt = fp8_dtype()
    if dt is None:
        return False
    try:
        return bool(torch.ones(2).to(dt).float()[0] == 1.0)
    except (RuntimeError, TypeError):
        return False


def store_dtype(name: str) -> torch.dtype:
    """The payload dtype of a quantized dtype name ("int8" or "fp8")."""
    if name == "int8":
        return torch.int8
    if name != "fp8":
        raise ValueError(f"quantized dtype {name!r} not in {QUANT_DTYPES}")
    if not fp8_supported():
        raise ValueError("dtype 'fp8' requested but this torch build has no working "
                         "float8_e4m3fn; use 'int8' here")
    return fp8_dtype()


def quantize_rows(x: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row quantization to ``dtype`` (``torch.int8`` or the fp8
    dtype): symmetric absmax over the last axis, f32 scales. The int8
    branch is :func:`quantize_int8_rows`; fp8 scales rows to the e4m3
    range and relies on the cast's round-to-nearest-even, as the
    reference does (the bytes equal the JAX package's)."""
    if dtype == torch.int8:
        return quantize_int8_rows(x)
    x = x.float()
    amax = x.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale[..., None]).to(dtype), scale


def quantize_rows_host(x, name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The load-time twin of :func:`quantize_rows` by dtype name, on the
    CPU: the quantized tree is built before any leaf reaches the card."""
    x = torch.as_tensor(np.asarray(x, np.float32))
    return quantize_rows(x, store_dtype(name))


# ---------------------------------------------------- quantized leaves


class QuantizedWeight:
    """One quantized parameter: payload ``q`` (int8 or fp8, the weight's
    own shape) and per-row f32 ``scale`` over the last axis
    (``scale.shape == q.shape[:-1]``). It dequantizes where a matmul
    consumes it (:func:`materialize`), never at rest."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    def to(self, device) -> "QuantizedWeight":
        return QuantizedWeight(self.q.to(device), self.scale.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize_rows(self.q, self.scale, dtype)

    def __repr__(self):
        return f"QuantizedWeight(shape={tuple(self.q.shape)}, store={self.q.dtype})"


def materialize(w, dtype=torch.float32):
    """The dequant-in-matmul access point: a :class:`QuantizedWeight`
    dequantizes here, a plain tensor passes through untouched."""
    if isinstance(w, QuantizedWeight):
        return w.dequantize(dtype)
    return w


def take_rows(w, idx: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Row gather for embedding tables: a quantized table gathers the
    payload rows and their scales and dequantizes only those; a plain
    table goes through ``F.embedding`` (whose backward is the embedding
    backward, not a general scatter-add)."""
    if isinstance(w, QuantizedWeight):
        return dequantize_rows(w.q[idx], w.scale[idx], dtype)
    return F.embedding(idx, w)


# ------------------------------------------------- the dtype registry

PRECISION_JSON_VERSION = 1  # the on-disk format version of a precision.json

_LEGAL_RULE_DTYPES = QUANT_DTYPES + CAST_DTYPES + ("",)

# weight_only(): the tensors matmuls consume, kernels and embedding
# tables. LayerNorm parameters and biases keep their dtype.
WEIGHT_PATTERNS = (r"/kernel$", r"(^|/)embedding$")


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Serializable per-subtree dtype registry, the reference's format:

    * ``rules``: ``[(path-regex, dtype)]``, first match wins; dtype in
      ``int8``/``fp8`` (per-row quantization of >= 2-D floating leaves),
      ``f32``/``bf16`` (a plain cast) or ``""`` (leave it alone).
    * ``default``: dtype of unmatched leaves (``""``: untouched).
    * ``kv_dtype``: the cache side, ``""``/``int8``/``fp8``.

    Paths are ``/``-joined param-tree paths (``h_0/attn/qkv/kernel``), so
    a ``precision.json`` either package writes loads in the other."""

    rules: tuple = ()
    default: str = ""
    kv_dtype: str = ""

    def __post_init__(self):
        for entry in self.rules:
            if not isinstance(entry, (list, tuple)) or len(entry) != 2:
                raise ValueError(f"precision rule {entry!r} must be (pattern, dtype)")
        for name in [d for _, d in self.rules] + [self.default]:
            if name not in _LEGAL_RULE_DTYPES:
                raise ValueError(f"precision dtype {name!r} not in {_LEGAL_RULE_DTYPES}")
        if self.kv_dtype not in ("",) + QUANT_DTYPES:
            raise ValueError(f"kv_dtype={self.kv_dtype!r} not in {('',) + QUANT_DTYPES}")
        object.__setattr__(self, "rules", tuple((str(p), str(d)) for p, d in self.rules))

    @classmethod
    def weight_only(cls, dtype: str, *, kv_dtype: str = "") -> "PrecisionConfig":
        """Quantize every matmul weight (kernels and embedding tables) to
        ``dtype``; ``dtype=""`` is the identity config."""
        if not dtype:
            return cls(kv_dtype=kv_dtype)
        if dtype not in QUANT_DTYPES:
            raise ValueError(f"weight dtype {dtype!r} not in {QUANT_DTYPES}")
        return cls(rules=tuple((p, dtype) for p in WEIGHT_PATTERNS), kv_dtype=kv_dtype)

    def dtype_for(self, path: str) -> str:
        for pat, d in self.rules:
            if re.search(pat, path):
                return d
        return self.default

    @property
    def quantizes(self) -> bool:
        return any(d in QUANT_DTYPES for d in [self.default] + [d for _, d in self.rules])

    def to_json_dict(self) -> dict:
        return {"rules": [[p, d] for p, d in self.rules], "default": self.default,
                "kv_dtype": self.kv_dtype}

    @classmethod
    def from_json_dict(cls, obj: Mapping) -> "PrecisionConfig":
        if not isinstance(obj, Mapping):
            raise ValueError(f"precision config must be a JSON object, got {type(obj).__name__}")
        unknown = set(obj) - {"rules", "default", "kv_dtype"}
        if unknown:
            raise ValueError(f"unknown precision config keys {sorted(unknown)}")
        rules = obj.get("rules", ())
        if not isinstance(rules, (list, tuple)) or any(
                not isinstance(e, (list, tuple)) or len(e) != 2 for e in rules):
            raise ValueError(f"precision rules must be [pattern, dtype] pairs, got {rules!r}")
        return cls(rules=tuple((str(p), str(d)) for p, d in rules),
                   default=str(obj.get("default", "")), kv_dtype=str(obj.get("kv_dtype", "")))

    def save(self, path: str) -> None:
        doc = {"version": PRECISION_JSON_VERSION, "config": self.to_json_dict()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "PrecisionConfig":
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError(f"{path}: not a JSON object")
        if "config" in doc:
            version = doc.get("version")
            if version != PRECISION_JSON_VERSION:
                raise ValueError(f"{path}: precision.json version {version!r} "
                                 f"(this build reads {PRECISION_JSON_VERSION})")
            return cls.from_json_dict(doc["config"])
        return cls.from_json_dict(doc)


def _leaves(tree: Mapping, prefix: str = ""):
    """(``/``-joined path, leaf) of a nested or flat param tree; a flat
    ``{"h_0.attn.qkv.kernel": t}`` dict renders as ``h_0/attn/qkv/kernel``."""
    for key, value in tree.items():
        path = prefix + str(key).replace(".", "/")
        if isinstance(value, Mapping):
            yield from _leaves(value, path + "/")
        else:
            yield path, value


def _is_floating(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return torch.is_floating_point(leaf)
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


def quantize_tree(params: Mapping, config: PrecisionConfig) -> dict:
    """Apply the registry to a param tree at load time, on the CPU:
    matched >= 2-D floating leaves become :class:`QuantizedWeight`, cast
    rules cast, the rest pass through. Returns a flat ``{path: leaf}``
    dict of CPU tensors and QuantizedWeights. 1-D leaves (biases, norms)
    are never quantized, even under a blanket rule."""
    if any(d == "fp8" for d in [config.default] + [d for _, d in config.rules]) \
            and not fp8_supported():
        raise ValueError("precision config requests fp8 weights but this torch build "
                         "has no working float8_e4m3fn")
    out = {}
    for path, leaf in _leaves(params):
        if isinstance(leaf, QuantizedWeight):
            out[path] = leaf
            continue
        t = leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
        name = config.dtype_for(path) if _is_floating(leaf) else ""
        if name in QUANT_DTYPES and t.dim() >= 2:
            out[path] = QuantizedWeight(*quantize_rows_host(t.float().numpy(), name))
        elif name in CAST_DTYPES:
            out[path] = t.to(_CASTS[name])
        else:
            out[path] = t
    return out


def tree_precision_stats(params: Mapping) -> dict:
    """Numeric facts about a (possibly quantized) param tree, the
    ``precision/*`` gauges and the serving line's precision keys:
    ``param_bytes`` as stored, ``param_bytes_f32`` (the same logical tree
    at 4 bytes a floating element), ``quantized_params`` (QuantizedWeight
    count) and ``weight_bits`` (payload bits of the quantized leaves,
    else the floating itemsize's)."""
    stored = f32 = quantized = 0
    bits = None
    for _, leaf in _leaves(params):
        if isinstance(leaf, QuantizedWeight):
            quantized += 1
            size = leaf.q.numel()
            stored += size * leaf.q.element_size() + leaf.scale.numel() * 4
            f32 += size * 4
            bits = leaf.q.element_size() * 8
            continue
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        size, itemsize = t.numel(), t.element_size()
        stored += size * itemsize
        if torch.is_floating_point(t):
            f32 += size * 4
            if bits is None:
                bits = itemsize * 8
        else:
            f32 += size * itemsize
    return {"param_bytes": stored, "param_bytes_f32": f32, "quantized_params": quantized,
            "weight_bits": bits if bits is not None else 32}


def tree_bytes(params: Mapping) -> int:
    """Bytes of every leaf as stored (a QuantizedWeight counts its
    payload and its scales): the port's copy of
    ``telemetry/memory.tree_bytes`` for one device."""
    total = 0
    for _, leaf in _leaves(params):
        parts = (leaf.q, leaf.scale) if isinstance(leaf, QuantizedWeight) else (leaf,)
        for t in parts:
            t = t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))
            total += t.numel() * t.element_size()
    return total
