"""Precision: the training policy and int8 rows for the serving KV cache.

The port of two parts of ``tensorflow_examples_tpu/core/precision.py``:

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
  time without requantizing the rest of the block.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping

import torch


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
    the last axis of ``q``."""
    return (q.float() * scale[..., None].float()).to(dtype)
