"""Symmetric per-row int8 quantization for the serving KV cache.

The port of ``quantize_int8_rows`` / ``dequantize_int8_rows`` from
``tensorflow_examples_tpu/core/precision.py``: each cache row (one
token's K or V for one head) carries its own f32 scale, stored blockwise
beside the int8 payload, so rows append one decode step at a time
without requantizing the rest of the block.
"""

from __future__ import annotations

import torch

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
