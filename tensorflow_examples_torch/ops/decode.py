"""Flash-decode: attention of new queries over a static KV cache.

The port of ``tensorflow_examples_tpu/ops/decode.py``. The public
contract is the same: ``q`` [B, H, q_len, D] holds queries at global
positions ``length - q_len … length - 1``; each attends cache slots up to
its own position; slots at or past ``length`` are never read.

``flash_decode_attention`` launches the hand-written Hopper kernel
``ops/csrc/decode.cu`` for CUDA tensors and runs the plain
:func:`decode_attention_reference` for CPU tensors. The TPU kernel's
power-of-two ``lax.switch`` ladder over KV grid sizes has no counterpart:
the CUDA kernel's KV loop has a dynamic bound that stops at the populated
length.
"""

from __future__ import annotations

import ctypes

import torch

from tensorflow_examples_torch.ops import _build
from tensorflow_examples_torch.ops.attention import NEG_INF, check_head_dim

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    length: int,
    *,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Plain masked cache attention, the numerics reference for the
    kernel. k_cache / v_cache: [B, H, max_len, D]. f32 scores and
    softmax, probabilities cast to the cache dtype, f32 accumulation,
    output in q's dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    q_len, max_len = q.shape[2], k_cache.shape[2]
    s = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) * sm_scale
    pos = (int(length) - q_len) + torch.arange(q_len, device=q.device)[:, None]
    col = torch.arange(max_len, device=q.device)[None, :]
    s = torch.where(col <= pos, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    return torch.matmul(p.float(), v_cache.float()).to(q.dtype)


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor like q")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype} != {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _lib():
    lib = _build.library("decode")
    fn = lib.flash_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    return fn


def flash_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    length: int,
    *,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Attend ``q`` [B, H, q_len, D] over the populated prefix of a
    [B, H, max_len, D] cache; ``length`` counts the q_len new tokens.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (f32 or bf16, a head_dim of ``SUPPORTED_HEAD_DIMS``, contiguous)
    or raises."""
    if q.device.type == "cpu":
        return decode_attention_reference(
            q, k_cache, v_cache, length, sm_scale=sm_scale
        )
    b, h, q_len, d = q.shape
    max_len = k_cache.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_decode_attention: dtype {q.dtype} not in f32/bf16")
    check_head_dim("flash_decode_attention", d)
    _check("q", q, q.dtype, (b, h, q_len, d))
    _check("k_cache", k_cache, q.dtype, (b, h, max_len, d))
    _check("v_cache", v_cache, q.dtype, (b, h, max_len, d))
    if sm_scale is None:
        sm_scale = d ** -0.5
    out = torch.empty_like(q)
    status = _lib()(
        _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        out.data_ptr(), b * h, q_len, max_len, int(length), d, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_decode")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
