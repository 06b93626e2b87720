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

The launch follows a plan made from shapes alone (:func:`decode_plan`):
the route (bf16 at head_dim >= 16 on the tensor cores, else SIMT), the
query rows a CTA takes, and the number of splits of the KV walk. A small
grid splits each query tile's KV tiles across CTAs, whose unnormalised
partials a second kernel merges in split order
(:func:`merge_partials` is its plain version, :func:`decode_split_reference`
the plain version of the whole split-then-merge route).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from tensorflow_examples_torch.ops import _build
from tensorflow_examples_torch.ops.attention import NEG_INF, _ptr, check_head_dim

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_TILE = 64            # cache rows a CTA stages at a time, both routes
SPLIT_BELOW_CTAS = 264  # two waves of the H100's 132 SMs: a smaller grid splits KV
MAX_SPLITS = 32


class DecodePlan(NamedTuple):
    """How one flash-decode call launches: ``route`` "tensor_core" or
    "simt", ``block_q`` query rows a CTA, ``splits`` CTAs along each query
    tile's KV walk (1: no split and no merge)."""

    route: str
    block_q: int
    splits: int


def decode_plan(dtype: torch.dtype, q_len: int, length: int, max_len: int, bh: int,
                head_dim: int) -> DecodePlan:
    """The launch plan, a pure function of the call's shapes (never of
    data on the device, and never from a failed launch). bf16 at head_dim
    >= 16 runs on the tensor cores with 16 query rows a warp and 1, 2 or
    4 warps; f32 (and bf16 at head_dim 8) runs the register-tiled SIMT
    kernel with 64 rows a CTA, or 16 for q_len <= 16 at head_dim >= 32.

    When the grid of query tiles x bh is under ``SPLIT_BELOW_CTAS``, each
    query tile's KV tiles are split across up to that many CTAs in all
    (at most ``MAX_SPLITS``). A SIMT split takes at least one KV tile. On
    the tensor cores a tile costs little next to the merge (a second
    launch and the partials' traffic), so only a single query tile a
    head is split (decode steps, short queries over a long cache), at
    least two KV tiles a split: splitting bf16 prefills measured slower
    on the H100 (PERF.md, section 6)."""
    if dtype == torch.bfloat16 and head_dim >= 16:
        route, block_q = "tensor_core", 16 if q_len <= 16 else (32 if q_len <= 32 else 64)
    else:
        route, block_q = "simt", 16 if q_len <= 16 and head_dim >= 32 else 64
    q_tiles = -(-q_len // block_q)
    kv_tiles = -(-max(0, min(int(length), max_len)) // KV_TILE)
    tiles_per_split = 1 if route == "simt" else 2
    splits = 1
    if q_tiles * bh < SPLIT_BELOW_CTAS and (route == "simt" or q_tiles == 1):
        splits = max(1, min(-(-SPLIT_BELOW_CTAS // (q_tiles * bh)),
                            -(-kv_tiles // tiles_per_split), MAX_SPLITS))
    return DecodePlan(route, block_q, splits)


def merge_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Plain version of the split merge: ``acc`` [splits, rows, D]
    (unnormalised), ``m`` and ``l`` [splits, rows] (each split's running
    max and sum) combined in split order: ``O = sum acc_i e^(m_i - m) /
    max(sum l_i e^(m_i - m), 1e-30)``, ``m = max m_i``. A split that saw
    nothing (acc 0, m -1e30, l 0) weighs exactly 0. Returns [rows, D] f32."""
    mx = m.max(dim=0).values
    out = torch.zeros_like(acc[0])
    total = torch.zeros_like(mx)
    for i in range(acc.shape[0]):
        w = torch.exp(m[i] - mx)
        total = total + l[i] * w
        out = out + acc[i] * w[:, None]
    return out / torch.clamp(total, min=1e-30)[:, None]


def split_partial(s: torch.Tensor, v: torch.Tensor):
    """(acc, m, l) of one split as its online softmax leaves them: masked
    scores ``s`` [..., rows, cols] (-inf where masked) over ``v``
    [..., cols, D]; m starts at -1e30, p = e^(s - m) is cast to v's dtype
    for P V, l sums the f32 p. A split with no column is (0, -1e30, 0)."""
    m = torch.full(s.shape[:-1], NEG_INF, dtype=torch.float32, device=s.device)
    if s.shape[-1]:
        m = torch.clamp(s.max(dim=-1).values, min=NEG_INF)
    p = torch.exp(s - m[..., None])
    return torch.matmul(p.to(v.dtype).float(), v.float()), m, p.sum(dim=-1)


def decode_split_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    length: int,
    *,
    block_q: int,
    splits: int,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """The kernels' split-then-merge route in plain PyTorch: each tile of
    ``block_q`` query rows walks the KV tiles its rows may see, split into
    ``splits`` contiguous near-equal runs of tiles; each run's (acc, m, l)
    is computed alone (:func:`split_partial`) and :func:`merge_partials`
    combines them in order. Same contract and output as
    :func:`decode_attention_reference`."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    b, h, q_len, d = q.shape
    max_len = k_cache.shape[2]
    qf, kf, vf = (t.reshape(b * h, -1, d) for t in (q, k_cache, v_cache))
    shift = int(length) - q_len
    out = torch.empty(b * h, q_len, d, dtype=torch.float32, device=q.device)
    for q0 in range(0, q_len, block_q):
        rows = torch.arange(q0, min(q0 + block_q, q_len), device=q.device)
        kv_end = max(0, min(shift + int(rows[-1]) + 1, max_len))
        n = -(-kv_end // KV_TILE)
        parts = []
        for i in range(splits):
            c0 = min(n * i // splits * KV_TILE, kv_end)
            c1 = min(n * (i + 1) // splits * KV_TILE, kv_end)
            cols = torch.arange(c0, c1, device=q.device)
            s = torch.matmul(qf[:, rows].float(), kf[:, c0:c1].float().transpose(-1, -2))
            s = torch.where(cols[None, None, :] <= (rows + shift)[None, :, None],
                            s * sm_scale, -math.inf)
            parts.append(split_partial(s, vf[:, c0:c1]))
        acc, m, l = (torch.stack(x) for x in zip(*parts))
        out[:, rows] = merge_partials(acc.flatten(1, 2), m.flatten(1), l.flatten(1)).reshape(
            b * h, len(rows), d)
    return out.reshape(b, h, q_len, d).to(q.dtype)


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
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
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
    as :func:`decode_plan` says, or raises. Counts ``launches`` once a
    call, and by variant ``tensor_core_launches`` or ``simt_launches``,
    and ``split_launches`` when the plan splits."""
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
    plan = decode_plan(q.dtype, q_len, int(length), max_len, b * h, d)
    out = torch.empty_like(q)
    acc = ml = None
    if plan.splits > 1:
        acc = torch.empty(plan.splits, b * h * q_len, d, dtype=torch.float32, device=q.device)
        ml = torch.empty(2, plan.splits, b * h * q_len, dtype=torch.float32, device=q.device)
    status = _lib()(
        _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        out.data_ptr(), _ptr(acc), _ptr(ml), None if ml is None else ml[1].data_ptr(),
        b * h, q_len, max_len, int(length), d, plan.block_q, plan.splits, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_decode")
    fn = flash_decode_attention
    fn.launches += 1
    if plan.route == "tensor_core":
        fn.tensor_core_launches += 1
    else:
        fn.simt_launches += 1
    fn.split_launches += plan.splits > 1
    return out


flash_decode_attention.launches = 0
flash_decode_attention.tensor_core_launches = 0
flash_decode_attention.simt_launches = 0
flash_decode_attention.split_launches = 0
