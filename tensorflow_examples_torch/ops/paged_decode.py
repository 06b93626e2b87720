"""Fused paged-decode attention: block-table gather and per-slot masked
attention in one kernel.

The port of ``tensorflow_examples_tpu/ops/paged_decode.py``, same
contract:

* ``q`` [S, H, D]: one new query per slot, its K/V already written
  through the block table.
* ``k_blocks`` / ``v_blocks`` [NB, H, BS, D]: one layer's block pools
  (``serving/paged_kv.PagedKVPool`` layout).
* ``lengths`` [S] int32: populated lengths including the new token; slot
  s attends columns ``< lengths[s]`` and nothing else.
* ``block_tables`` [S, nb] int32: logical -> physical block map for the
  active KV bucket.
* ``k_scale`` / ``v_scale`` [NB, H, BS] f32 (optional): the int8 pools'
  per-row scales; passing them selects the dequant-in-kernel path.

``paged_decode_attention`` launches ``ops/csrc/paged_decode.cu`` for CUDA
tensors and runs the plain :func:`paged_decode_reference` (the gather
path the engine runs under ``attention="xla"``) for CPU tensors. A slot
of length 0 comes out as zeros from the kernel and as the uniform
average from the plain version: its output is discarded either way.

The kernel splits each slot's logical blocks into runs of
``blocks_per_split`` (:func:`paged_plan`, from the block size and the
table width alone: the lengths live on the device) and a second kernel
merges the runs' partials in order; :func:`paged_split_reference` is the
plain version of that route.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tensorflow_examples_torch.ops import _build
from tensorflow_examples_torch.ops.attention import _ptr, check_head_dim
from tensorflow_examples_torch.ops.decode import merge_partials, split_partial

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_BLOCK_SIZE = 64  # the largest block size the kernel takes
SPLIT_ROWS = 128     # cache rows a split covers at most


def paged_plan(block_size: int, nb: int) -> tuple[int, int]:
    """(blocks_per_split, splits) for a table of ``nb`` blocks of
    ``block_size`` rows: runs of up to ``SPLIT_ROWS`` rows, as many as the
    table holds. A pure function of shapes: a split past a slot's length
    finds that out on the device and writes an empty partial."""
    per = max(1, SPLIT_ROWS // block_size)
    return per, -(-nb // per)


def paged_split_reference(
    q: torch.Tensor,
    k_blocks: torch.Tensor,
    v_blocks: torch.Tensor,
    lengths: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """The kernel's split-then-merge route in plain PyTorch: slot s's rows
    below ``min(lengths[s], nb * BS)``, gathered (and dequantized) through
    its table, in the runs of :func:`paged_plan`, each run's (acc, m, l)
    alone (:func:`split_partial`, f32 probabilities), merged in order by
    :func:`merge_partials`. A length-0 slot comes out as zeros."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    num_slots, h, d = q.shape
    block_size, nb = k_blocks.shape[2], block_tables.shape[1]
    per, splits = paged_plan(block_size, nb)
    tables = block_tables.long()

    def rows(blocks, scales):  # [S, H, nb * BS, D] in f32
        g = blocks[tables].float()
        if scales is not None:
            g = g * scales[tables][..., None]
        return g.transpose(1, 2).reshape(num_slots, h, nb * block_size, d)

    k, v = rows(k_blocks, k_scale), rows(v_blocks, v_scale)
    s = torch.einsum("shd,shkd->shk", q.float(), k) * sm_scale
    col = torch.arange(nb * block_size, device=q.device)
    s = torch.where(col[None, None, :] < lengths.to(q.device).long()[:, None, None], s, -math.inf)
    parts = []
    for i in range(splits):
        c0, c1 = i * per * block_size, min((i + 1) * per * block_size, nb * block_size)
        parts.append(split_partial(s[..., None, c0:c1], v[:, :, c0:c1]))
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    n = num_slots * h
    out = merge_partials(acc.reshape(splits, n, d), m.reshape(splits, n), l.reshape(splits, n))
    return out.reshape(num_slots, h, d).to(q.dtype)


def paged_decode_reference(
    q: torch.Tensor,
    k_blocks: torch.Tensor,
    v_blocks: torch.Tensor,
    lengths: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """The gather-path oracle: dequantize (int8) or gather (fp) each
    slot's blocks by table, then ``varlen_decode_attention``."""
    from tensorflow_examples_torch.serving.kv_cache import (
        gather_block_kv,
        varlen_decode_attention,
    )

    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    tables = block_tables.long()
    if k_scale is not None:
        from tensorflow_examples_torch.core.precision import dequantize_int8_rows

        s, nb = tables.shape
        _, h, bs, d = k_blocks.shape

        def gather(blocks, scales):
            g = dequantize_int8_rows(blocks[tables], scales[tables], q.dtype)
            return g.transpose(1, 2).reshape(s, h, nb * bs, d)

        return varlen_decode_attention(
            q, gather(k_blocks, k_scale), gather(v_blocks, v_scale),
            lengths, sm_scale=sm_scale,
        )
    return varlen_decode_attention(
        q, gather_block_kv(k_blocks, tables), gather_block_kv(v_blocks, tables),
        lengths, sm_scale=sm_scale,
    )


def _check(name: str, t: torch.Tensor, dtypes, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor like q")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {sorted(map(str, dtypes))}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _lib():
    lib = _build.library("paged_decode")
    fn = lib.paged_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    return fn


def paged_decode_attention(
    q: torch.Tensor,
    k_blocks: torch.Tensor,
    v_blocks: torch.Tensor,
    lengths: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Single-token per-slot attention straight through the block table;
    see the module docstring. Returns [S, H, D] in ``q.dtype``. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises. Counts ``launches`` once a call, and ``split_launches`` when
    :func:`paged_plan` splits."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if q.device.type == "cpu":
        return paged_decode_reference(
            q, k_blocks, v_blocks, lengths, block_tables,
            k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale,
        )
    num_slots, num_heads, d = q.shape
    num_blocks, _, block_size, _ = k_blocks.shape
    nb = block_tables.shape[1]
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"paged_decode_attention: q dtype {q.dtype} not in f32/bf16")
    check_head_dim("paged_decode_attention", d)
    if block_size > MAX_BLOCK_SIZE:
        raise ValueError(f"paged_decode_attention: block size {block_size} > {MAX_BLOCK_SIZE}")
    quantized = k_scale is not None
    kv_dtypes = {torch.int8} if quantized else {q.dtype}
    pool_shape = (num_blocks, num_heads, block_size, d)
    _check("q", q, _Q_DTYPES, q.shape)
    _check("k_blocks", k_blocks, kv_dtypes, pool_shape)
    _check("v_blocks", v_blocks, kv_dtypes, pool_shape)
    _check("lengths", lengths, {torch.int32}, (num_slots,))
    _check("block_tables", block_tables, {torch.int32}, (num_slots, nb))
    if quantized:
        _check("k_scale", k_scale, {torch.float32}, pool_shape[:-1])
        _check("v_scale", v_scale, {torch.float32}, pool_shape[:-1])
    if sm_scale is None:
        sm_scale = d ** -0.5
    per, splits = paged_plan(block_size, nb)
    out = torch.empty_like(q)
    acc = ml = None
    if splits > 1:
        acc = torch.empty(splits, num_slots * num_heads, d, dtype=torch.float32, device=q.device)
        ml = torch.empty(2, splits, num_slots * num_heads, dtype=torch.float32, device=q.device)
    status = _lib()(
        _Q_DTYPES[q.dtype], _KV_DTYPES[k_blocks.dtype], q.data_ptr(),
        k_blocks.data_ptr(), v_blocks.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
        _ptr(acc), _ptr(ml), None if ml is None else ml[1].data_ptr(),
        num_slots, num_heads, num_blocks, block_size, nb, d, per, splits, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "paged_decode")
    paged_decode_attention.launches += 1
    paged_decode_attention.split_launches += splits > 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.split_launches = 0
