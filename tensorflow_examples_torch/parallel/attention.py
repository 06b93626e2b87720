"""Mesh-aware attention dispatch: the port of
``tensorflow_examples_tpu/parallel/attention.py``, as per-rank code.

The reference wraps the Pallas kernel (or the ring and Ulysses
collectives when the ``context`` axis is real) in a ``shard_map`` with
the canonical spec: batch over (data, fsdp), heads over ``model``,
sequence over ``context``. Here every rank already holds exactly that
shard, ``[batch/nb, heads/m, seq/c, head_dim]``, and :func:`mesh_attention`
runs the flash kernels on it: locally, or through ``parallel/ring.py``
when ``context`` > 1.

Causal context-parallel calls keep the reference's pad: the global
sequence is padded at its end to a multiple of 2c whose zigzag
half-chunks the kernels tile (:func:`context_pad`), so zigzag always
applies. Per rank that is a re-layout: the shards are gathered over
``context`` (``collectives.all_gather``, whose backward is a
reduce-scatter), padded, re-cut, and the output gathered and cut back.
Pad keys sit in every real query's causal future, so no real row sees
one. At GPT-2's seq 1024 over 2 or 4 ranks the pad is 0.

``key_bias`` ([B, S_kv] additive score bias, BERT's padding mask) takes
the decode-style layout: batch and heads sharded, the sequence whole on
every rank; the ring and Ulysses carry no bias. ``impl="xla"`` is the
plain reference; over ``context`` it gathers K/V and attends the prefix
up to this shard's end, the causal mask aligned by the kernel's
bottom-right rule. Decode-time attention (:func:`mesh_decode_attention`)
takes the :func:`decode_spec` layout: batch rows and heads sharded, the
cache positionally whole.
"""

from __future__ import annotations

import math

import torch

from tensorflow_examples_torch.core import collectives as coll
from tensorflow_examples_torch.core.mesh import AxisNames
from tensorflow_examples_torch.ops.attention import (attention_reference, dot_product_attention,
                                                     flash_attention)
from tensorflow_examples_torch.ops.decode import flash_decode_attention
from tensorflow_examples_torch.parallel.ring import ring_attention, ulysses_attention

IMPLS = ("flash", "xla", "ring", "ulysses")


def _entry(axes: tuple):
    """A spec entry for ``axes``: None, one axis by name, or the tuple
    (as a ``PartitionSpec`` normalizes it)."""
    return None if not axes else axes[0] if len(axes) == 1 else axes


def attention_spec(mesh) -> tuple:
    """The spec of [batch, heads, seq, head_dim] on the mesh."""
    batch = tuple(a for a in AxisNames.BATCH_AXES if mesh.shape[a] > 1)
    model = AxisNames.MODEL if mesh.shape[AxisNames.MODEL] > 1 else None
    ctx = AxisNames.CONTEXT if mesh.shape[AxisNames.CONTEXT] > 1 else None
    return (_entry(batch), model, ctx, None)


def decode_spec(mesh, batch: int, heads: int) -> tuple:
    """The spec of decode-time [batch, heads, seq, head_dim] operands:
    batch over the batch axes, heads over ``model``, each replicated
    when its size does not divide; no ``context`` entry."""
    batch_axes = tuple(a for a in AxisNames.BATCH_AXES if mesh.shape[a] > 1)
    nb = math.prod(mesh.shape[a] for a in batch_axes) if batch_axes else 1
    if batch % nb:
        batch_axes = ()
    m = mesh.shape[AxisNames.MODEL]
    model = AxisNames.MODEL if m > 1 and heads % m == 0 else None
    return (_entry(batch_axes), model, None, None)


def mesh_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          length: int, *, mesh, sm_scale: float | None = None) -> torch.Tensor:
    """KV-cache flash-decode of this rank's [B, H, q_len, D] query and
    [B, H, max_len, D] cache shards, laid out by :func:`decode_spec`:
    its batch rows over the batch axes and its heads over ``model``, a
    dimension that the axes do not divide whole on every rank. Each rank runs
    ``ops/decode.flash_decode_attention`` on what it holds, the body of
    the reference's ``shard_map``: the cache is never gathered, and the
    output is this rank's shard of the reference's. A one-rank mesh (or
    none) is the plain call."""
    if q.shape[:2] != k_cache.shape[:2] or k_cache.shape != v_cache.shape:
        raise ValueError(f"mesh_decode_attention: q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)} are not one shard")
    return flash_decode_attention(q, k_cache, v_cache, length, sm_scale=sm_scale)


def context_pad(seq: int, c: int) -> int:
    """Tokens to pad a global causal sequence of ``seq`` with over ``c``
    context ranks: to the next multiple of 2c whose half-chunk ``hc``
    either rides one 256 block or tiles by 8 (both hc and 2·hc are
    attended)."""
    target = -(-seq // (2 * c)) * (2 * c)
    hc = target // (2 * c)
    while (hc > 256 and hc % 8) or (2 * hc > 256 and hc % 4):
        target += 2 * c
        hc = target // (2 * c)
    return target - seq


def _recut(xs: torch.Tensor, mesh, seq: int, pad: int) -> torch.Tensor:
    """Shards [..., s, D] of a length-``seq`` sequence (seq dim -2) ->
    this rank's shard of it padded by ``pad`` at the end."""
    c, i = mesh.axis_size(AxisNames.CONTEXT), mesh.axis_index(AxisNames.CONTEXT)
    full = coll.all_gather(xs, AxisNames.CONTEXT, mesh=mesh, dim=xs.dim() - 2)
    full = torch.nn.functional.pad(full, (0, 0, 0, pad))
    size = (seq + pad) // c
    return full.narrow(xs.dim() - 2, i * size, size).contiguous()


def mesh_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                   causal: bool = True, sm_scale: float | None = None, impl: str = "flash",
                   key_bias: torch.Tensor | None = None, stage: bool = False) -> torch.Tensor:
    """Attention of this rank's [B, H, S, D] shards laid out by
    :func:`attention_spec`. ``ring``/``ulysses`` choose the context
    algorithm when ``context`` > 1 (``flash`` means ring there).

    ``stage``: the call runs inside a pipeline stage (the reference's
    ``_stage_tp_axis`` branch). The rank's heads are already its
    ``model`` share, so the kernels run on them as they do outside a
    stage; a key bias there raises, as the reference's does."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r} not in {IMPLS}")
    if stage and key_bias is not None:
        raise NotImplementedError("key_bias inside a pipeline stage is unexercised; add a "
                                  "test with the bias grad psum before enabling")
    if key_bias is not None and impl == "xla":
        raise ValueError("key_bias requires the flash path (impl != 'xla')")
    c = 1 if mesh is None else mesh.axis_size(AxisNames.CONTEXT)
    if key_bias is not None:
        if c > 1:
            raise ValueError("key_bias keeps the sequence whole: it has no context-parallel "
                             "route (the ring and Ulysses carry no bias)")
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale, key_bias=key_bias)
    if impl == "xla":
        if c > 1:
            i, s = mesh.axis_index(AxisNames.CONTEXT), q.shape[2]
            kv = coll.all_gather(torch.stack([k, v]), AxisNames.CONTEXT, mesh=mesh, dim=3)
            if causal:
                kv = kv[:, :, :, :(i + 1) * s]
            k, v = kv[0], kv[1]
        return attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if c == 1:
        return dot_product_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, mesh=mesh, axis_name=AxisNames.CONTEXT,
                                 causal=causal, sm_scale=sm_scale)
    s = q.shape[2]
    pad = context_pad(s * c, c) if causal else 0
    if not pad:
        return ring_attention(q, k, v, mesh=mesh, axis_name=AxisNames.CONTEXT, causal=causal,
                              sm_scale=sm_scale)
    qkv = _recut(torch.stack([q, k, v]), mesh, s * c, pad)
    out = ring_attention(qkv[0], qkv[1], qkv[2], mesh=mesh, axis_name=AxisNames.CONTEXT,
                         causal=causal, sm_scale=sm_scale)
    full = coll.all_gather(out, AxisNames.CONTEXT, mesh=mesh, dim=2)
    i = mesh.axis_index(AxisNames.CONTEXT)
    return full[:, :, i * s:(i + 1) * s].contiguous()
