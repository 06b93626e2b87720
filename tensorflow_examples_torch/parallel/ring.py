"""Sequence/context-parallel attention: the port of
``tensorflow_examples_tpu/parallel/ring.py``, as per-rank code.

Each rank holds a contiguous sequence shard of Q/K/V, ``[batch, heads,
seq_shard, head_dim]``, shard i holding tokens ``[i*s, (i+1)*s)`` (what
``P(..., 'context', ...)`` gives the reference).

* :func:`ring_attention`: K/V shards rotate around the ``context`` ring
  (``core/collectives.ppermute``); every hop attends the arriving shard
  with the flash kernels (``ops/attention.flash_attention_with_lse``)
  and hops merge exactly through their logsumexp (:func:`_merge`).
  Autograd differentiates through the merge and the lse, so each hop's
  backward kernels take a nonzero ``dlse``. Causal calls default to the
  **zigzag** layout: the sequence is cut into 2c chunks and ring position
  d works on chunks d and 2c-1-d, so every rank does two half-chunk
  attends a hop, the causal minimum. The re-layout is two half-shard
  permutations each way inside the call, so callers see contiguous
  shards. The contiguous ring stays for ``zigzag=False`` and non-causal
  calls; its causal form skips the hops whose K/V lie in a shard's
  future.
* :func:`ulysses_attention`: one all-to-all to head-sharded full
  sequences, the local flash kernel on ``heads / c`` heads, one
  all-to-all back.

Every rank runs its branch of a hop in Python (the reference's
``lax.cond``), and the collectives stay the same on every rank: each
hop's K/V move in one exchange, and the last hop's buffers are kept in
the backward graph (``collectives.depend``) on the ranks that do not
attend them, so every rank's backward meets the same collectives in the
same order.
"""

from __future__ import annotations

import torch

from tensorflow_examples_torch.core import collectives as coll
from tensorflow_examples_torch.ops.attention import flash_attention, flash_attention_with_lse


def _merge(out, lse, o_blk, lse_blk):
    """Exact merge of two partial attentions via their logsumexp: out
    [B,H,S,D] f32, lse [B,H,S]."""
    lse_new = torch.logaddexp(lse, lse_blk)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_blk = torch.exp(lse_blk - lse_new)[..., None]
    return out * w_old + o_blk.float() * w_blk, lse_new


def _zigzag_perms(c: int):
    """The contiguous <-> zigzag exchange tables: chunk g in [0, 2c)
    lives contiguously on rank g//2 and zigzag on z(g) = g if g < c else
    2c-1-g; even chunks and odd chunks are each a bijection."""
    z = lambda g: g if g < c else 2 * c - 1 - g
    fwd_even = [(i, z(2 * i)) for i in range(c)]
    fwd_odd = [(i, z(2 * i + 1)) for i in range(c)]
    bwd_even = [(z(2 * i), i) for i in range(c)]
    bwd_odd = [(z(2 * i + 1), i) for i in range(c)]
    return fwd_even, fwd_odd, bwd_even, bwd_odd


def _to_zigzag(xs, axis, mesh, c: int, my: int):
    """[B,H,2sc,D] contiguous shards -> (early, late) zigzag chunks of
    each, in one exchange. Zigzag rank d's early chunk (global chunk d)
    has d's parity, its late chunk (2c-1-d) the other."""
    fwd_even, fwd_odd, _, _ = _zigzag_perms(c)
    sc = xs[0].shape[2] // 2
    halves = [h.contiguous() for x in xs for h in (x[:, :, :sc], x[:, :, sc:])]
    moved = coll.exchange(halves, axis, mesh=mesh, perms=[fwd_even, fwd_odd] * len(xs))
    out = []
    for i in range(len(xs)):
        recv_even, recv_odd = moved[2 * i], moved[2 * i + 1]
        out.append((recv_even, recv_odd) if my % 2 == 0 else (recv_odd, recv_even))
    return out


def _from_zigzag(early, late, axis, mesh, c: int, my: int):
    """(early, late) zigzag chunks -> [B,H,2sc,D] contiguous shard."""
    _, _, bwd_even, bwd_odd = _zigzag_perms(c)
    first, second = (early, late) if my % 2 == 0 else (late, early)
    a, b = coll.exchange([first.contiguous(), second.contiguous()], axis, mesh=mesh,
                         perms=[bwd_even, bwd_odd])
    return torch.cat([a, b], dim=2)


def _ring_causal_zigzag(q, k, v, axis, mesh, c: int, sm_scale: float):
    my = mesh.axis_index(axis)
    (qe, ql), (ke, kl), (ve, vl) = _to_zigzag((q, k, v), axis, mesh, c, my)
    sc = qe.shape[2]
    # Hop 0, the diagonal: each local chunk attends itself causally and
    # the late chunk also sees the whole early chunk.
    oe, lse_e = flash_attention_with_lse(qe, ke, ve, causal=True, sm_scale=sm_scale)
    ol, lse_l = flash_attention_with_lse(ql, kl, vl, causal=True, sm_scale=sm_scale)
    oe = oe.float()
    o_le, lse_le = flash_attention_with_lse(ql, ke, ve, causal=False, sm_scale=sm_scale)
    ol, lse_l = _merge(ol.float(), lse_l, o_le, lse_le)
    perm = coll.ring_perm(c)
    for step in range(1, c):
        # After `step` hops this rank holds ring position j = (my - step)
        # % c: global chunks j (early) and 2c-1-j (late).
        ke, kl, ve, vl = coll.ppermute((ke, kl, ve, vl), axis, mesh=mesh, perm=perm)
        j = (my - step) % c
        if j < my:
            # K-chunk j is in both local chunks' past, 2c-1-j in neither's.
            o, lse = flash_attention_with_lse(torch.cat([qe, ql], dim=2), ke, ve, causal=False,
                                              sm_scale=sm_scale)
            oe, lse_e = _merge(oe, lse_e, o[:, :, :sc], lse[:, :, :sc])
            ol, lse_l = _merge(ol, lse_l, o[:, :, sc:], lse[:, :, sc:])
        else:
            # Only the late chunk (2c-1-my) sees anything: both arrivals.
            o, lse = flash_attention_with_lse(ql, torch.cat([ke, kl], dim=2),
                                              torch.cat([ve, vl], dim=2), causal=False,
                                              sm_scale=sm_scale)
            ol, lse_l = _merge(ol, lse_l, o, lse)
    ol = coll.depend(ol, ke, kl, ve, vl)
    return _from_zigzag(oe, ol, axis, mesh, c, my).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                   axis_name: str = "context", causal: bool = True,
                   sm_scale: float | None = None, zigzag: bool | None = None) -> torch.Tensor:
    """Context-parallel attention of this rank's contiguous shards
    [batch, heads, seq_shard, head_dim]. ``zigzag`` (causal only): the
    balanced layout; None = on whenever causal and the shard length is
    even."""
    c = mesh.axis_size(axis_name)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if c == 1:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if zigzag is None:
        zigzag = causal and q.shape[2] % 2 == 0
    if zigzag and not causal:
        raise ValueError("zigzag ring attention only applies to causal")
    if zigzag and q.shape[2] % 2:
        raise ValueError(f"zigzag needs an even shard length, got {q.shape[2]}")
    if zigzag:
        return _ring_causal_zigzag(q, k, v, axis_name, mesh, c, sm_scale)

    my = mesh.axis_index(axis_name)
    perm = coll.ring_perm(c)
    # Hop 0 is the local shard, the only one with an intra-shard triangle.
    out, lse = flash_attention_with_lse(q, k, v, causal=causal, sm_scale=sm_scale)
    out = out.float()
    k_blk, v_blk = k, v
    for step in range(1, c):
        k_blk, v_blk = coll.ppermute((k_blk, v_blk), axis_name, mesh=mesh, perm=perm)
        # Causal: an earlier shard is fully visible, a later one fully
        # masked and skipped (merge weight 0 in the reference).
        if causal and (my - step) % c > my:
            continue
        o_blk, lse_blk = flash_attention_with_lse(q, k_blk, v_blk, causal=False,
                                                  sm_scale=sm_scale)
        out, lse = _merge(out, lse, o_blk, lse_blk)
    out = coll.depend(out, k_blk, v_blk)
    return out.to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                      axis_name: str = "context", causal: bool = True,
                      sm_scale: float | None = None) -> torch.Tensor:
    """All-to-all sequence parallelism of [batch, heads, seq_shard,
    head_dim] shards; heads must divide by the axis size."""
    c = mesh.axis_size(axis_name)
    if c == 1:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    h = q.shape[1]
    if h % c:
        raise ValueError(f"heads {h} not divisible by context axis {c}")
    # [3, B, H, s, D] -> [3, B, H/c, S, D]: gather seq, scatter heads.
    qkv = coll.all_to_all(torch.stack([q, k, v]), axis_name, mesh=mesh, split_axis=2,
                          concat_axis=3)
    out = flash_attention(qkv[0], qkv[1], qkv[2], causal=causal, sm_scale=sm_scale)
    return coll.all_to_all(out, axis_name, mesh=mesh, split_axis=2, concat_axis=1)
