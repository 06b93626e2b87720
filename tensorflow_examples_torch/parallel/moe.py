"""Mixture-of-Experts FFN: the port of
``tensorflow_examples_tpu/parallel/moe.py``, the single-program
``moe_ffn`` and the expert-parallel ``moe_ffn_ep``.

Switch/GShard top-k routing with one router (:func:`_router`: f32 logits,
uniform jitter at train time from a ``core/rng`` key, softmax, sequential
argmax top-k; the top-1 gate is the raw probability, top-k > 1
renormalizes) and two dispatch formulations:

* ``impl="grouped"``: sort-based dropless dispatch. Stable-argsort the
  (token, rank) pairs by expert, run both expert products as grouped
  matmuls over the contiguous segments (:func:`_grouped_matmul`, the
  ``gmm``/``tgmm`` kernels of ``ops/grouped_matmul.py`` on the card), and
  restore pair order with the inverse permutation. Both permutation hops
  are :class:`_PermuteRows`, whose backward is the inverse gather, the
  token replication is an ``expand`` whose backward is a contiguous sum,
  and the expert biases are gathered onto the sorted rows by
  :class:`_TakeGroupRows`, whose backward sums each expert's segment
  (``group_row_sum``): no row scatter forward or backward. The drop
  fraction is 0.
* ``impl="scatter"``: static per-expert capacity (Switch semantics), the
  reference: overflow falls through the residual and the dropped
  fraction is returned.

``impl`` ``""`` or ``None`` resolves by device as the reference resolves
by backend: ``grouped`` on CUDA, ``scatter`` on the CPU. The two compute
the same function when nothing drops. Order semantics are jax's: stable
sorts, first-index ``argmax``, ``bincount`` with ``minlength``.

:func:`moe_ffn_ep` is expert parallelism over the ``model`` axis, as
per-rank code: each rank holds E/m experts (``GPT2_RULES``) and routes
its 1/m block of the tokens (replicated over ``model`` under TP; kept
whole on every rank when the count does not divide), with capacity per
source rank. The capacity buffers are built by sorted gathers
(:func:`_capacity_slots_sorted`, :class:`_MaskedRowGather`, whose
backward is the inverse masked gather), one ``all_to_all`` takes each
expert's slots to its rank and one brings the outputs back, and the
blocks are gathered over ``model`` into the replicated output. The local
experts' FFN is the einsum of the capacity path: no Pallas kernel lies
on this path in the reference either.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from tensorflow_examples_torch.core import collectives as coll
from tensorflow_examples_torch.core.mesh import AxisNames
from tensorflow_examples_torch.ops import grouped_matmul as gm_ops
from tensorflow_examples_torch.ops.grouped_matmul import grouped_matmul

IMPLS = ("grouped", "scatter")


def _router_probs(tokens: torch.Tensor, gate_w: torch.Tensor, *, rng, jitter: float
                  ) -> torch.Tensor:
    """The router's probabilities [n, E]: softmax of the f32 logits plus,
    with a jitter source, its uniform jitter on [-jitter, jitter)."""
    logits = tokens.float() @ gate_w.float()
    if rng is not None and jitter > 0:
        logits = logits + rng(tuple(logits.shape), -jitter, jitter, logits.device)
    return torch.softmax(logits, dim=-1)


def _router(tokens: torch.Tensor, gate_w: torch.Tensor, *, top_k: int,
            rng, jitter: float):
    """Top-k router shared by both formulations. Returns (gates, experts,
    mean_onehot0 [E], mean_probs [E]); ``gates``/``experts`` are lists of
    ``top_k`` [n] tensors."""
    e = gate_w.shape[-1]
    probs = _router_probs(tokens, gate_w, rng=rng, jitter=jitter)
    masked = probs
    experts, gates = [], []
    for _ in range(top_k):
        ej = torch.argmax(masked, dim=-1)  # the first index among ties, as jnp.argmax
        experts.append(ej)
        gates.append(torch.gather(masked, -1, ej[:, None])[:, 0])
        masked = masked * (1.0 - F.one_hot(ej, e).float())
    # top-1 keeps the raw probability (the router's task gradient); top-k
    # renormalizes over the chosen experts.
    if top_k > 1:
        denom = torch.clamp(sum(gates), min=1e-9)
        gates = [g / denom for g in gates]
    mean_onehot0 = F.one_hot(experts[0], e).float().mean(dim=0)
    return gates, experts, mean_onehot0, probs.mean(dim=0)


def _route(tokens, gate_w, *, top_k: int, capacity: int, rng, jitter: float):
    """Router plus static-capacity slotting: rank-0 assignments queue
    first, then rank 1, ...; a position past ``capacity`` drops. Returns
    (gates, flat_slots, keeps, mean_onehot0, mean_probs, kept count)."""
    e = gate_w.shape[-1]
    gates, experts, mean_onehot0, mean_probs = _router(tokens, gate_w, top_k=top_k, rng=rng,
                                                       jitter=jitter)
    counts = torch.zeros(e, dtype=torch.long, device=tokens.device)
    flat_slots, keeps = [], []
    for ej in experts:
        oh = F.one_hot(ej, e)
        pos = ((torch.cumsum(oh, dim=0) + counts[None, :]) * oh).sum(dim=-1)  # 1-based
        keeps.append(pos <= capacity)
        flat_slots.append(ej * capacity + torch.clamp(pos - 1, 0, capacity - 1))
        counts = counts + oh.sum(dim=0)
    kept = sum(k.long().sum() for k in keeps)
    return gates, flat_slots, keeps, mean_onehot0, mean_probs, kept


def _dispatch(tokens, flat_slots, keeps, e: int, capacity: int):
    """Add the kept token rows into the [E*C, d] expert buffers (slots are
    unique per kept pair; a dropped pair adds zeros)."""
    xin = torch.zeros(e * capacity, tokens.shape[-1], dtype=tokens.dtype, device=tokens.device)
    for flat, keep in zip(flat_slots, keeps):
        xin = xin.index_add(0, flat, tokens * keep[:, None].to(tokens.dtype))
    return xin


def _expert_ffn(xin, w_in, b_in, w_out, b_out):
    """The experts' FFN over [E, C, d] buffers."""
    h = F.gelu(torch.einsum("ecd,edf->ecf", xin, w_in) + b_in[:, None, :], approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, w_out) + b_out[:, None, :]


def _combine(yout, flat_slots, keeps, gates, n: int):
    """Each (token, rank)'s output row, gated and summed, in f32."""
    yflat = yout.reshape(-1, yout.shape[-1]).float()
    out = torch.zeros(n, yflat.shape[-1], dtype=torch.float32, device=yflat.device)
    for flat, keep, gate in zip(flat_slots, keeps, gates):
        out = out + yflat[flat] * (gate * keep)[:, None]
    return out


def _grouped_matmul(lhs, rhs, sizes):
    """[m, k] x [g, k, n] over per-group row segments -> [m, n], for any
    m, k and n: the ``gmm``/``tgmm`` kernels on the card (the reference's
    128-divisibility gate and TPU tiling have no counterpart)."""
    return grouped_matmul(lhs, rhs, sizes)


class _PermuteRows(torch.autograd.Function):
    """``x[perm]`` whose backward is the inverse gather ``g[inv_perm]``,
    never a scatter."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x[perm]

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        return g[inv_perm], None, None


def _permute_rows(x, perm, inv_perm):
    return _PermuteRows.apply(x, perm, inv_perm)


class _TakeGroupRows(torch.autograd.Function):
    """``b[ids]`` for ``ids`` sorted into consecutive segments, segment i
    holding ``sizes[i]`` copies of i (the reference's ``jnp.take(b, ids,
    axis=0)`` on the expert-sorted rows). Its backward is ``db[i]`` = the
    sum of segment i's gradient rows, f32 rounded to ``b``'s dtype, by
    ``group_row_sum`` (looked up at each call, so the on-card comparison
    with the plain version can rebind it): no scatter, no atomics."""

    @staticmethod
    def forward(ctx, b, ids, sizes):
        ctx.save_for_backward(sizes)
        ctx.rows = b.shape[0]
        return b.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (sizes,) = ctx.saved_tensors
        return gm_ops.group_row_sum(g, sizes, ctx.rows), None, None


def _take_group_rows(b, ids, sizes):
    return _TakeGroupRows.apply(b, ids, sizes)


def _pair_sort(experts, e: int):
    """Flatten the (token, rank) pairs token-major (pair p = token p // k,
    rank p % k) and stable-sort them by expert. Returns (eid, order, inv,
    sizes)."""
    eid = torch.stack(experts, dim=1).reshape(-1)
    order = torch.argsort(eid, stable=True)
    inv = torch.argsort(order, stable=True)
    # bincount sizes its output from a host read of the max; a scatter of
    # ones into [e] counts the same with no sync (a CUDA graph holds it).
    sizes = torch.zeros(e, dtype=eid.dtype, device=eid.device).scatter_add_(
        0, eid, torch.ones_like(eid))
    return eid, order, inv, sizes


def _moe_ffn_grouped(gate_w, w_in, b_in, w_out, b_out, x, *, top_k: int, rng, jitter: float):
    """Sort-based dropless dispatch through the grouped matmuls."""
    b, s, d = x.shape
    e = gate_w.shape[-1]
    n = b * s
    tokens = x.reshape(n, d)
    gates, experts, moh0, mpr = _router(tokens, gate_w, top_k=top_k, rng=rng, jitter=jitter)
    aux = e * torch.sum(moh0 * mpr)

    eid, order, inv, sizes = _pair_sort(experts, e)
    sizes = sizes.to(torch.int32)
    gat = torch.stack(gates, dim=1).reshape(-1)                         # [n*k] f32
    replicated = tokens[:, None, :].expand(n, top_k, d).reshape(n * top_k, d)
    srt_tok = _permute_rows(replicated, order, inv)                     # [n*k, d]
    srt_eid = eid[order]

    h = F.gelu(_grouped_matmul(srt_tok, w_in, sizes) + _take_group_rows(b_in, srt_eid, sizes),
               approximate="tanh")
    y = _grouped_matmul(h, w_out, sizes) + _take_group_rows(b_out, srt_eid, sizes)

    yw = y.float() * _permute_rows(gat, order, inv)[:, None]
    restored = _permute_rows(yw, inv, order)                            # pair order
    out = restored.reshape(n, top_k, d).sum(dim=1)
    return out.reshape(b, s, d).to(x.dtype), aux, torch.zeros((), device=x.device)


def moe_ffn(gate_w, w_in, b_in, w_out, b_out, x, *, capacity_factor: float = 1.25,
            top_k: int = 1, rng=None, jitter: float = 1e-2,
            impl: str | None = None):
    """Top-k MoE FFN of ``x`` [B, S, d] with router ``gate_w`` [d, E] and
    experts ``w_in`` [E, d, ff], ``b_in`` [E, ff], ``w_out`` [E, ff, d],
    ``b_out`` [E, d]. Returns ``(out [B, S, d] in x's dtype, aux_loss,
    drop_fraction)``, both scalars f32: the Switch load-balancing loss
    ``E * sum_e(fraction of rank-0 tokens to e * mean prob of e)`` and the
    fraction of (token, rank) pairs that overflowed capacity. ``rng``: the
    router jitter's source, ``(shape, minval, maxval, device) -> tensor``
    of uniforms on the device (a block's ``core/rng.StepNoise.router_jitter``,
    jax's bits); None: no jitter. ``impl``:
    ``"grouped"``, ``"scatter"``, or ``""``/``None`` for the device's
    default (grouped on CUDA, scatter on the CPU)."""
    if not impl:
        impl = "grouped" if x.is_cuda else "scatter"
    if impl not in IMPLS:
        raise ValueError(f"moe_ffn impl={impl!r} unknown (expected 'grouped' or 'scatter')")
    b, s, d = x.shape
    e = gate_w.shape[-1]
    n = b * s
    top_k = min(top_k, e)
    if impl == "grouped":
        return _moe_ffn_grouped(gate_w, w_in, b_in, w_out, b_out, x, top_k=top_k, rng=rng,
                                jitter=jitter)
    tokens = x.reshape(n, d)
    capacity = max(1, int(capacity_factor * top_k * n / e))
    gates, flat_slots, keeps, moh0, mpr, kept = _route(tokens, gate_w, top_k=top_k,
                                                       capacity=capacity, rng=rng, jitter=jitter)
    aux = e * torch.sum(moh0 * mpr)
    drop_frac = 1.0 - kept.float() / (n * top_k)
    xin = _dispatch(tokens, flat_slots, keeps, e, capacity)
    yout = _expert_ffn(xin.reshape(e, capacity, d), w_in, b_in, w_out, b_out)
    out = _combine(yout, flat_slots, keeps, gates, n)
    return out.reshape(b, s, d).to(x.dtype), aux, drop_frac


# ------------------------------------------------------ expert parallelism


class _MaskedRowGather(torch.autograd.Function):
    """``src[idx] * valid`` for an injective row map ``(idx, valid)``
    whose inverse ``(inv_idx, inv_valid)`` is given: the backward is the
    inverse masked gather, never a scatter."""

    @staticmethod
    def forward(ctx, src, idx, valid, inv_idx, inv_valid):
        ctx.save_for_backward(inv_idx, inv_valid)
        return src[idx] * valid[:, None].to(src.dtype)

    @staticmethod
    def backward(ctx, g):
        inv_idx, inv_valid = ctx.saved_tensors
        return g[inv_idx] * inv_valid[:, None].to(g.dtype), None, None, None, None


def _masked_row_gather(src, idx, valid, inv_idx, inv_valid):
    return _MaskedRowGather.apply(src, idx, valid, inv_idx, inv_valid)


def _capacity_slots_sorted(tokens, experts, top_k: int, e: int, capacity: int):
    """The [E*C, d] dispatch buffer built by sorted gathers: one stable
    sort of the (token, rank) pairs by expert gives both directions of
    the pair <-> slot map (a slot holds at most one kept pair; queue order
    is the sorted, token-major pair order). Returns (xin [E*C, d],
    pair_slot [n*k], pair_keep [n*k], slot_pair [E*C], slot_valid [E*C],
    kept count)."""
    n, d = tokens.shape
    nk = n * top_k
    eid, order, inv, sizes = _pair_sort(experts, e)
    offsets = torch.cumsum(sizes, 0) - sizes
    pos = inv - offsets[eid]                                          # queue position
    pair_keep = pos < capacity
    pair_slot = eid * capacity + torch.clamp(pos, 0, capacity - 1)
    cols = torch.arange(capacity, device=tokens.device)
    slot_valid = (cols[None, :] < sizes[:, None]).reshape(-1)
    slot_j = torch.clamp(offsets[:, None] + cols[None, :], 0, nk - 1).reshape(-1)
    slot_pair = order[slot_j]
    replicated = tokens[:, None, :].expand(n, top_k, d).reshape(nk, d)
    xin = _masked_row_gather(replicated, slot_pair, slot_valid, pair_slot, pair_keep)
    return xin, pair_slot, pair_keep, slot_pair, slot_valid, pair_keep.long().sum()


def moe_ffn_ep(gate_w, w_in, b_in, w_out, b_out, x, *, mesh, capacity_factor: float = 1.25,
               top_k: int = 1, rng=None, jitter: float = 1e-2, impl: str | None = None):
    """Expert-parallel MoE FFN of this rank's ``x`` [B, S, d] (its batch
    rows and, with ``context`` > 1, its sequence shard; replicated over
    ``model``) with router ``gate_w`` [d, E] and this rank's E/m experts
    ``w_in`` [E/m, d, ff], ``b_in`` [E/m, ff], ``w_out`` [E/m, ff, d],
    ``b_out`` [E/m, d]. Returns :func:`moe_ffn`'s triple; the aux loss
    and drop fraction are means over the ranks that route distinct
    tokens. ``impl`` applies to the single-program fallback only
    (``model`` 1, or E not divisible by it); the expert-parallel path is
    capacity-based. ``rng`` takes a ``fold`` keyword: the route axes'
    indices, folded in order into the router key (the reference's
    decorrelated jitter; ``core/rng.StepNoise.router_jitter``).

    Gradients follow the per-rank reading of replicated values: the
    token block and the router weights enter through ``copy_to`` (their
    cotangents are summed over ``model``), the outputs leave through
    ``gather_replicated``, and the router's mean probabilities are
    averaged over the route axes with a backward scaled by 1/m, the
    ``model`` split's share (the batch axes' mean is the trainer's
    gradient reduction)."""
    e = gate_w.shape[-1]
    m = 1 if mesh is None else mesh.axis_size(AxisNames.MODEL)
    if m <= 1 or e % m:
        return moe_ffn(gate_w, w_in, b_in, w_out, b_out, x, capacity_factor=capacity_factor,
                       top_k=top_k, rng=rng, jitter=jitter, impl=impl)
    top_k = min(top_k, e)
    b_loc, s_loc, d = x.shape
    all_tokens = x.reshape(-1, d)
    n_all = all_tokens.shape[0]
    split = n_all % m == 0
    token_axes = tuple(a for a in (*AxisNames.BATCH_AXES, AxisNames.CONTEXT)
                       if mesh.shape[a] > 1)
    if split:
        n_loc = n_all // m
        r = mesh.axis_index(AxisNames.MODEL)
        tokens = coll.copy_to(all_tokens, AxisNames.MODEL, mesh=mesh)[r * n_loc:(r + 1) * n_loc]
        gate_w = coll.copy_to(gate_w, AxisNames.MODEL, mesh=mesh)
        route_axes = (*token_axes, AxisNames.MODEL)
    else:
        n_loc, tokens, route_axes = n_all, all_tokens, token_axes
    capacity = max(1, int(capacity_factor * top_k * n_loc / e))
    if rng is not None:
        rng = functools.partial(rng, fold=tuple(mesh.axis_index(a) for a in route_axes))
    gates, experts, moh0, mpr = _router(tokens, gate_w, top_k=top_k, rng=rng, jitter=jitter)
    if route_axes:
        moh0 = coll.pmean(moh0, route_axes, mesh=mesh)
        mpr = coll.pmean_scaled(mpr, route_axes, mesh=mesh, scale=1.0 / m if split else 1.0)
    aux = e * torch.sum(moh0 * mpr)
    xin, pair_slot, pair_keep, slot_pair, slot_valid, kept = _capacity_slots_sorted(
        tokens, experts, top_k, e, capacity)
    drop = 1.0 - kept.float() / (n_loc * top_k)
    if route_axes:
        drop = coll.pmean(drop, route_axes, mesh=mesh)
    # [E*C, d] -> [m, E/m, C, d]: group g's slots go to rank g, which
    # receives [m (source), E/m, C, d] for its experts.
    recv = coll.all_to_all(xin.reshape(m, e // m, capacity, d), AxisNames.MODEL, mesh=mesh,
                           split_axis=0, concat_axis=0)
    buf = recv.transpose(0, 1).reshape(e // m, m * capacity, d)
    yloc = _expert_ffn(buf, w_in, b_in, w_out, b_out)
    yloc = yloc.reshape(e // m, m, capacity, d).transpose(0, 1).contiguous()
    yout = coll.all_to_all(yloc, AxisNames.MODEL, mesh=mesh, split_axis=0, concat_axis=0)
    yflat = yout.reshape(e * capacity, d).float()
    gat = torch.stack(gates, dim=1).reshape(-1)                          # [n_loc*k] f32
    y_pair = _masked_row_gather(yflat, pair_slot, pair_keep, slot_pair, slot_valid)
    out = (y_pair * gat[:, None]).reshape(n_loc, top_k, d).sum(dim=1).to(x.dtype)
    if split:
        out = coll.gather_replicated(out, AxisNames.MODEL, mesh=mesh, dim=0)
    return out.reshape(b_loc, s_loc, d), aux, drop
