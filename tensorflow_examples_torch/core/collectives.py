"""Collectives over one mesh axis: the port of
``tensorflow_examples_tpu/core/collectives.py``.

Every function takes the calling rank's local tensor, a mesh axis (a
name or a tuple of names, first axis major) and the :class:`Mesh`, and
runs on the process group of that axis (``core/mesh.Mesh.group``); over
an axis of size 1 each is the identity. ``shard_map`` has no port: each
process already runs the per-rank program that a ``shard_map`` body is.

The differentiable ones carry the reference's transposes under the
per-rank reading of ``shard_map``: a value that the code computes alike
on every rank of an axis is *replicated* there, and each rank's
cotangent of it is already the whole one.

* :func:`psum`: all-reduce sum of partial results into a replicated
  value (a row-parallel matmul's output, the vocab-parallel logsumexp);
  its backward is the identity. :func:`copy_to` is its mirror, for a
  replicated value that enters per-shard work (a column-parallel
  matmul's input): identity forward, ``psum`` backward.
* :func:`all_gather` (tiled along ``dim``) and :func:`reduce_scatter`
  transpose into each other: FSDP's gather of a weight before use and
  the reduce-scatter of its gradient after.
* :func:`ppermute` (``batch_isend_irecv``) transposes into the inverse
  permutation, :func:`all_to_all` (``all_to_all_single``) into the
  swapped exchange. Each takes several tensors and moves them in one
  call, so a rank's backward meets the same collectives in the same
  order as its peers'.
* :func:`gather_replicated` is the tiled all-gather of per-shard work
  into a replicated value (expert parallelism's combined outputs): its
  backward keeps this rank's slice of the (whole) cotangent.
* :func:`pmax` and :func:`pmean` are not differentiated (a stabilizer,
  metrics); :func:`pmean_scaled` is a mean whose backward scales the
  cotangent by a given factor (the expert-parallel router's statistics).
* :func:`point_to_point` posts table-driven sends and receives (the 1F1B
  schedule's hops); it is not differentiated.

The backend is read here and nowhere else: on ``gloo`` every operand on
a CUDA device is copied through a pinned host buffer, for every
collective (gloo runs only part of its collectives on CUDA memory), and
the result copied back. That route is chosen by the backend, never taken
after a failure. On ``nccl`` the CUDA tensors are passed as they are.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

AxisName = str | Sequence[str]

_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


def _staged(mesh) -> bool:
    return mesh.backend == "gloo"


def _host(t: torch.Tensor, staged: bool) -> torch.Tensor:
    """The operand a collective reads: a pinned host copy of a CUDA
    tensor under gloo, else the contiguous tensor itself."""
    t = t.contiguous()
    if staged and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t


def _back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(like.device) if t.device != like.device else t


def _out(shape, like: torch.Tensor, staged: bool) -> torch.Tensor:
    if staged and like.is_cuda:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


# ------------------------------------------------------------- raw ops


def _all_reduce(x: torch.Tensor, axis, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    buf = _host(x, _staged(mesh))
    if buf is x or buf.data_ptr() == x.data_ptr():
        buf = buf.clone()
    dist.all_reduce(buf, op=op, group=group)
    return _back(buf, x)


def _all_gather(x: torch.Tensor, axis, mesh, dim: int) -> torch.Tensor:
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    n, staged = mesh.axis_size(axis), _staged(mesh)
    moved = x.movedim(dim, 0)
    src = _host(moved, staged)
    out = _out((n * src.shape[0], *src.shape[1:]), x, staged)
    _gather_single(out, src, group=group)
    return _back(out, x).movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, axis, mesh, dim: int) -> torch.Tensor:
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    n, staged = mesh.axis_size(axis), _staged(mesh)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not divide by {n}")
    src = _host(x.movedim(dim, 0), staged)
    out = _out((src.shape[0] // n, *src.shape[1:]), x, staged)
    _reduce_scatter_single(out, src, group=group)
    return _back(out, x).movedim(0, dim).contiguous()


def _permute(xs: Sequence[torch.Tensor], axis, mesh, sends: Sequence[int],
             recvs: Sequence[int]) -> list[torch.Tensor]:
    """Send ``xs[i]`` to axis index ``sends[i]`` and receive output i
    (same shape) from axis index ``recvs[i]``; a rank sending to itself
    keeps its tensor."""
    members, me, group = mesh.members(axis), mesh.axis_index(axis), mesh.group(axis)
    staged = _staged(mesh)
    ops, outs = [], []
    for x, dst, src in zip(xs, sends, recvs):
        if dst == me and src == me:
            outs.append(x.clone())
            continue
        recv = _out(x.shape, x, staged)
        ops.append(dist.P2POp(dist.isend, _host(x, staged), members[dst], group=group))
        ops.append(dist.P2POp(dist.irecv, recv, members[src], group=group))
        outs.append(recv)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [_back(o, x) for o, x in zip(outs, xs)]


def point_to_point(ops: Sequence[tuple], axis, *, mesh) -> list[torch.Tensor]:
    """Sends and receives on the axis' group, posted in one batch in the
    order given; not differentiated. Each op is ``("send", tensor,
    peer)`` or ``("recv", like, peer)`` (``like``: a tensor of the
    shape and dtype that arrives), ``peer`` an axis index. Returns the
    received tensors, in order. Both sides of a pair must post it, and
    two messages between one pair in one direction pair up in posting
    order (the 1F1B schedule's table-driven hops)."""
    members, group, staged = mesh.members(axis), mesh.group(axis), _staged(mesh)
    posted, outs = [], []
    for kind, t, peer in ops:
        if kind == "send":
            posted.append(dist.P2POp(dist.isend, _host(t, staged), members[peer], group=group))
        else:
            recv = _out(t.shape, t, staged)
            posted.append(dist.P2POp(dist.irecv, recv, members[peer], group=group))
            outs.append((recv, t))
    if posted:
        for work in dist.batch_isend_irecv(posted):
            work.wait()
    return [_back(o, like) for o, like in outs]


def _all_to_all(x: torch.Tensor, axis, mesh, split_axis: int, concat_axis: int) -> torch.Tensor:
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    n, staged = mesh.axis_size(axis), _staged(mesh)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} does not divide "
                         f"by {n}")
    # Chunk j of split_axis goes to rank j; chunk i of the output came
    # from rank i and is concatenated along concat_axis.
    chunks = x.reshape(*x.shape[:split_axis], n, x.shape[split_axis] // n,
                       *x.shape[split_axis + 1:]).movedim(split_axis, 0)
    src = _host(chunks, staged)
    out = _out(src.shape, x, staged)
    dist.all_to_all_single(out, src, group=group)
    # [n, ...chunk], leading dim = source rank: put it just before
    # concat_axis and merge the two, source rank major.
    out = _back(out, x).movedim(0, concat_axis)
    shape = list(out.shape)
    merged = shape[:concat_axis] + [shape[concat_axis] * shape[concat_axis + 1]]
    return out.reshape(merged + shape[concat_axis + 2:]).contiguous()


# ---------------------------------------------------------- autograd


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return _all_reduce(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.args = (axis, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, *ctx.args), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = (axis, mesh, dim)
        return _all_gather(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = (axis, mesh, dim)
        return _reduce_scatter(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, mesh, sends, recvs, *xs):
        ctx.args = (axis, mesh, sends, recvs)
        return tuple(_permute(xs, axis, mesh, sends, recvs))

    @staticmethod
    def backward(ctx, *gs):
        axis, mesh, sends, recvs = ctx.args
        return (None, None, None, None, *_permute(gs, axis, mesh, recvs, sends))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, split_axis, concat_axis):
        ctx.args = (axis, mesh, split_axis, concat_axis)
        return _all_to_all(x, axis, mesh, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis, mesh, split_axis, concat_axis = ctx.args
        return _all_to_all(g, axis, mesh, concat_axis, split_axis), None, None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = (mesh.axis_index(axis), x.shape[dim], dim)
        return _all_gather(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        i, size, dim = ctx.args
        return g.narrow(dim, i * size, size).contiguous(), None, None, None


class _PmeanScaled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, scale):
        ctx.scale = scale
        return _all_reduce(x, axis, mesh) / mesh.axis_size(axis)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None, None


class _Depend(torch.autograd.Function):
    """``x`` unchanged, with ``deps`` in its backward graph (zero
    cotangents): keeps a collective whose outputs this rank does not
    otherwise use in the backward its peers run."""

    @staticmethod
    def forward(ctx, x, *deps):
        ctx.shapes = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=t, device=d) for s, t, d in ctx.shapes))


# ------------------------------------------------------------ public api


def psum(x: torch.Tensor, axis: AxisName, *, mesh) -> torch.Tensor:
    """All-reduce sum into a replicated value (backward: identity)."""
    return _Psum.apply(x, axis, mesh) if mesh.group(axis) is not None else x


def copy_to(x: torch.Tensor, axis: AxisName, *, mesh) -> torch.Tensor:
    """A replicated value entering per-shard work (backward: psum)."""
    return _CopyTo.apply(x, axis, mesh) if mesh.group(axis) is not None else x


@torch.no_grad()
def pmean(x: torch.Tensor, axis: AxisName, *, mesh) -> torch.Tensor:
    """All-reduce mean (metrics); not differentiated."""
    if mesh.group(axis) is None:
        return x
    return _all_reduce(x, axis, mesh) / mesh.axis_size(axis)


@torch.no_grad()
def pmax(x: torch.Tensor, axis: AxisName, *, mesh) -> torch.Tensor:
    """All-reduce max; not differentiated (the vocab-parallel CE's
    stabilizer, as the reference's ``stop_gradient``)."""
    if mesh.group(axis) is None:
        return x.detach()
    return _all_reduce(x.detach(), axis, mesh, op=dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, axis: AxisName, *, mesh, dim: int = 0) -> torch.Tensor:
    """Concatenate the axis' shards along ``dim`` (backward:
    reduce-scatter)."""
    return _AllGather.apply(x, axis, mesh, dim) if mesh.group(axis) is not None else x


def gather_replicated(x: torch.Tensor, axis: AxisName, *, mesh, dim: int = 0) -> torch.Tensor:
    """Concatenate the axis' shards along ``dim`` into a value every rank
    then computes alike (backward: this rank's slice of the cotangent,
    which each rank already holds whole)."""
    return _GatherReplicated.apply(x, axis, mesh, dim) if mesh.group(axis) is not None else x


def pmean_scaled(x: torch.Tensor, axis: AxisName, *, mesh, scale: float) -> torch.Tensor:
    """All-reduce mean whose backward is the cotangent times ``scale``."""
    return _PmeanScaled.apply(x, axis, mesh, scale) if mesh.group(axis) is not None else x


def reduce_scatter(x: torch.Tensor, axis: AxisName, *, mesh, dim: int = 0) -> torch.Tensor:
    """Sum over the axis, keep this rank's ``dim`` shard (backward:
    all-gather)."""
    return _ReduceScatter.apply(x, axis, mesh, dim) if mesh.group(axis) is not None else x


def ppermute(xs: Sequence[torch.Tensor], axis: AxisName, *, mesh,
             perm: Sequence[tuple[int, int]]) -> tuple[torch.Tensor, ...]:
    """Move each tensor of ``xs`` along ``perm``'s ``(source,
    destination)`` pairs (axis indices; a bijection) in one exchange."""
    if mesh.group(axis) is None:
        return tuple(xs)
    me = mesh.axis_index(axis)
    dst = dict(perm)[me]
    src = {d: s for s, d in perm}[me]
    return _Permute.apply(axis, mesh, (dst,) * len(xs), (src,) * len(xs), *xs)


def exchange(xs: Sequence[torch.Tensor], axis: AxisName, *, mesh,
             perms: Sequence[Sequence[tuple[int, int]]]) -> tuple[torch.Tensor, ...]:
    """``xs[i]`` moved along ``perms[i]``, all in one exchange (the
    zigzag re-layout's two half-shard permutations)."""
    if mesh.group(axis) is None:
        return tuple(xs)
    me = mesh.axis_index(axis)
    sends = tuple(dict(p)[me] for p in perms)
    recvs = tuple({d: s for s, d in p}[me] for p in perms)
    return _Permute.apply(axis, mesh, sends, recvs, *xs)


def ring_perm(axis_size: int) -> list[tuple[int, int]]:
    """The (i -> i+1 mod n) permutation: one ring hop."""
    return [(i, (i + 1) % axis_size) for i in range(axis_size)]


def all_to_all(x: torch.Tensor, axis: AxisName, *, mesh, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Split ``split_axis`` over the axis' ranks and concatenate what
    arrives along ``concat_axis`` (tiled), as ``lax.all_to_all``."""
    if mesh.group(axis) is None:
        return x
    return _AllToAll.apply(x, axis, mesh, split_axis, concat_axis)


def depend(x: torch.Tensor, *deps: torch.Tensor) -> torch.Tensor:
    """``x``, with ``deps`` kept in its backward graph (see
    :class:`_Depend`)."""
    return _Depend.apply(x, *deps) if deps else x


def axis_index(axis: AxisName, *, mesh) -> int:
    """This rank's coordinate along the mesh axis."""
    return mesh.axis_index(axis)


def axis_size(axis: AxisName, *, mesh) -> int:
    """Number of shards along the mesh axis."""
    return mesh.axis_size(axis)
