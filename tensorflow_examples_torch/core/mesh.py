"""Device mesh and axis conventions: the port of
``tensorflow_examples_tpu/core/mesh.py``.

The axes and their order are the reference's: ``data``, ``fsdp``,
``model``, ``context``, ``pipe``. Ranks lie on the mesh in row-major
order over that tuple (rank = the flat index of its coordinates), as
``create_mesh`` reshapes ``jax.devices()``; each process is one rank and
holds one device.

:class:`Mesh` gives each rank its coordinates and a process group for
every set of axes whose size is above 1: the ranks that share this
rank's coordinates on every other axis, ordered with the first axis
major (the order ``jax.lax`` collectives over a tuple of axes use, and
the order a sorted ``torch.distributed.new_group`` keeps, because ranks
are row-major). Every rank creates every group in the same order, as
``new_group`` requires. A one-process mesh has no groups.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch
import torch.distributed as dist

from tensorflow_examples_torch.core import distributed


class AxisNames:
    """Canonical mesh axis names."""

    DATA = "data"
    FSDP = "fsdp"
    MODEL = "model"
    CONTEXT = "context"
    PIPE = "pipe"

    ALL = (DATA, FSDP, MODEL, CONTEXT, PIPE)

    # The batch dimension of activations is sharded over every
    # batch-like axis.
    BATCH_AXES = (DATA, FSDP)


def token_partition_axes(mesh, batch_dim: int, seq_dim: int | None = None, *,
                         include_model: bool = False) -> tuple[tuple, tuple]:
    """``(batch_axes, seq_axes)`` for partitioning a ``[B, S, ...]``
    activation, the reference's policy: every nontrivial batch-like axis
    shards the batch dim (all dropped when their product does not divide
    it), ``context`` shards the seq dim when it divides, and with
    ``include_model`` ``model`` joins the seq sharding if it also
    divides. A dropped axis replicates the tokens over it."""
    batch_axes = tuple(a for a in AxisNames.BATCH_AXES if mesh.shape[a] > 1)
    nb = math.prod(mesh.shape[a] for a in batch_axes) if batch_axes else 1
    if batch_dim % nb:
        batch_axes = ()
    seq_axes: tuple = ()
    if seq_dim is not None:
        c = mesh.shape[AxisNames.CONTEXT]
        if c > 1 and seq_dim % c == 0:
            seq_axes += (AxisNames.CONTEXT,)
        if include_model:
            m = mesh.shape[AxisNames.MODEL]
            denom = (c if seq_axes else 1) * m
            if m > 1 and seq_dim % denom == 0:
                seq_axes += (AxisNames.MODEL,)
    return batch_axes, seq_axes


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. -1 for ``data`` means "all remaining ranks"."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    context: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int, int, int]:
        fixed = self.fsdp * self.model * self.context * self.pipe
        data = self.data
        if data == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"fsdp*model*context*pipe={fixed}"
                )
            data = n_devices // fixed
        total = data * fixed
        if total != n_devices:
            raise ValueError(
                f"mesh {data}x{self.fsdp}x{self.model}x{self.context}"
                f"x{self.pipe}={total} != available devices {n_devices}"
            )
        return (data, self.fsdp, self.model, self.context, self.pipe)


class Mesh:
    """This rank's view of the mesh: ``shape`` (axis -> size, in
    :data:`AxisNames.ALL` order), ``rank``, ``coords`` (axis -> index),
    ``device``, the process ``backend`` (None in one process) and a
    process group per set of nontrivial axes (:meth:`group`)."""

    def __init__(self, shape: tuple[int, ...], *, rank: int = 0,
                 device: torch.device | None = None):
        self.shape = dict(zip(AxisNames.ALL, (int(s) for s in shape)))
        self.size = math.prod(shape)
        self.rank = int(rank)
        self.device = device if device is not None else torch.device("cpu")
        self.ranks = np.arange(self.size).reshape(tuple(self.shape.values()))
        self.coords = dict(zip(AxisNames.ALL,
                               (int(i) for i in np.unravel_index(self.rank, self.ranks.shape))))
        self.backend = dist.get_backend() if self.size > 1 else None
        self._groups: dict[tuple, object] = {}
        self._members: dict[tuple, list[int]] = {}
        live = [a for a in AxisNames.ALL if self.shape[a] > 1]
        for n in range(1, len(live) + 1):
            for axes in itertools.combinations(live, n):
                self._make_groups(axes)

    def _make_groups(self, axes: tuple) -> None:
        """One group per fixed setting of the other axes; keep ours."""
        dims = [AxisNames.ALL.index(a) for a in axes]
        other = [d for d in range(len(AxisNames.ALL)) if d not in dims]
        moved = np.moveaxis(self.ranks, other + dims, list(range(len(AxisNames.ALL))))
        for members in moved.reshape(-1, math.prod(self.shape[a] for a in axes)):
            members = [int(r) for r in members]
            group = dist.new_group(members)
            if self.rank in members:
                self._groups[axes], self._members[axes] = group, members

    # ------------------------------------------------------------ views

    def axes(self, axis) -> tuple:
        """``axis`` (a name or a tuple of names) as a canonical tuple of
        the nontrivial ones."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = set(names) - set(AxisNames.ALL)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}")
        return tuple(a for a in AxisNames.ALL if a in names and self.shape[a] > 1)

    def axis_size(self, axis) -> int:
        return math.prod(self.shape[a] for a in self.axes(axis))

    def axis_index(self, axis, rank: int | None = None) -> int:
        """This rank's (or ``rank``'s) index along ``axis`` (a tuple:
        first axis major)."""
        coords = self.coords if rank is None else dict(zip(
            AxisNames.ALL, (int(i) for i in np.unravel_index(rank, self.ranks.shape))))
        index = 0
        for a in self.axes(axis):
            index = index * self.shape[a] + coords[a]
        return index

    def group(self, axis):
        """The process group over ``axis`` (None when its size is 1)."""
        return self._groups.get(self.axes(axis))

    def members(self, axis) -> list[int]:
        """Global ranks of the group over ``axis``, in axis order."""
        return self._members.get(self.axes(axis), [self.rank])

    @property
    def trivial(self) -> bool:
        return self.size == 1

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def create_mesh(config: MeshConfig | None = None, *,
                device: torch.device | None = None) -> Mesh:
    """The framework-standard 5-axis mesh over the process group's ranks
    (one rank when no group is up)."""
    config = config or MeshConfig()
    shape = config.resolve(distributed.process_count())
    return Mesh(shape, rank=distributed.process_index(), device=device)


def local_batch_size(global_batch_size: int, mesh: Mesh) -> int:
    """Rows of the global batch that this rank feeds (one device a
    process: one batch shard)."""
    n_batch = math.prod(mesh.shape[a] for a in AxisNames.BATCH_AXES)
    if global_batch_size % n_batch:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by batch mesh size {n_batch}"
        )
    per_shard = global_batch_size // n_batch
    local_shards = max(1, n_batch // distributed.process_count())
    return per_shard * local_shards
