"""Where each leaf of a train state lives on this rank, and the per-rank
work a mesh adds to a training step.

The reference places a global array by its ``NamedSharding`` and XLA
writes the collectives. A rank of the port holds plain local shards
(``core/sharding.py``), and :class:`StateLayout` does that work:

* parameters are cut by the rules (``spec_for``); FSDP-sharded ones are
  gathered where a step reads them (:meth:`gathered`: a mapping whose
  lookups run ``collectives.all_gather``, whose backward reduce-scatters
  the gradient over ``fsdp``);
* :meth:`reduce_grads` turns each rank's gradients into the mean over
  the axes that split the batch and the sequence (``data``, ``fsdp``,
  ``context``): an all-reduce over the ones the parameter is not split
  on, gradients of one group in one flat buffer; ``model`` needs none
  (the forward's ``copy_to``/``psum`` pairs leave a replicated
  parameter's gradient whole on every ``model`` rank);
* **ZeRO-1**: a replicated parameter's optimizer moments are cut over
  the batch axes on the dim :func:`~.resolve.zero1_spec` picks. Its
  gradient is reduce-scattered to this rank's piece, the optimizer
  updates that piece of the parameter (:meth:`opt_view`) and the new
  pieces are all-gathered (:meth:`from_opt_view`);
* :meth:`global_sumsq` sums squares across the ranks that hold a
  tensor's pieces (``optimizers.sharded_norms``);
* :meth:`gather_state` / :meth:`cut_state`: whole tensors for a
  checkpoint and this rank's pieces of them, for any mesh shape.
"""

from __future__ import annotations

import math
from typing import Iterator, Mapping

import torch

from tensorflow_examples_torch.core import collectives as coll
from tensorflow_examples_torch.core.mesh import AxisNames
from tensorflow_examples_torch.core.sharding import (ShardingRules, is_replicated, shard,
                                                      shard_shape, shardings_for_params,
                                                      spec_axes, unshard)
from tensorflow_examples_torch.sharding.resolve import state_shardings, zero1_spec
from tensorflow_examples_torch.train import optimizers


class _Gathered(Mapping):
    """``{name: tensor}`` whose FSDP-sharded entries are gathered over
    ``fsdp`` (differentiably) when looked up: a layer's weights arrive
    just before use, and a recomputed block gathers them again."""

    def __init__(self, params: Mapping[str, torch.Tensor], layout: "StateLayout"):
        self._params, self._layout = params, layout

    def __getitem__(self, name: str) -> torch.Tensor:
        t = self._params[name]
        for dim, entry in enumerate(self._layout.param_specs[name]):
            if entry == AxisNames.FSDP:
                t = coll.all_gather(t, AxisNames.FSDP, mesh=self._layout.mesh, dim=dim)
        return t

    def __iter__(self) -> Iterator[str]:
        return iter(self._params)

    def __len__(self) -> int:
        return len(self._params)


class StateLayout:
    """The placement of a train state on ``mesh``: ``full_params`` is a
    ``{name: tensor}`` template at full shape (the meta device does),
    ``tx`` the optimizer, whose state's leaves follow their params."""

    def __init__(self, mesh, rules: ShardingRules, full_params: Mapping[str, torch.Tensor],
                 tx: optimizers.GradientTransformation, *, zero1: bool = False,
                 batch_axes: tuple = AxisNames.BATCH_AXES):
        self.mesh = mesh
        self.batch_axes = tuple(a for a in batch_axes if mesh.shape[a] > 1)
        # Gradients are means over the axes that split the batch and sequence.
        self.grad_axes = self.batch_axes + tuple(
            a for a in (AxisNames.CONTEXT,) if mesh.shape[a] > 1)
        self.n_grad = math.prod(mesh.shape[a] for a in self.grad_axes)
        self.full_shapes = {n: tuple(t.shape) for n, t in full_params.items()}
        self.param_specs = shardings_for_params(full_params, mesh, rules)
        for name, spec in self.param_specs.items():
            for entry in spec:
                if AxisNames.FSDP in ((entry,) if isinstance(entry, str) else (entry or ())) \
                        and entry != AxisNames.FSDP:
                    raise ValueError(f"{name}: fsdp must shard a dim alone, got {spec}")
            shard_shape(self.full_shapes[name], spec, mesh)  # raises unless each dim divides
        n_batch = math.prod(mesh.shape[a] for a in self.batch_axes)
        self.zero1 = zero1 and n_batch > 1
        self.zero1_specs = {
            name: zero1_spec(shape, mesh, self.batch_axes)
            if self.zero1 and is_replicated(self.param_specs[name]) and shape else None
            for name, shape in self.full_shapes.items()}
        meta = {n: torch.empty(s, device="meta") for n, s in self.full_shapes.items()}
        self.specs = state_shardings(meta, tx.init(meta), mesh, rules, zero1=self.zero1,
                                     batch_axes=self.batch_axes)
        if tx.whole_tensors and any(not is_replicated(s) for s in self.opt_view_specs().values()):
            raise ValueError("this optimizer reads whole-tensor norms (LARS), which a rank "
                             "holding a shard cannot compute: run it on data/context meshes "
                             "without zero1")

    # ------------------------------------------------------------ views

    def opt_view_specs(self) -> dict[str, tuple]:
        """Each parameter's spec as the optimizer holds it."""
        return {n: self.zero1_specs[n] or self.param_specs[n] for n in self.param_specs}

    def shard_params(self, full: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return {n: shard(t, self.param_specs[n], self.mesh) for n, t in full.items()}

    def gathered(self, params: Mapping[str, torch.Tensor]) -> Mapping[str, torch.Tensor]:
        """What a step reads: ``params`` with FSDP pieces gathered on use."""
        if not any(AxisNames.FSDP in s for s in self.param_specs.values()):
            return params
        return _Gathered(params, self)

    def _zero1_dim(self, name: str) -> int:
        return next(d for d, e in enumerate(self.zero1_specs[name]) if e is not None)

    def opt_view(self, params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """This rank's ZeRO-1 pieces of the replicated parameters, the
        others as they are."""
        return {n: shard(p, self.zero1_specs[n], self.mesh) if self.zero1_specs[n] else p
                for n, p in params.items()}

    def from_opt_view(self, pieces: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Local parameters from their optimizer views (ZeRO-1 pieces
        all-gathered)."""
        return {n: coll._all_gather(p, self.batch_axes, self.mesh, self._zero1_dim(n))
                if self.zero1_specs[n] else p for n, p in pieces.items()}

    # ------------------------------------------------------------ steps

    def reduce_grads(self, grads: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Each rank's gradients -> the mean over the batch and sequence
        axes, as the optimizer holds them (ZeRO-1: this rank's piece)."""
        out: dict[str, torch.Tensor] = {}
        buckets: dict[tuple, list[str]] = {}
        for name, g in grads.items():
            axes = tuple(a for a in self.grad_axes if a not in spec_axes(self.param_specs[name]))
            if self.zero1_specs[name]:
                g = coll._reduce_scatter(g, self.batch_axes, self.mesh, self._zero1_dim(name))
                axes = tuple(a for a in axes if a not in self.batch_axes)
            out[name] = g
            buckets.setdefault((axes, g.dtype), []).append(name)
        for (axes, _), names in buckets.items():
            if axes:
                flat = coll._all_reduce(torch.cat([out[n].reshape(-1) for n in names]), axes,
                                        self.mesh)
                for n, piece in zip(names, torch.split(flat, [out[n].numel() for n in names])):
                    out[n] = piece.view_as(out[n])
        if self.n_grad > 1:
            out = {n: g / self.n_grad for n, g in out.items()}
        return out

    def global_sumsq(self, sumsq: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The sum over every tensor's pieces of ``sumsq`` (this rank's
        sums of squares of its optimizer-view pieces)."""
        specs = self.opt_view_specs()
        groups: dict[tuple, torch.Tensor] = {}
        for name, v in sumsq.items():
            axes = spec_axes(specs[name])
            groups[axes] = groups[axes] + v if axes in groups else v
        total = None
        for axes, v in groups.items():
            v = coll._all_reduce(v, axes, self.mesh) if axes else v
            total = v if total is None else total + v
        return total

    def mean_metric(self, x: torch.Tensor) -> torch.Tensor:
        """A per-rank mean (loss, metrics) -> the global mean."""
        return coll.pmean(x, self.grad_axes, mesh=self.mesh) if self.grad_axes else x

    # ------------------------------------------------------ checkpoints

    def _leaf_specs(self, part: str):
        return self.specs[part] if part != "params" else self.param_specs

    def gather_state(self, parts: Mapping) -> dict:
        """``{"params", "opt_state", "model_state"}`` of local pieces ->
        whole tensors (a collective over every rank)."""
        out = {}
        for part, tree in parts.items():
            specs = self._leaf_specs(part)
            out[part] = _map2(lambda t, s: unshard(t, s, self.mesh) if torch.is_tensor(t) and s
                              else t, tree, specs)
        return out

    def cut_state(self, parts: Mapping) -> dict:
        """Whole tensors -> this rank's pieces (the inverse of
        :meth:`gather_state`, on any mesh)."""
        out = {}
        for part, tree in parts.items():
            specs = self._leaf_specs(part)
            out[part] = _map2(lambda t, s: shard(t, s, self.mesh) if torch.is_tensor(t) and s
                              else t, tree, specs)
        return out

    def full_template(self, parts: Mapping) -> dict:
        """Meta tensors of the whole shapes and dtypes of ``parts``' local
        pieces (what a checkpoint is checked against)."""

        def whole(t, s):
            if not torch.is_tensor(t):
                return t
            shape = [n * self.mesh.axis_size(e if isinstance(e, tuple) else (e,)) if e else n
                     for n, e in zip(t.shape, tuple(s) + (None,) * (t.dim() - len(s)))]
            return torch.empty(shape, dtype=t.dtype, device="meta")

        return {part: _map2(whole, tree, self._leaf_specs(part))
                for part, tree in parts.items()}

    def pieces(self, parts: Mapping) -> dict:
        """How many pieces each leaf of ``parts`` is cut into on this mesh
        (1: whole on every rank): ``telemetry/memory.tree_bytes``'s
        ``pieces`` for the global byte count."""
        return {part: _map2(lambda t, s: self.mesh.axis_size(spec_axes(s)) if s else 1, tree,
                            self._leaf_specs(part)) for part, tree in parts.items()}


def _map2(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and its spec tree (a missing spec
    is replicated)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs.get(k, ()) if isinstance(specs, dict) else ())
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map2(fn, v, specs[i] if isinstance(specs, (tuple, list)) else ())
                          for i, v in enumerate(tree))
    return fn(tree, specs if isinstance(specs, tuple) else ())

