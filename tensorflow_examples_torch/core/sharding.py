"""Rules-based parameter sharding: the port of
``tensorflow_examples_tpu/core/sharding.py``.

A spec is a tuple with one entry per leading tensor dimension: ``None``
(replicated), an axis name, or a tuple of axis names (first axis major),
the tuple a ``jax.sharding.PartitionSpec`` holds; dimensions past its
length are replicated. Each model ships a table of ``(param-path regex
-> spec)`` rules, first match wins, matched against the reference's
``/``-joined param path (``h_3/attn/qkv/kernel``: the port's parameter
name with ``/`` for ``.``); unmatched parameters are replicated.

A parameter lives on each rank as a plain local shard, a contiguous
tensor: :func:`shard` cuts this rank's piece of a full tensor
(:func:`shard_params` of a whole dict, quantized weights included),
:func:`unshard` gathers the pieces back (the checkpoint's save path),
and :func:`shard_shape` gives a shard's shape. Axes of size 1 are
dropped first (:func:`filter_spec`), so one table serves every mesh.
"""

from __future__ import annotations

import re
from typing import Sequence

import torch

from tensorflow_examples_torch.core import collectives as coll
from tensorflow_examples_torch.core.mesh import AxisNames
from tensorflow_examples_torch.core.precision import QuantizedWeight

Spec = tuple


class ShardingRules:
    """Ordered (regex, spec) table; first match wins."""

    def __init__(self, rules: Sequence[tuple[str, Spec]] = ()):
        self.rules = [(re.compile(pat), tuple(spec)) for pat, spec in rules]

    def spec_for(self, path: str) -> Spec:
        for pat, spec in self.rules:
            if pat.search(path):
                return spec
        return ()  # replicate

    def __add__(self, other: "ShardingRules") -> "ShardingRules":
        out = ShardingRules()
        out.rules = list(self.rules) + list(other.rules)
        return out


REPLICATED = ShardingRules()


def param_path(name: str) -> str:
    """The reference's param path of a port parameter name."""
    return name.replace(".", "/")


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def filter_spec(spec: Spec, mesh) -> Spec:
    """Drop mesh axes of size 1 from a spec (same math, cheaper layout)."""

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if mesh.shape[a] > 1)
            return kept if kept else None
        return entry if mesh.shape[entry] > 1 else None

    return tuple(keep(e) for e in spec)


def spec_axes(spec: Spec) -> tuple:
    """Every mesh axis a spec shards over, in canonical order."""
    named = {a for e in spec for a in _entry_axes(e)}
    return tuple(a for a in AxisNames.ALL if a in named)


def is_replicated(spec: Spec) -> bool:
    return all(e is None for e in spec)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple[int, ...]:
    """The local shard's shape of a ``shape`` tensor under ``spec``."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = mesh.axis_size(_entry_axes(entry)) if _entry_axes(entry) else 1
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide by the {n} shards "
                             f"of {entry!r}")
        out[dim] //= n
    return tuple(out)


def shard(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's contiguous piece of ``full`` under ``spec``."""
    local_shape = shard_shape(full.shape, spec, mesh)
    out = full
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes and mesh.axis_size(axes) > 1:
            size = local_shape[dim]
            out = out.narrow(dim, mesh.axis_index(axes) * size, size)
    return out.contiguous() if out is not full else full


def shard_params(params, mesh, rules: ShardingRules | None = None) -> dict:
    """``{name: this rank's piece}`` of a ``{name: full leaf}`` dict under
    the rules (the reference's ``shard_params``, per rank). A
    ``core/precision.QuantizedWeight``'s payload takes the weight's spec
    and its row scale (one dim fewer, over the payload's last axis) the
    spec clipped to its rank, the reference's rule."""
    out = {}
    for name, spec in shardings_for_params(params, mesh, rules).items():
        leaf = params[name]
        if isinstance(leaf, QuantizedWeight):
            out[name] = QuantizedWeight(shard(leaf.q, spec, mesh),
                                        shard(leaf.scale, spec[:leaf.scale.dim()], mesh))
        else:
            out[name] = shard(leaf, spec, mesh)
    return out


def unshard(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full tensor gathered from every rank's piece (a collective
    over the spec's axes; not differentiated)."""
    out = local
    with torch.no_grad():
        for dim, entry in enumerate(spec):
            axes = _entry_axes(entry)
            if axes and mesh.axis_size(axes) > 1:
                out = coll._all_gather(out, axes, mesh, dim)
    return out


def shardings_for_params(params, mesh, rules: ShardingRules | None = None) -> dict:
    """``{name: placed spec}`` of a ``{name: tensor}`` dict under the
    rules (unmatched: replicated), size-1 axes filtered."""
    rules = rules or REPLICATED
    return {name: filter_spec(rules.spec_for(param_path(name)), mesh) for name in params}


def batch_spec(mesh, axes=AxisNames.BATCH_AXES) -> Spec:
    """The spec of a [global_batch, ...] array: batch over the given
    batch-like axes, size-1 axes filtered (``batch_sharding``)."""
    kept = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    return (kept if kept else None,)


def batch_rows(batch_size: int, mesh, axes=AxisNames.BATCH_AXES) -> slice:
    """This rank's rows of a global batch, in the order ``batch_spec``
    lays them out."""
    kept = batch_spec(mesh, axes)[0]
    if kept is None:
        return slice(0, batch_size)
    n = mesh.axis_size(kept)
    if batch_size % n:
        raise ValueError(f"batch {batch_size} not divisible by the {n} batch shards")
    per = batch_size // n
    i = mesh.axis_index(kept)
    return slice(i * per, (i + 1) * per)
