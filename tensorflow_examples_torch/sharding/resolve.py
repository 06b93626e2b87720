"""Resolution: config + mesh + param template -> concrete placements;
the port of ``tensorflow_examples_tpu/sharding/resolve.py``.

* :func:`resolve_params`: the param-path -> spec table with per-device
  byte accounting and a stable **digest**, sha256 over the sorted
  ``path\\t{spec tuple}`` lines, the reference's exact bytes: the same
  rules over the same model hash alike in both packages and on every
  mesh shape, and a rules drift changes it.
* :func:`state_shardings`: the placement of a whole train state:
  params by the rules, optimizer moments inheriting their param's spec
  (matched by path suffix and shape), and the **ZeRO-1** escalation: a
  moment whose param is replicated is sharded over the batch axes
  (:func:`zero1_spec`).
* :func:`verify_digest_agreement`: every rank's digest allgathered at
  fit start; a rank that disagrees is named.

A template is a ``{name: tensor}`` dict of full-shape tensors (the meta
device does: only shapes and dtypes are read); a quantized weight
(``core/precision.QuantizedWeight``) resolves as the reference's two
children, ``<path>/q`` and ``<path>/scale``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Callable, Mapping

import numpy as np
import torch

from tensorflow_examples_torch.core.mesh import AxisNames
from tensorflow_examples_torch.core.precision import QuantizedWeight
from tensorflow_examples_torch.core.sharding import (ShardingRules, filter_spec, is_replicated,
                                                      param_path, shardings_for_params)


def _spec_device_count(spec: tuple, mesh) -> int:
    n = 1
    for entry in spec:
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        for a in axes:
            n *= int(mesh.shape[a])
    return n


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class ParamRow:
    """One resolved param: where it lives and what that costs."""

    path: str
    spec: tuple  # rule-resolved spec (mesh-shape independent)
    placed: tuple  # after size-1 axis filtering
    shape: tuple
    dtype: str
    global_bytes: int
    per_device_bytes: int

    @property
    def replicated(self) -> bool:
        return is_replicated(self.placed)


@dataclasses.dataclass(frozen=True)
class ResolvedSharding:
    """The full param placement for one (rules, mesh, template)."""

    mesh: Any
    rows: tuple

    def digest(self) -> str:
        """Stable hash of the logical placement (path -> unfiltered spec,
        sorted); independent of the mesh shape."""
        h = hashlib.sha256()
        for row in sorted(self.rows, key=lambda r: r.path):
            h.update(f"{row.path}\t{tuple(row.spec)}\n".encode())
        return h.hexdigest()[:16]

    def spec_by_path(self) -> dict[str, tuple]:
        return {row.path: tuple(row.spec) for row in self.rows}

    def byte_totals(self) -> dict[str, int]:
        """Global vs per-device bytes, split replicated vs sharded."""
        totals = {"global_bytes": 0, "per_device_bytes": 0, "replicated_per_device_bytes": 0,
                  "sharded_per_device_bytes": 0}
        for row in self.rows:
            totals["global_bytes"] += row.global_bytes
            totals["per_device_bytes"] += row.per_device_bytes
            key = "replicated_per_device_bytes" if row.replicated else "sharded_per_device_bytes"
            totals[key] += row.per_device_bytes
        return totals

    def table_str(self) -> str:
        """One row per param, widest first, per-device cost beside the
        global one."""
        rows = sorted(self.rows, key=lambda r: -r.global_bytes)
        width = max((len(r.path) for r in rows), default=4)
        lines = [f"{'param':<{width}}  {'shape':<18} {'spec':<28} "
                 f"{'global':>10} {'per-dev':>10}"]
        for r in rows:
            spec = "replicated" if r.replicated else str(tuple(r.placed))
            lines.append(f"{r.path:<{width}}  {str(r.shape):<18} {spec:<28} "
                         f"{_fmt_bytes(r.global_bytes):>10} {_fmt_bytes(r.per_device_bytes):>10}")
        t = self.byte_totals()
        lines.append(f"total: {_fmt_bytes(t['global_bytes'])} global, "
                     f"{_fmt_bytes(t['per_device_bytes'])}/device "
                     f"({_fmt_bytes(t['sharded_per_device_bytes'])} sharded + "
                     f"{_fmt_bytes(t['replicated_per_device_bytes'])} replicated)")
        return "\n".join(lines)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n:.1f}GiB"  # pragma: no cover - the loop always returns


def resolve_params(params_template: Mapping[str, torch.Tensor], mesh,
                   rules: ShardingRules) -> ResolvedSharding:
    """Resolve every parameter against the rules table, in the order of
    their paths (the reference's tree order)."""
    rows = []
    for name, leaf in sorted(params_template.items(), key=lambda kv: param_path(kv[0])):
        path = param_path(name)
        spec = rules.spec_for(path)
        if isinstance(leaf, QuantizedWeight):
            # Two rows under the weight's path, as the reference's pytree
            # children: the payload by the weight's spec, its row scale by
            # that spec clipped to the scale's rank.
            parts = ((f"{path}/q", spec, leaf.q),
                     (f"{path}/scale", spec[:leaf.scale.dim()], leaf.scale))
        else:
            parts = ((path, spec, leaf),)
        for row_path, row_spec, t in parts:
            placed = filter_spec(row_spec, mesh)
            shape = tuple(t.shape)
            gbytes = math.prod(shape) * t.element_size()
            rows.append(ParamRow(
                path=row_path, spec=row_spec, placed=placed, shape=shape,
                dtype=_dtype_name(t.dtype), global_bytes=gbytes,
                per_device_bytes=gbytes // max(_spec_device_count(placed, mesh), 1)))
    return ResolvedSharding(mesh=mesh, rows=tuple(rows))


def verify_digest_agreement(digest: str, *, allgather: Callable | None = None,
                            process_index: int | None = None,
                            process_count: int | None = None) -> None:
    """Fail fast when the ranks disagree on param placement: every rank
    allgathers its digest (8 bytes as int32s) and a mismatch raises
    :class:`~.config.ShardingMismatchError` naming the disagreeing
    rank(s) and both digests. One process returns at once."""
    from tensorflow_examples_torch.core import distributed

    if process_count is None:
        process_count = distributed.process_count()
    if process_count <= 1:
        return
    if process_index is None:
        process_index = distributed.process_index()
    local = np.frombuffer(bytes.fromhex(digest), np.uint8).astype(np.int32)
    matrix = np.asarray((allgather or distributed.allgather_host)(local), np.int32).reshape(
        process_count, local.size)
    mismatched = [(host, bytes(matrix[host].astype(np.uint8)).hex())
                  for host in range(process_count) if not np.array_equal(matrix[host], local)]
    if not mismatched:
        return
    from tensorflow_examples_torch.sharding.config import ShardingMismatchError

    shown = ", ".join(f"host {h}: {d}" for h, d in mismatched[:8])
    more = f" (and {len(mismatched) - 8} more)" if len(mismatched) > 8 else ""
    raise ShardingMismatchError(
        f"param-sharding digest disagrees across the fleet: host {process_index} resolved "
        f"{digest} but {shown}{more}. Every process must run the same rules/config - check "
        "for a stale sharding.json or drifted flags on the named host(s) before any "
        "checkpoint is touched.")


# ----------------------------------------------------------------- ZeRO-1


def zero1_spec(shape: tuple, mesh, batch_axes: tuple) -> tuple | None:
    """ZeRO-1 moment spec: the largest evenly divisible dim sharded over
    the batch axes; None when no dim divides (the moment stays
    replicated)."""
    n_batch = int(np.prod([mesh.shape[a] for a in batch_axes] or [1]))
    best = max((d for d in range(len(shape)) if shape[d] % n_batch == 0),
               key=lambda d: shape[d], default=None)
    if best is None or shape[best] < n_batch:
        return None
    spec = [None] * len(shape)
    # One axis is named alone, as a PartitionSpec normalizes it.
    spec[best] = batch_axes[0] if len(batch_axes) == 1 else tuple(batch_axes)
    return tuple(spec)


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over nested dicts/tuples/lists, paths
    ``/``-joined (the checkpoint's)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def state_shardings(params: Mapping[str, torch.Tensor], opt_state, mesh,
                    rules: ShardingRules, *, zero1: bool = False,
                    batch_axes: tuple = AxisNames.BATCH_AXES, model_state=None) -> dict:
    """Placed specs of a full-shape train state: ``{"params": {name:
    spec}, "opt_state": <opt_state's structure, a spec a leaf>,
    "model_state": ...}``; a leaf that matches no param is replicated
    (``()``)."""
    param_specs = shardings_for_params(params, mesh, rules)
    active_batch = tuple(a for a in batch_axes if mesh.shape[a] > 1)
    n_batch = int(np.prod([mesh.shape[a] for a in active_batch] or [1]))
    zero1 = zero1 and n_batch > 1

    def opt_spec(path, leaf):
        parts = path.split("/")
        for i in range(len(parts)):
            name = "/".join(parts[i:])
            if name in params and tuple(getattr(leaf, "shape", ())) == tuple(params[name].shape):
                spec = param_specs[name]
                if zero1 and is_replicated(spec) and len(leaf.shape):
                    z1 = zero1_spec(tuple(leaf.shape), mesh, active_batch)
                    if z1 is not None:
                        return z1
                return spec
        return ()

    model_specs = map_with_path(
        lambda path, leaf: filter_spec(rules.spec_for(path), mesh), model_state or {})
    return {"params": param_specs, "opt_state": map_with_path(opt_spec, opt_state),
            "model_state": model_specs}
