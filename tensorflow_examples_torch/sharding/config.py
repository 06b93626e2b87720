"""ShardingConfig: the one serializable placement spec, the port of
``tensorflow_examples_tpu/sharding/config.py``.

Four decisions, JSON-serializable in the reference's schema (a
``sharding.json`` written by either package loads in the other):

* ``mesh``: axis -> size over ``core/mesh.AxisNames`` (``data: -1``
  means "all remaining ranks"; absent axes are 1);
* ``rules``: the (param-path regex -> spec) table as ``[pattern,
  spec]`` pairs, a spec entry ``null`` / an axis / a list of axes; empty
  rules inherit the task's table;
* ``batch_axes``: the mesh axes that shard the batch dim;
* ``zero1``: ZeRO-1, the optimizer moments of replicated parameters
  sharded over the batch axes (``train/loop.py``).

``build_mesh`` builds the mesh over the process group's ranks, which
must equal the config's product (one rank a device; the reference takes
the first devices of a larger host, a process cannot).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping, Sequence

from tensorflow_examples_torch.core import distributed
from tensorflow_examples_torch.core.mesh import AxisNames, MeshConfig, create_mesh
from tensorflow_examples_torch.core.sharding import ShardingRules

# The on-disk format version of sharding.json (NOT the telemetry schema).
SHARDING_JSON_VERSION = 1


class ShardingMismatchError(ValueError):
    """A checkpoint's saved sharding config is incompatible with the live
    one: different rules resolve params to different specs. Mesh shape
    differences are legal (restore reshards); rule drift is not, and this
    error names the drifted param paths."""


def spec_to_json(spec: Sequence) -> list:
    """Spec -> JSON list: entry = None | axis | [axes...]."""
    return [e if e is None or isinstance(e, str) else [str(a) for a in e] for e in spec]


def spec_from_json(entries: Sequence) -> tuple:
    """Inverse of :func:`spec_to_json` (lists become axis tuples)."""
    return tuple(e if e is None or isinstance(e, str) else tuple(str(a) for a in e)
                 for e in entries)


def rules_to_json(rules: ShardingRules) -> list[list]:
    """A ShardingRules table -> [[pattern, spec-json], ...]."""
    return [[pat.pattern, spec_to_json(spec)] for pat, spec in rules.rules]


def rules_from_json(entries: Sequence[Sequence]) -> ShardingRules:
    return ShardingRules([(str(pat), spec_from_json(spec)) for pat, spec in entries])


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Serializable placement spec shared by training and checkpoints."""

    mesh: Mapping[str, int] = dataclasses.field(default_factory=lambda: {"data": -1})
    rules: tuple = ()  # [(pattern, spec-json entries)]; () inherits the task's table
    batch_axes: tuple = AxisNames.BATCH_AXES
    zero1: bool = False

    def __post_init__(self):
        unknown = set(self.mesh) - set(AxisNames.ALL)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; canonical axes are "
                             f"{list(AxisNames.ALL)}")
        bad_batch = set(self.batch_axes) - set(AxisNames.ALL)
        if bad_batch:
            raise ValueError(f"unknown batch axes {sorted(bad_batch)}; canonical axes "
                             f"are {list(AxisNames.ALL)}")
        for axis, size in self.mesh.items():
            if axis == AxisNames.DATA and size == -1:
                continue
            if not isinstance(size, int) or isinstance(size, bool) or size < 1:
                raise ValueError(f"mesh[{axis!r}] = {size!r} must be a positive int "
                                 "(or -1 for 'data')")
        # Configs from live specs, from JSON lists and from round trips
        # compare equal: rule entries become tuples down to the axis level.
        object.__setattr__(self, "mesh", dict(self.mesh))
        norm = lambda e: tuple(str(a) for a in e) if isinstance(e, (list, tuple)) else e
        object.__setattr__(self, "rules", tuple((str(p), tuple(norm(e) for e in s))
                                                for p, s in self.rules))
        object.__setattr__(self, "batch_axes", tuple(self.batch_axes))

    # ------------------------------------------------------ construction

    @classmethod
    def from_train_config(cls, cfg, *, rules=None) -> "ShardingConfig":
        """From the TrainConfig knobs (``mesh_*``, ``zero1``) and a task's
        live rules table."""
        mc = cfg.mesh_config()
        mesh = {AxisNames.DATA: mc.data, AxisNames.FSDP: mc.fsdp, AxisNames.MODEL: mc.model,
                AxisNames.CONTEXT: mc.context, AxisNames.PIPE: mc.pipe}
        return cls(mesh=mesh,
                   rules=tuple((pat, tuple(spec)) for pat, spec in
                               (rules_to_json(rules) if rules is not None else ())),
                   zero1=bool(getattr(cfg, "zero1", False)))

    # ------------------------------------------------------------- views

    def axis_size(self, axis: str) -> int:
        return int(self.mesh.get(axis, 1))

    def mesh_config(self) -> MeshConfig:
        return MeshConfig(data=self.axis_size(AxisNames.DATA),
                          fsdp=self.axis_size(AxisNames.FSDP),
                          model=self.axis_size(AxisNames.MODEL),
                          context=self.axis_size(AxisNames.CONTEXT),
                          pipe=self.axis_size(AxisNames.PIPE))

    def sharding_rules(self, default: ShardingRules | None = None) -> ShardingRules:
        """The rules table; empty config rules fall back to ``default``."""
        if self.rules:
            return rules_from_json(self.rules)
        return default if default is not None else ShardingRules()

    def build_mesh(self, *, device=None):
        """The mesh over the process group's ranks."""
        return create_mesh(self.mesh_config(), device=device)

    def mesh_shape_dict(self, mesh=None) -> dict[str, int]:
        """Axis -> size, resolved (no -1): the telemetry payload."""
        if mesh is not None:
            return dict(mesh.shape)
        return dict(zip(AxisNames.ALL, self.mesh_config().resolve(distributed.process_count())))

    # ----------------------------------------------------- serialization

    def to_json_dict(self) -> dict:
        return {
            "mesh": {a: int(s) for a, s in self.mesh.items()},
            "rules": [[p, list(s)] for p, s in self.rules],
            "batch_axes": list(self.batch_axes),
            "zero1": bool(self.zero1),
        }

    @classmethod
    def from_json_dict(cls, obj: Mapping[str, Any]) -> "ShardingConfig":
        if not isinstance(obj, Mapping):
            raise ValueError(f"sharding config must be a JSON object, got "
                             f"{type(obj).__name__}")
        unknown = set(obj) - {"mesh", "rules", "batch_axes", "zero1"}
        if unknown:
            raise ValueError(f"unknown sharding config keys {sorted(unknown)}")
        return cls(mesh=dict(obj.get("mesh", {"data": -1})),
                   rules=tuple((str(p), tuple(s)) for p, s in obj.get("rules", ())),
                   batch_axes=tuple(obj.get("batch_axes", AxisNames.BATCH_AXES)),
                   zero1=bool(obj.get("zero1", False)))

    def save(self, path: str, *, extra: Mapping | None = None) -> None:
        """Atomic write of ``{"version", "config", **extra}``: the
        ``workdir/sharding.json`` the trainer keeps beside its
        checkpoints."""
        doc = {"version": SHARDING_JSON_VERSION, "config": self.to_json_dict()}
        if extra:
            doc.update(extra)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ShardingConfig":
        return cls.load_with_extra(path)[0]

    @classmethod
    def load_with_extra(cls, path: str) -> tuple["ShardingConfig", dict]:
        """(config, the sidecar fields ``save(extra=...)`` recorded)."""
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError(f"{path}: not a JSON object")
        if "config" in doc:
            version = doc.get("version")
            if version != SHARDING_JSON_VERSION:
                raise ValueError(f"{path}: sharding.json version {version!r} "
                                 f"(this build reads {SHARDING_JSON_VERSION})")
            extra = {k: v for k, v in doc.items() if k not in ("version", "config")}
            return cls.from_json_dict(doc["config"]), extra
        # A bare config object (hand-written, no wrapper) also loads.
        return cls.from_json_dict(doc), {}
