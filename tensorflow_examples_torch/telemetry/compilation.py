"""Recompilation sentinel: the port of
``tensorflow_examples_tpu/telemetry/compilation.py``.

The reference wraps each jitted step and counts a compilation whenever a
call arrives with a new abstract input signature (the shape and dtype of
every array leaf): after each function's warmup allowance, a new
signature is a **recompile**, counted in ``compile/recompiles`` and
logged at WARNING with the shape delta. PyTorch runs eagerly, so here a
"compile" is the first run of a wrapped function under a new signature:
for the serving engine's decode and verify rungs on the card, that run
captures the rung's CUDA graph (``serving/engine.py``); elsewhere it is
the first eager run. The names, the counting and the warmup rule are the
reference's, so an engine of either package reports the same
``compile_counts()`` and ``post_warmup_recompiles()`` for the same
ladder.

The signature is a flatten of the call's arguments: ``(shape, dtype)``
for a tensor or numpy array, the type for anything else (a Python int
is a traced scalar to the reference; here it changes no shape).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Mapping

from tensorflow_examples_torch.telemetry import registry as registry_mod
from tensorflow_examples_torch.telemetry import spans as spans_mod

log = logging.getLogger(__name__)

# Cap the delta text: the first few entries name the culprit.
_MAX_DELTA_CHARS = 600
_MAX_DELTA_LEAVES = 8


def _flatten(obj: Any, path: str, out: list) -> None:
    if isinstance(obj, Mapping):
        for k in obj:
            _flatten(obj[k], f"{path}[{k!r}]", out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten(v, f"{path}[{i}]", out)
    else:
        out.append((path, obj))


def _aval(leaf) -> tuple:
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return (), type(leaf).__name__
    return tuple(int(d) for d in shape), str(getattr(leaf, "dtype", None))


def fast_signature(args: tuple, kwargs: dict) -> tuple:
    """The per-call fingerprint: ((shape, dtype) or ((), type name), ...)
    over the flattened arguments. Runs on every call, so it stays a
    plain flatten and a tuple build."""
    leaves: list = []
    _flatten((args, kwargs), "", leaves)
    return tuple(_aval(leaf) for _, leaf in leaves)


def abstract_signature(args: tuple, kwargs: dict) -> tuple:
    """The path-annotated signature, (path, shape, dtype) a leaf: computed
    only for a new ``fast_signature``, when a readable delta is needed."""
    leaves: list = []
    _flatten((args, kwargs), "", leaves)
    return tuple((path, *_aval(leaf)) for path, leaf in leaves)


def describe_delta(old: tuple | None, new: tuple) -> str:
    """Human-readable shape/dtype diff between two signatures, naming the
    changed axis."""
    if old is None:
        return "first compilation"
    old_map = {p: (s, d) for p, s, d in old}
    new_map = {p: (s, d) for p, s, d in new}
    parts: list[str] = []
    for path, (shape, dtype) in new_map.items():
        prev = old_map.get(path)
        if prev is None:
            parts.append(f"{path}: new input {shape} {dtype}")
            continue
        pshape, pdtype = prev
        if shape != pshape:
            if len(shape) == len(pshape):
                axes = ", ".join(f"axis {i}: {pshape[i]}->{shape[i]}"
                                 for i in range(len(shape)) if shape[i] != pshape[i])
            else:
                axes = f"rank {len(pshape)}->{len(shape)}"
            parts.append(f"{path}: shape {pshape}->{shape} ({axes})")
        if dtype != pdtype:
            parts.append(f"{path}: dtype {pdtype}->{dtype}")
    for path in old_map.keys() - new_map.keys():
        parts.append(f"{path}: input removed")
    if not parts:
        return "input tree structure changed (identical leaf avals)"
    shown = parts[:_MAX_DELTA_LEAVES]
    if len(parts) > len(shown):
        shown.append(f"... and {len(parts) - len(shown)} more leaves")
    return "; ".join(shown)[:_MAX_DELTA_CHARS]


class _FnRecord:
    __slots__ = ("name", "seen", "last_sig", "compiles")

    def __init__(self, name: str):
        self.name = name
        self.seen: set = set()
        self.last_sig: tuple | None = None
        self.compiles = 0


class SentinelWrapped:
    """A callable under sentinel observation; attribute access forwards
    to the wrapped function."""

    def __init__(self, sentinel: "CompilationSentinel", fn: Callable, name: str):
        self._sentinel = sentinel
        self._fn = fn
        self._name = name

    def __call__(self, *args, **kwargs):
        return self._sentinel._observed_call(self._fn, self._name, args, kwargs)

    def __getattr__(self, item):
        return getattr(self._fn, item)

    def __repr__(self):  # pragma: no cover - debugging nicety
        return f"SentinelWrapped({self._name}, {self._fn!r})"


class CompilationSentinel:
    """Per-engine (or per-trainer) compile observer."""

    def __init__(self, *, warmup: int = 1, registry=None, tracer=None):
        self.warmup = max(int(warmup), 0)
        self._registry = registry
        self._tracer = tracer
        self._fns: dict[str, _FnRecord] = {}
        self.events: list[dict] = []  # every compile event, introspectable
        self.step: int = 0  # labels warning lines
        self.on_recompile: Callable[[dict], None] | None = None

    def wrap(self, fn: Callable | None, name: str):
        """Wrap a callable; None passes through."""
        if fn is None:
            return None
        self._fns.setdefault(name, _FnRecord(name))
        return SentinelWrapped(self, fn, name)

    def invalidate(self, name: str) -> None:
        """Forget ``name``'s signatures: its next call counts as a compile
        (the engine calls this when it drops a rung's captured CUDA graph,
        whose recapture is a recompile)."""
        rec = self._fns.get(name)
        if rec is not None:
            rec.seen.clear()

    def _reg(self):
        return self._registry if self._registry is not None else registry_mod.default_registry()

    def _span(self, name: str, **args):
        tracer = self._tracer if self._tracer is not None else spans_mod.default_tracer()
        return tracer.span(name, **args)

    def _observed_call(self, fn, name, args, kwargs):
        rec = self._fns.setdefault(name, _FnRecord(name))
        sig = fast_signature(args, kwargs)
        if sig in rec.seen:
            return fn(*args, **kwargs)
        path_sig = abstract_signature(args, kwargs)
        t0 = time.perf_counter()
        with self._span("compile", fn=name):
            out = fn(*args, **kwargs)
        wall = time.perf_counter() - t0
        delta = describe_delta(rec.last_sig, path_sig)
        rec.seen.add(sig)
        rec.last_sig = path_sig
        rec.compiles += 1
        reg = self._reg()
        reg.counter("compile/count").inc()
        reg.gauge("compile/last_wall_secs").set(wall)
        event = {"fn": name, "count": rec.compiles, "wall_secs": round(wall, 6), "delta": delta}
        self.events.append(event)
        if rec.compiles > self.warmup:
            reg.counter("compile/recompiles").inc()
            log.warning("RECOMPILATION of %s at step %d (compile #%d for this fn, %.2fs): %s",
                        name, self.step, rec.compiles, wall, delta)
            if self.on_recompile is not None:
                try:
                    self.on_recompile(dict(event, step=self.step))
                except Exception:  # pragma: no cover - telemetry best effort
                    log.exception("recompile warning emission failed")
        else:
            log.info("compiled %s (#%d, %.2fs): %s", name, rec.compiles, wall, delta)
        return out

    def compile_counts(self) -> dict[str, int]:
        return {name: r.compiles for name, r in self._fns.items()}

    def post_warmup_recompiles(self) -> int:
        """Total compiles beyond each wrapped function's warmup allowance:
        the number that must be 0 in steady state."""
        return sum(max(0, r.compiles - self.warmup) for r in self._fns.values())
