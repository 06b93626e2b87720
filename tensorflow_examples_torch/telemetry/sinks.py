"""Metric sinks: the port of ``tensorflow_examples_tpu/telemetry/sinks.py``.

``Telemetry`` fans each schema line out to the sinks named in
``TrainConfig.telemetry_sinks``:

* ``jsonl``: one schema-versioned line per window appended to
  ``<workdir>/telemetry/metrics.jsonl``, flushed per line, so the file is
  valid up to its last complete line however the process dies;
* ``console``: the step log line;
* ``tensorboard``: the port has no TensorBoard writer. The name is
  accepted, as in the reference's spec, and becomes an explicit null
  writer with a one-time warning that says so.

Sinks never raise into the training loop (``Telemetry`` catches).
"""

from __future__ import annotations

import json
import logging
import os

log = logging.getLogger(__name__)

SINK_NAMES = ("jsonl", "tensorboard", "console")
# Kinds the scalar sinks render; memory lines are JSONL-record material.
_SCALAR_KINDS = ("window", "eval", "final")


class Sink:
    """Write one schema line; flush and close are idempotent."""

    def write(self, line: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


class JsonlSink(Sink):
    """Append-only JSONL, flushed per line."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")  # noqa: SIM115 - outlives the call

    def write(self, line: dict) -> None:
        self._f.write(json.dumps(line) + "\n")
        self._f.flush()

    def flush(self) -> None:
        if not self._f.closed:
            self._f.flush()
            try:
                os.fsync(self._f.fileno())
            except OSError:  # pragma: no cover - a filesystem without fsync
                pass

    def close(self) -> None:
        if not self._f.closed:
            self.flush()
            self._f.close()


class ConsoleSink(Sink):
    """The human-readable log line, one per window."""

    def write(self, line: dict) -> None:
        if line.get("kind", "window") not in _SCALAR_KINDS:
            return
        shown = {k: round(v, 5) for k, v in line["metrics"].items() if v is not None}
        log.info("step %d: %s", line["step"], shown)


_tb_warned = False


class NullTensorBoardSink(Sink):
    """The ``tensorboard`` entry: writes nothing, and says so once per
    process."""

    def __init__(self):
        global _tb_warned
        if not _tb_warned:
            _tb_warned = True
            log.warning("TensorBoard sink unavailable in the PyTorch port: using a null "
                        "writer (scalars will NOT reach TensorBoard; the jsonl sink has them)")

    def write(self, line: dict) -> None:
        pass


def telemetry_dir(workdir: str) -> str:
    return os.path.join(workdir, "telemetry")


def metrics_path(workdir: str) -> str:
    return os.path.join(telemetry_dir(workdir), "metrics.jsonl")


def trace_path(workdir: str) -> str:
    return os.path.join(telemetry_dir(workdir), "trace.json")


def make_sinks(spec: str, workdir: str) -> list[Sink]:
    """The sinks of a comma-separated spec. File-backed sinks need a
    workdir; without one only ``console`` materializes. An unknown name
    raises."""
    sinks: list[Sink] = []
    for name in (s.strip() for s in (spec or "").split(",")):
        if not name:
            continue
        if name not in SINK_NAMES:
            raise ValueError(f"unknown telemetry sink {name!r} (one of {SINK_NAMES})")
        if name == "console":
            sinks.append(ConsoleSink())
        elif name == "jsonl" and workdir:
            sinks.append(JsonlSink(metrics_path(workdir)))
        elif name == "tensorboard" and workdir:
            sinks.append(NullTensorBoardSink())
    return sinks
