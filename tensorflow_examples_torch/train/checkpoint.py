"""Checkpoint and resume: the port of
``tensorflow_examples_tpu/train/checkpoint.py`` in its own format.

A checkpoint of step ``s`` is the directory ``<workdir>/checkpoints/<s>/``
holding ``state.pt`` (``torch.save`` of ``{"step", "params",
"opt_state", "model_state"}``, every tensor on the CPU) and
``manifest.sha256.json`` (the sha256 of every other file in it). The
directory is written under a temporary name and renamed into place, so a
crash never leaves a torn step that looks committed. The port reads only
its own checkpoints, not the reference's orbax ones.

``save`` copies the state to the host on the calling thread (a device
sync, then the step may go on mutating nothing it saved) and writes it
on a background thread, one write at a time; ``wait`` and ``close``
join it and re-raise its error.

On a mesh (``layout``, a ``sharding/layout.StateLayout``) every rank
calls ``save``: the whole tensors are gathered from the ranks' pieces (a
collective) and only the ``primary`` rank writes them, in the same
format, so a checkpoint never depends on the mesh that wrote it.
``restore_latest`` reads the whole tensors on every rank, checks them
against the live state's whole shapes and cuts this rank's pieces for
the live mesh, whatever its shape: parameters restore bitwise across
mesh shapes. ``max_to_keep`` steps are kept.
``restore_latest`` verifies each step's manifest, newest first, and
falls back to the newest intact step with a warning that names the
corrupt file; it checks the saved tree against the live state and names
every drifted path (that is a config mistake, so it raises rather than
falls back).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
from typing import Any

import torch

from tensorflow_examples_torch.telemetry.registry import default_registry
from tensorflow_examples_torch.telemetry.spans import span
from tensorflow_examples_torch.train import optimizers

log = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.sha256.json"
STATE_NAME = "state.pt"


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest()


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    """``{path: leaf}`` of nested dicts/tuples/lists, paths ``/``-joined."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _as_dict(state) -> dict:
    return {"step": int(state.step), "params": state.params, "opt_state": state.opt_state,
            "model_state": state.model_state}


class CheckpointManager:
    def __init__(self, workdir: str, *, max_to_keep: int = 3, layout=None, primary: bool = True):
        self.directory = os.path.abspath(os.path.join(workdir, "checkpoints"))
        self.max_to_keep = max(int(max_to_keep), 1)
        self.layout = layout
        self.primary = primary
        self._thread: threading.Thread | None = None
        self._pending_step: int | None = None
        self._saved_here: int | None = None  # a non-primary rank's last saved step
        self._error: BaseException | None = None

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ------------------------------------------------------------ steps

    def all_steps(self) -> list[int]:
        """Committed steps, ascending."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest_step(self) -> int | None:
        """The newest step saved or being saved."""
        steps = self.all_steps() + [s for s in (self._pending_step, self._saved_here)
                                    if s is not None]
        return max(steps) if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    # ------------------------------------------------------------- save

    def save(self, step: int, state) -> None:
        """Copy ``state`` to the host now, write it on a thread."""
        self.wait()  # one write at a time; an earlier write's error raises here
        with span("checkpoint_save", step=step):
            tree = _as_dict(state)
            if self.layout is not None:
                tree.update(self.layout.gather_state(
                    {k: tree[k] for k in ("params", "opt_state", "model_state")}))
            if not self.primary:
                self._saved_here = step
                return
            host = optimizers.tree_map(
                lambda t: t.detach().to("cpu", copy=True) if torch.is_tensor(t) else t, tree)
        host["step"] = int(step)
        default_registry().counter("checkpoint/saves").inc()
        self._pending_step = step
        self._thread = threading.Thread(target=self._write_guarded, args=(step, host),
                                        name="ckpt-write", daemon=True)
        self._thread.start()

    def _write_guarded(self, step: int, host: dict) -> None:
        try:
            with span("checkpoint_write", step=step):
                self._write(step, host)
        except Exception as e:  # noqa: BLE001 - re-raised by wait()
            self._error = e

    def _write(self, step: int, host: dict) -> None:
        final = self.step_dir(step)
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(host, os.path.join(tmp, STATE_NAME))
        files = {STATE_NAME: _sha256_file(os.path.join(tmp, STATE_NAME))}
        with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
            json.dump({"step": step, "files": files}, f, indent=1)
            f.write("\n")
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)

    def wait(self) -> None:
        """Wait for the in-flight write; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._pending_step = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write failed: {err}") from err

    def close(self) -> None:
        self.wait()

    # ---------------------------------------------------------- restore

    def verify_step_integrity(self, step: int) -> list[str]:
        """Problems of a step's files against its manifest (empty:
        intact)."""
        step_dir = self.step_dir(step)
        manifest = os.path.join(step_dir, MANIFEST_NAME)
        try:
            with open(manifest) as f:
                files = json.load(f)["files"]
        except (OSError, ValueError, KeyError) as e:
            return [f"unreadable manifest {manifest}: {e}"]
        problems = []
        for rel, digest in sorted(files.items()):
            full = os.path.join(step_dir, rel)
            if not os.path.isfile(full):
                problems.append(f"missing file {rel}")
            elif _sha256_file(full) != digest:
                problems.append(f"sha256 mismatch in {rel}")
        return problems

    def load(self, step: int) -> dict:
        """The saved dict of a step, tensors on the CPU."""
        return torch.load(os.path.join(self.step_dir(step), STATE_NAME), map_location="cpu",
                          weights_only=True)

    def load_latest(self) -> tuple[dict, int] | None:
        """(saved dict, step) of the newest intact step; None when there
        is no checkpoint. Corrupt steps are skipped with a warning naming
        the file; raises when every step is corrupt."""
        self.wait()
        steps = self.all_steps()[::-1]
        if not steps:
            return None
        corrupt = []
        for step in steps:
            problems = self.verify_step_integrity(step)
            if not problems:
                with span("checkpoint_restore", step=step):
                    saved = self.load(step)
                if corrupt:
                    log.warning("restored checkpoint at step %d after skipping %d corrupt newer "
                                "step(s)", step, len(corrupt))
                else:
                    log.info("restored checkpoint at step %d", step)
                default_registry().counter("checkpoint/restores").inc()
                return saved, step
            shown = "; ".join(problems[:5])
            log.warning("checkpoint at step %d fails its integrity manifest (%s)%s", step, shown,
                        " - falling back to an older checkpoint" if step != steps[-1] else "")
            default_registry().counter("checkpoint/corrupt_skipped").inc()
            corrupt.append(f"step {step}: {shown}")
        raise RuntimeError("every checkpoint in %s is corrupt:\n  %s"
                           % (self.directory, "\n  ".join(corrupt)))

    def restore_latest(self, state, *, validate: bool = True):
        """(state restored onto ``state``'s devices and dtypes, step), or
        None when there is no checkpoint."""
        found = self.load_latest()
        if found is None:
            return None
        saved, step = found
        live = _as_dict(state)
        parts = ("params", "opt_state", "model_state")
        if validate:
            template = live
            if self.layout is not None:
                template = {**live, **self.layout.full_template({k: live[k] for k in parts})}
            _validate_structure(step, saved, template)
        if self.layout is not None:
            saved = {**saved, **self.layout.cut_state({k: saved[k] for k in parts})}
        put = lambda s, x: s.to(x.device, x.dtype) if torch.is_tensor(x) else s
        restored = {k: optimizers.tree_map(put, saved[k], live[k])
                    for k in ("params", "opt_state", "model_state")}
        new = type(state)(step=int(saved["step"]), tx=state.tx, **restored)
        return new, step


def _validate_structure(step: int, saved: dict, live: dict) -> None:
    """Raise naming every path that is missing, unexpected, or of
    another shape or dtype in the checkpoint than in the live state
    (parameters first)."""
    saved_flat = {k: v for k, v in _flatten(saved).items() if k != "step"}
    live_flat = {k: v for k, v in _flatten(live).items() if k != "step"}
    order = lambda paths: sorted(paths, key=lambda p: (not p.startswith("params/"), p))
    problems = [f"missing from checkpoint: {p}" for p in order(live_flat.keys() - saved_flat)]
    problems += [f"not in live state: {p}" for p in order(saved_flat.keys() - live_flat)]
    for p in order(saved_flat.keys() & live_flat):
        s, x = saved_flat[p], live_flat[p]
        if torch.is_tensor(s) and torch.is_tensor(x):
            if s.shape != x.shape:
                problems.append(f"shape mismatch at {p}: checkpoint {tuple(s.shape)} vs live "
                                f"{tuple(x.shape)}")
            elif s.dtype != x.dtype:
                problems.append(f"dtype mismatch at {p}: checkpoint {s.dtype} vs live {x.dtype}")
    if problems:
        shown = "\n  ".join(problems[:20])
        more = f"\n  ... and {len(problems) - 20} more" if len(problems) > 20 else ""
        raise ValueError(f"checkpoint at step {step} does not match the live train state "
                         f"({len(problems)} path(s) drifted - wrong model config or optimizer "
                         f"for this workdir?):\n  {shown}{more}")
