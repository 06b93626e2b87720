"""The shared training loop: the port of the single-device path of
``tensorflow_examples_tpu/train/loop.py``.

One step (``Trainer._train_step``) is the reference's: the loss and its
gradient with respect to the f32 master parameters, cast to the compute
dtype on the way in (``core/precision.py``); the optimizer update; the
f32 global gradient norm; and the bad-step guard compiled into the
reference's step, here a select on the device: unless
``bad_step_policy="off"``, a step whose loss or gradient norm is not
finite keeps the old parameters and optimizer state while ``step``
still advances, and reports ``bad_step`` = 1. Nothing syncs with the
host on the happy path except the log windows. A step's random input
(dropout masks, MoE router jitter) comes from its key,
``step_rng(PRNGKey(seed + 1), step)``, as in the reference
(``core/rng.StepNoise``). With ``debug_nans`` the step raises
``FloatingPointError`` at the first block, loss or backward op that
makes a NaN or an Inf (``core/nans.py``, autograd's anomaly mode).

``steps_per_launch`` k > 1 runs k steps a launch (``train/graphs.py``):
one CUDA graph of k steps on the card, a loop on the CPU, over k host
batches stacked by ``data/prefetch.bundle_batches``; metrics come back
``[k]`` and the host guard sees each step in order. Every loop cadence,
the resume step and the step span must then be multiples of k (the
reference's check). The single step and each bundle size run under the
recompilation sentinel (``telemetry/compilation.py``): a new batch
signature past ``compile_warmup`` writes a ``compile_warning`` line.

``fit`` runs steps from an iterator (or a ``start_step -> iterator``
callable, which makes resume and rollback replay exact) through
``data/prefetch.device_prefetch`` (pinned staging, a side-stream copy,
``prefetch_depth`` batches ahead, corrupt batches skipped up to
``max_skipped_batches``), and has the reference's exit paths: with a
``workdir`` it restores the latest checkpoint when ``resume`` is set,
saves every ``checkpoint_every`` steps and at the end
(``train/checkpoint.py``); SIGTERM/SIGINT save at the next step boundary
and raise ``Preempted`` (exit code 0); the host guard
(``train/resilience.py``) escalates repeated bad steps to a rollback or
an abort; the watchdog (``utils/diagnostics.py``) dumps the stacks of a
stalled input fetch, step or log flush, and exits 87 past
``watchdog_fatal_secs``; a ``profile_*`` window traces a few steps with
``torch.profiler`` (``telemetry/profiling.py``); the fault plan of
``utils/faults.py`` hooks in where the reference's does. Each log window
lands a telemetry line (``telemetry/hub.py``) and keeps the window's
means in ``history``; every exit path lands a ``final`` line and closes
the sinks and the checkpoint writer. The trainer runs on ``cuda``
(``cuda:LOCAL_RANK``) unless ``config.device`` is ``cpu``, and raises
without a GPU.

Meshes (``core/mesh.py``): one :class:`~..sharding.ShardingConfig` is
the source of truth, passed in, read from ``config.sharding_config``, or
made from the ``mesh_*``/``zero1`` fields and the task's rules. Every
rank of the process group runs the trainer: it initializes the whole
model from the seed and keeps its pieces (``sharding/layout.py``); each
step reads its rows of the global batch (the order of the reference's
``batch_sharding``), gathers FSDP pieces on use, averages gradients over
the batch and context axes, and under ``zero1`` reduce-scatters them,
updates its piece of the moments and all-gathers the parameters. Loss,
metrics and the gradient norm are global, so every rank's bad-step
guard and log window agree. Non-trainable state (``model_state``: the
ResNets' BatchNorm statistics, which the task computes from the global
batch's moments) is whole and equal on every rank: the guard keeps or
replaces it as it does the parameters, and checkpoints hold it once.
Such a task's moments are summed over the mesh's ``data`` and ``fsdp``
axes, so a ``batch_axes`` that splits the batch otherwise raises.
``fit`` allgathers the placement digest,
checks and refreshes ``workdir/sharding.json`` (a drifted rules table
raises :class:`~..sharding.ShardingMismatchError`), checkpoints whole
tensors from the primary rank and restores onto any mesh shape; only the
primary writes telemetry files or serves the metrics endpoints, and the
final line carries the ``sharding`` object. ``evaluate`` sums its
weighted totals over the batch axes (and averages them over
``context``); ``per_host`` eval streams are padded to the longest rank's
with zero-weight batches (:func:`_pad_per_host_batches`). Under the
``gloo`` backend on the card (several ranks on one GPU), collectives are
staged through host memory, which a CUDA graph cannot hold, so
``steps_per_launch`` > 1 raises there.

Memory (``telemetry/memory.py``): the hub's monitor writes the fit-start
breakdown line and the watermark of every window; a fit that dies of an
out-of-memory error logs the monitor's report (the largest live
tensors, the breakdown, the allocator's statistics) before the error
re-raises. ``metrics_port`` > 0 serves ``/metrics``, ``/health``,
``/window`` and ``/fleet`` while the fit runs (``telemetry/serve.py``).
Every input stream the fit opened, a background decode pipeline's
threads included, is closed when it unwinds, as is the eval stream
after each eval.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import os
import sys
import time
from typing import Callable, Iterable, Iterator, Mapping

import numpy as np
import torch

from tensorflow_examples_torch.core import collectives as coll
from tensorflow_examples_torch.core import distributed, nans, rng
from tensorflow_examples_torch.core.mesh import AxisNames
from tensorflow_examples_torch.core.precision import PrecisionPolicy
from tensorflow_examples_torch.core.sharding import ShardingRules, batch_rows
from tensorflow_examples_torch.data.prefetch import bundle_batches, device_prefetch, put_batch
from tensorflow_examples_torch.models.convert import flatten_tree
from tensorflow_examples_torch.sharding import (ShardingConfig, ShardingMismatchError,
                                                resolve_params, verify_digest_agreement)
from tensorflow_examples_torch.sharding.config import rules_to_json
from tensorflow_examples_torch.sharding.layout import StateLayout
from tensorflow_examples_torch.telemetry.compilation import CompilationSentinel
from tensorflow_examples_torch.telemetry import memory as memory_mod
from tensorflow_examples_torch.telemetry.hub import Telemetry
from tensorflow_examples_torch.telemetry.serve import MetricsServer
from tensorflow_examples_torch.telemetry.profiling import ProfilerWindow
from tensorflow_examples_torch.train import optimizers, resilience
from tensorflow_examples_torch.train.graphs import BundledStep
from tensorflow_examples_torch.train.checkpoint import CheckpointManager
from tensorflow_examples_torch.train.config import TrainConfig
from tensorflow_examples_torch.train.state import TrainState
from tensorflow_examples_torch.train.task import Task
from tensorflow_examples_torch.utils import faults
from tensorflow_examples_torch.utils.diagnostics import Watchdog

log = logging.getLogger(__name__)


class Trainer:
    """Runs a :class:`Task` under a :class:`TrainConfig` on this rank's
    device of a mesh (one device in one process).

    ``init_params``: an optional param tree in the reference's layout
    (nested dicts of arrays, or ``/``-joined flat keys) that replaces the
    task's random init, e.g. weights carried over from the JAX package.
    ``mesh`` (``core/mesh.Mesh``) and ``sharding``: see the module
    docstring; a task must be made for the same mesh
    (``make_task(cfg, mesh=mesh)``): its model splits over ``model`` or
    ``context``, or sums BatchNorm moments over the batch axes.
    """

    def __init__(self, task: Task, config: TrainConfig, *, init_params: Mapping | None = None,
                 mesh=None, sharding: ShardingConfig | None = None):
        self.task = task
        self.config = config
        self.device = distributed.local_device(config.device)
        if self.device.type == "cuda":
            # f32 means f32: TF32 matmuls and convolutions keep ~3 decimal
            # digits (cuDNN's convolutions default to TF32).
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if sharding is None:
            path = getattr(config, "sharding_config", "")
            sharding = (ShardingConfig.load(path) if path else
                        ShardingConfig.from_train_config(config, rules=task.sharding_rules))
        self.mesh = mesh if mesh is not None else sharding.build_mesh(device=self.device)
        if mesh is not None:  # what actually runs, for sharding.json and telemetry
            sharding = dataclasses.replace(sharding, mesh=dict(mesh.shape))
        self.sharding = sharding
        self._rules = sharding.sharding_rules(default=task.sharding_rules or ShardingRules())
        self.layout: StateLayout | None = None  # set by _init_state on a mesh
        self.policy = PrecisionPolicy.create(config.precision)
        self._seed_key = rng.PRNGKey(config.seed + 1)
        if config.bad_step_policy not in resilience.POLICIES:
            raise ValueError(f"bad_step_policy={config.bad_step_policy!r}; expected one of "
                             f"{resilience.POLICIES}")
        self._device_guard = config.bad_step_policy != "off"
        self._guard: resilience.BadStepGuard | None = None  # the host guard of the last fit
        self._ckpt: CheckpointManager | None = None
        self.telemetry: Telemetry | None = None
        self.history: list[dict] = []
        self.state = self._init_state(init_params)
        # Each step function counts its input signatures; a new one past
        # compile_warmup is a recompile (a compile_warning line in fit).
        # The wrapped step takes the trainer as an argument: a bound method
        # stored on the trainer would make a cycle that keeps a dropped
        # trainer's tensors on the device until the garbage collector runs.
        self.sentinel = CompilationSentinel(warmup=config.compile_warmup)
        self._step_fn = self.sentinel.wrap(Trainer._train_step, "train_step")
        self._bundled: dict[int, BundledStep] = {}
        self._noise = rng.StepNoise()  # the eager step's, restaged every step

    # ------------------------------------------------------------- init

    def _init_state(self, init_params) -> TrainState:
        variables = dict(self.task.init_fn(self.config.seed, self.device))
        params = variables.pop("params")
        if init_params is not None:
            given = {k.replace("/", "."): v for k, v in flatten_tree(init_params).items()}
            missing, extra = sorted(params.keys() - given.keys()), sorted(given.keys() - params.keys())
            if missing or extra:
                raise ValueError(f"init_params mismatch: missing {missing}, unexpected {extra}")
            for k, v in given.items():
                if tuple(np.shape(v)) != tuple(params[k].shape):
                    raise ValueError(f"{k}: shape {tuple(np.shape(v))} != {tuple(params[k].shape)}")
            params = {k: torch.as_tensor(np.asarray(given[k], np.float32)) for k in params}
        params = {k: v.detach().to(self.device, self.policy.param_dtype) for k, v in params.items()}
        self.n_params = sum(p.numel() for p in params.values())
        self._resolution = resolve_params(params, self.mesh, self._rules)
        tx = self.task.make_optimizer(self.config)
        log.info("initialized %s: %.2fM params on %s, mesh %s", self.task.name,
                 self.n_params / 1e6, self.device, self.mesh.shape)
        if self.mesh.trivial:
            return TrainState.create(params=params, tx=tx, model_state=variables)
        layout = self.layout = StateLayout(self.mesh, self._rules, params, tx,
                                           zero1=self.sharding.zero1,
                                           batch_axes=self.sharding.batch_axes)
        if variables and set(layout.batch_axes) != set(self.mesh.axes(AxisNames.BATCH_AXES)):
            # The model sums its running statistics' moments over the
            # mesh's batch axes: other rows per rank would make them local.
            raise NotImplementedError(
                f"{self.task.name} keeps running statistics ({sorted(variables)}) summed over "
                f"the mesh's {AxisNames.BATCH_AXES} axes; batch_axes="
                f"{list(self.sharding.batch_axes)} splits the batch over "
                f"{list(layout.batch_axes)}")
        params = layout.shard_params(params)
        return TrainState(step=0, params=params, opt_state=tx.init(layout.opt_view(params)),
                          model_state=variables, tx=tx)

    def sharding_digest(self) -> str:
        """Stable hash of the param -> spec table (the reference's bytes;
        mesh-shape independent), on the final telemetry line and in
        ``workdir/sharding.json``."""
        return self._resolution.digest()

    def _sync_sharding_json(self, workdir: str) -> None:
        """Validate against, then refresh, ``workdir/sharding.json``: a
        saved digest that differs from the live one means the rules
        drifted since the checkpoints were written, a config error named
        path by path (a mesh-shape change hashes alike and reshards)."""
        path = os.path.join(workdir, "sharding.json")
        if os.path.exists(path):
            try:
                saved_cfg, extra = ShardingConfig.load_with_extra(path)
            except (ValueError, OSError) as e:
                raise ShardingMismatchError(
                    f"unreadable sharding config at {path}: {e} - move it aside if the workdir "
                    "is being repurposed") from e
            saved_digest = extra.get("param_sharding_digest")
            live = self._resolution
            if saved_digest and saved_digest != live.digest():
                template = {r.path.replace("/", "."): torch.empty(r.shape, device="meta")
                            for r in live.rows}
                theirs = resolve_params(template, self.mesh,
                                        saved_cfg.sharding_rules(default=ShardingRules())
                                        ).spec_by_path()
                mine = live.spec_by_path()
                drifted = [p for p in sorted(set(mine) | set(theirs))
                           if mine.get(p) != theirs.get(p)]
                shown = "\n  ".join(f"{p}: saved {theirs.get(p)} vs live {mine.get(p)}"
                                    for p in drifted[:10]) or (
                    "(digest drift outside the resolvable param table)")
                more = f"\n  ... and {len(drifted) - 10} more" if len(drifted) > 10 else ""
                raise ShardingMismatchError(
                    f"sharding rules drifted vs {path} (saved digest {saved_digest}, live "
                    f"{live.digest()}): checkpoints in this workdir were written under "
                    "different placement rules. Mesh-shape changes reshard fine; rule changes "
                    f"need a fresh workdir (or delete sharding.json deliberately).\n  "
                    f"{shown}{more}")
        if distributed.is_primary():
            # The resolved rules: a config that inherited the task's table
            # writes it out, so the file stands alone.
            to_save = (self.sharding if self.sharding.rules else
                       dataclasses.replace(self.sharding, rules=rules_to_json(self._rules)))
            try:
                os.makedirs(workdir, exist_ok=True)
                to_save.save(path, extra={"param_sharding_digest": self.sharding_digest(),
                                          "mesh_shape": self.sharding.mesh_shape_dict(self.mesh)})
            except OSError:  # metadata: never kill a training job over it
                log.warning("could not persist %s (continuing)", path, exc_info=True)

    def byte_breakdown(self, *, per_device: bool = False) -> dict[str, int]:
        """Tensor bytes of params, optimizer state and non-trainable
        collections: whole tensors, or (``per_device``) this rank's
        pieces, the ZeRO-1 and FSDP memory claims' unit."""
        parts = {"params": self.state.params, "opt_state": self.state.opt_state,
                 "model_state": self.state.model_state}
        pieces = self.layout.pieces(parts) if self.layout is not None else {}
        return {k: memory_mod.tree_bytes(v, per_device=per_device, pieces=pieces.get(k))
                for k, v in parts.items()}

    # ------------------------------------------------------------- steps

    def local_batch(self, batch: Mapping) -> dict:
        """This rank's rows of a global host batch (all of it in one
        process)."""
        if self.layout is None or not self.layout.batch_axes:
            return dict(batch)
        return {k: v[batch_rows(len(v), self.mesh, self.layout.batch_axes)]
                for k, v in batch.items()}

    def put_batch(self, batch: Mapping) -> dict[str, torch.Tensor]:
        """This rank's rows of a host batch, on the device."""
        return put_batch(self.local_batch(batch), self.device)

    def step_key(self, step: int) -> np.ndarray:
        """Step ``step``'s key: ``step_rng(PRNGKey(seed + 1), step)``, with
        this rank's batch and sequence shard folded in where the mesh
        splits them (each shard draws its own dropout masks; ranks that
        compute the same tokens draw the same ones)."""
        key = rng.step_rng(self._seed_key, step)
        if self.layout is not None and self.layout.grad_axes:
            key = rng.fold_in(key, self.mesh.axis_index(self.layout.grad_axes))
        return key

    def stage_noise(self, noise: rng.StepNoise, step: int) -> rng.StepNoise:
        """``noise`` staged for step ``step``: this rank's key, and the
        unfolded step key the expert-parallel router jitter folds."""
        return noise.stage(self.step_key(step), base=rng.step_rng(self._seed_key, step))

    def _compute_params(self, params: Mapping) -> Mapping:
        """What a step's forward reads: compute-dtype copies, FSDP pieces
        gathered on use."""
        cast = self.policy.cast_compute(params)
        return self.layout.gathered(cast) if self.layout is not None else cast

    def _apply_gradients(self, state: TrainState, grads: Mapping) -> TrainState:
        if self.layout is None:
            return state.apply_gradients(grads)
        view = self.layout.opt_view(state.params)
        updates, opt_state = state.tx.update(grads, state.opt_state, view)
        params = self.layout.from_opt_view(optimizers.apply_updates(view, updates))
        return dataclasses.replace(state, step=state.step + 1, params=params,
                                   opt_state=opt_state)

    def _train_step(self, state: TrainState, batch: Mapping[str, torch.Tensor], noise=None):
        """One step; ``noise`` (default: the trainer's own, staged from the
        step key) supplies dropout and router jitter. ``state.step`` is an
        int, or a device tensor inside a captured graph."""
        if noise is None:
            noise = self.stage_noise(self._noise, state.step)
        debug = self.config.debug_nans
        leaves = {k: p.detach().requires_grad_(True) for k, p in state.params.items()}
        with (_debug_nans(state.step) if debug else contextlib.nullcontext()):
            loss, metrics, new_model_state = self.task.loss_fn(
                self._compute_params(leaves), state.model_state,
                self.policy.cast_compute(batch), rng=noise, train=True,
            )
            nans.check_finite(loss, "the loss")
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        with torch.no_grad(), (optimizers.sharded_norms(self.layout.global_sumsq)
                               if self.layout is not None else contextlib.nullcontext()):
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["loss"] = loss.detach().float()
            if self.layout is not None:
                grads = self.layout.reduce_grads(grads)
                metrics = {k: self.layout.mean_metric(v) for k, v in metrics.items()}
            new_state = self._apply_gradients(state, grads)
            new_state.model_state = new_model_state
            metrics["grad_norm"] = optimizers.global_norm(grads)
            if self._device_guard:
                bad = ~(torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"]))
                keep = lambda new, old: torch.where(bad, old, new)
                new_state.params = optimizers.tree_map(keep, new_state.params, state.params)
                new_state.opt_state = optimizers.tree_map(keep, new_state.opt_state,
                                                          state.opt_state)
                new_state.model_state = optimizers.tree_map(keep, new_state.model_state,
                                                            state.model_state)
                metrics["bad_step"] = bad.float()
        return new_state, metrics

    def run_steps(self, state: TrainState, bundle: Mapping[str, torch.Tensor], noises):
        """``len(noises)`` steps over ``bundle``'s ``[k, ...]`` leaves, step
        i reading slice i with noise i; metrics stacked ``[k]``."""
        stepped = []
        for i, noise in enumerate(noises):
            state, metrics = self._train_step(state, {k: v[i] for k, v in bundle.items()}, noise)
            stepped.append(metrics)
        return state, {k: torch.stack([m[k] for m in stepped]) for k in stepped[0]}

    def bundled_step(self, k: int):
        """The k-step function (``train/graphs.BundledStep``) under the
        sentinel, cached per k."""
        if k not in self._bundled:
            self._bundled[k] = self.sentinel.wrap(BundledStep(self, k), f"train_step[k={k}]")
        return self._bundled[k]

    def train_step(self, batch: Mapping) -> dict[str, torch.Tensor]:
        """One step on a host or device batch; metrics stay on the device."""
        self.state, metrics = self._step_fn(self, self.state, self.put_batch(batch))
        return metrics

    # ------------------------------------------------------------- loop

    def fit(
        self,
        train_data: Iterator[Mapping[str, np.ndarray]] | Callable[[int], Iterator],
        *,
        eval_iter_fn: Callable[[], Iterable] | None = None,
        num_steps: int | None = None,
    ) -> dict[str, float]:
        """Train until ``state.step`` reaches ``num_steps`` (default
        ``config.train_steps``); returns the last window's metrics and
        the final eval's (prefixed ``eval_``). ``train_data`` may be an
        iterator or a ``start_step -> iterator`` callable, called after
        the restore and again after a rollback."""
        cfg = self.config
        num_steps = cfg.train_steps if num_steps is None else num_steps
        k = max(int(cfg.steps_per_launch or 1), 1)
        if k > 1 and cfg.debug_nans and self.device.type == "cuda":
            raise ValueError(f"debug_nans syncs with the host at every check, which a CUDA graph "
                             f"of steps_per_launch={k} steps cannot hold; use steps_per_launch=1")
        if k > 1 and self.mesh.backend == "gloo" and self.device.type == "cuda":
            raise ValueError(f"steps_per_launch={k} captures a CUDA graph, and the gloo backend's "
                             "collectives go through host memory, which a graph cannot hold; "
                             "use steps_per_launch=1 (or NCCL, one card a rank)")
        primary = distributed.is_primary()
        # Config mistakes raise before any handler or thread exists.
        faults_engine = faults.active()
        guard = self._guard = resilience.BadStepGuard.from_config(cfg)
        telemetry = self.telemetry = Telemetry.from_config(
            cfg, n_params=self.n_params, device=self.device, host=distributed.process_index(),
            n_devices=self.mesh.size)
        telemetry.sharding_info = {"mesh_shape": self.sharding.mesh_shape_dict(self.mesh),
                                   "param_sharding_digest": self.sharding_digest(),
                                   "zero1": bool(self.sharding.zero1)}
        self.sentinel.on_recompile = telemetry.compile_warning
        watchdog = None
        if cfg.watchdog_secs > 0 or cfg.watchdog_fatal_secs > 0:
            # Paused until the first step (and any graph capture) is done.
            watchdog = Watchdog(cfg.watchdog_secs or cfg.watchdog_fatal_secs,
                                fatal_timeout_s=cfg.watchdog_fatal_secs,
                                flush_fn=telemetry.emergency_flush).start()
            watchdog.pause()
        preempt = resilience.PreemptionGuard().install() if cfg.preempt_checkpoint else None
        window: list[dict] = []
        prof = emit_final = None
        streams: list = []  # every input stream this fit opens, closed as it unwinds
        held = {"batch": None}  # the step's batch: live bytes off the card
        if telemetry.memory is not None:
            telemetry.memory.tracked = lambda: (self.state, held["batch"])
        try:
            server = (MetricsServer.from_config(cfg, telemetry=telemetry, watchdog=watchdog)
                      if primary else None)
            if server is not None:
                try:
                    telemetry.server = server.start()
                except OSError as e:  # a taken port must not kill the run
                    log.warning("metrics server failed to bind port %d (%s); continuing "
                                "without live endpoints", server.requested_port, e)
            # Every rank must place the parameters alike before any
            # checkpoint is touched.
            verify_digest_agreement(self.sharding_digest())
            if cfg.workdir:
                self._sync_sharding_json(cfg.workdir)
                self._ckpt = CheckpointManager(cfg.workdir, layout=self.layout, primary=primary)
                if cfg.resume:
                    restored = self._ckpt.restore_latest(self.state)
                    if restored is not None:
                        self.state = restored[0]
            start_step = self.state.step
            telemetry.note_memory_init(self.state, step=start_step)
            if k > 1:
                cadences = {
                    # Cadences fire on (step+1) % cadence == 0 and step+1 only
                    # takes values start_step + i*k, so both the phase
                    # (start_step) and each period must divide by k or
                    # periodic events silently never fire.
                    "start step (resume phase)": start_step,
                    "train step span": num_steps - start_step,
                    "log_every": cfg.log_every,
                    "eval_every": cfg.eval_every if eval_iter_fn else 0,
                    "checkpoint_every": cfg.checkpoint_every if self._ckpt else 0,
                }
                bad = {n: v for n, v in cadences.items() if v and v % k}
                if bad:
                    raise ValueError(
                        f"steps_per_launch={k} requires every active loop cadence to be a "
                        f"multiple of it; offending: {bad} (a resumed checkpoint from an "
                        "unbundled run may leave the step span unaligned)")
            step_fn = functools.partial(self._step_fn, self) if k == 1 else self.bundled_step(k)
            resumable = callable(train_data) and not hasattr(train_data, "__next__")
            source = None if resumable else iter(train_data)

            def build_iter(start: int):
                src = train_data(start) if resumable else source
                local = src if self.layout is None else _LocalRows(src, self.local_batch)
                it = device_prefetch(local if k == 1 else bundle_batches(local, k), self.device,
                                     depth=max(cfg.prefetch_depth, 1),
                                     depth_max=cfg.prefetch_depth_max,
                                     max_skips=cfg.max_skipped_batches)
                streams.extend((it, src))
                return it

            it = build_iter(start_step)
            prof = ProfilerWindow.from_config(cfg, telemetry, device=self.device)
            last: dict[str, float] = {}
            evaluated_now = False
            stepped_once = False  # the first step pays first-call set-up

            def emit_final(reason: str) -> None:
                telemetry.note_steps(len(window) * k)
                means = _window_means(window, guard is not None)
                window.clear()
                telemetry.final_window(self.state.step, means, exit_reason=reason)

            t_window = t_iter = time.perf_counter()
            while True:
                if guard is not None and guard.poll(
                        drain=self.state.step >= num_steps) == "rollback":
                    if watchdog is not None:
                        watchdog.pause()
                    it = self._rollback_to_checkpoint(guard, build_iter if resumable else None,
                                                      it)
                    telemetry.note_steps(len(window) * k)  # discarded, but stepped
                    window.clear()
                    t_window = t_iter = time.perf_counter()
                    continue
                chunk = self.state.step
                if chunk >= num_steps:
                    break
                self.sentinel.step = chunk + k - 1  # labels recompile warnings
                if faults_engine is not None:
                    faults_engine.step_hook(chunk, k)
                if prof is not None:
                    prof.maybe_start(chunk - start_step)
                if watchdog is not None:
                    # Armed for the fetch from the start: a wedged input
                    # pipeline at job start must trip it too.
                    watchdog.enter("input_fetch")
                    watchdog.resume()
                with telemetry.span("data_fetch"):
                    batch = next(it)
                held["batch"] = batch
                if faults_engine is not None:
                    batch = faults_engine.nan_hook(chunk, k, batch)
                if watchdog is not None:
                    watchdog.enter("device_step")
                    if not stepped_once or (k > 1 and step_fn.needs_capture(batch)):
                        watchdog.pause()  # first call: build, warm-up, graph capture
                with telemetry.span("device_step"):
                    self.state, metrics = step_fn(self.state, batch)
                step = self.state.step
                now = time.perf_counter()
                if stepped_once:
                    telemetry.record_step_time(now - t_iter, k)
                stepped_once = True
                if watchdog is not None:
                    watchdog.resume()
                    watchdog.ping(step - 1)
                window.append(metrics)
                if guard is not None:
                    for i in range(k):  # each step of the launch, in order
                        guard.observe(chunk + i, metrics if k == 1 else
                                      {name: v[i] for name, v in metrics.items()})
                if prof is not None:
                    prof.maybe_stop(step - start_step)
                if (cfg.log_every and step % cfg.log_every == 0) or step == num_steps:
                    if watchdog is not None:
                        # A full window of queued device work may drain here: a
                        # fresh heartbeat and its own phase, but still armed.
                        watchdog.enter("log_flush")
                    with telemetry.span("metric_flush"):
                        means = _window_means(window, guard is not None)  # syncs
                        steps_done = len(window) * k
                        dt = time.perf_counter() - t_window
                        means["step_time_s"] = dt / steps_done
                        means["steps_per_sec"] = steps_done / dt
                        means["examples_per_sec"] = steps_done * cfg.global_batch_size / dt
                        self.history.append({"step": step, **means})
                        last.update(means)
                        telemetry.note_steps(steps_done)
                        window.clear()
                        telemetry.log_window(step, means)
                        t_window = time.perf_counter()
                if preempt is not None and preempt.requested:
                    # Before the eval: the kill grace window is ticking.
                    self._preempt_exit(step, preempt, emit_final, watchdog, prof)
                evaluated_now = False
                if cfg.eval_every and eval_iter_fn is not None and step % cfg.eval_every == 0:
                    if watchdog is not None:
                        watchdog.pause()
                    with telemetry.span("eval"):
                        eval_metrics = self.evaluate(eval_iter_fn())
                    if watchdog is not None:
                        watchdog.resume()
                    telemetry.log_window(step, eval_metrics, prefix="eval", kind="eval")
                    last.update({f"eval_{k_}": v for k_, v in eval_metrics.items()})
                    evaluated_now = step == num_steps
                    t_window = time.perf_counter()
                if self._ckpt and cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                    if watchdog is not None:
                        watchdog.pause()  # storage-bound, not a hang
                    self._ckpt.save(step, self.state)
                    if watchdog is not None:
                        watchdog.resume()
                if preempt is not None and preempt.requested:
                    self._preempt_exit(step, preempt, emit_final, watchdog, prof)
                t_iter = time.perf_counter()

            if prof is not None:
                prof.finish()
            if watchdog is not None:
                watchdog.pause()  # the final eval and checkpoint
            if preempt is not None and preempt.requested:
                self._preempt_exit(self.state.step, preempt, emit_final, watchdog, prof)
            if eval_iter_fn is not None and not evaluated_now:
                with telemetry.span("eval"):
                    eval_metrics = self.evaluate(eval_iter_fn())
                telemetry.log_window(self.state.step, eval_metrics, prefix="eval", kind="eval")
                last.update({f"eval_{k_}": v for k_, v in eval_metrics.items()})
            if self._ckpt and self._ckpt.latest_step() != self.state.step:
                self._ckpt.save(self.state.step, self.state)
            emit_final("complete")
            return last
        finally:
            # The watchdog stops first: a fatal timeout firing mid-close
            # would kill the very checkpoint commit the close protects.
            if watchdog is not None:
                watchdog.stop()
            if preempt is not None:
                preempt.uninstall()
            if prof is not None:
                try:
                    prof.finish()  # an open window must not leave the profiler armed
                except Exception:  # pragma: no cover - profiler teardown races
                    log.exception("profiler window teardown failed")
            for stream in streams:  # background readers and workers stop here
                close = getattr(stream, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:  # pragma: no cover - teardown is best effort
                        log.exception("input stream close failed")
            exc = sys.exc_info()[1]
            try:
                # Who held the memory, logged before an OOM re-raises.
                memory_mod.maybe_log_oom_report(exc, telemetry.memory)
                if exc is not None and not isinstance(exc, resilience.Preempted) and emit_final:
                    emit_final(f"error:{type(exc).__name__}")
            except Exception:  # pragma: no cover - telemetry is best effort here
                log.exception("final telemetry line failed")
            self.sentinel.on_recompile = None
            telemetry.close()
            if self._ckpt is not None:
                try:
                    self._ckpt.close()
                finally:
                    self._ckpt = None

    def _preempt_exit(self, step: int, preempt, emit_final, watchdog=None, prof=None) -> None:
        """Synchronous checkpoint, the final line, then a clean exit."""
        if watchdog is not None:
            watchdog.pause()
        if prof is not None:
            prof.finish()
        if self._ckpt is not None:
            self._ckpt.wait()
            if self._ckpt.latest_step() != step:
                self._ckpt.save(step, self.state)
            self._ckpt.wait()  # durable before the exit
            log.warning("preemption: synchronous checkpoint at step %d saved; exiting cleanly",
                        step)
        else:
            log.warning("preemption at step %d with no workdir: nothing to checkpoint; "
                        "exiting cleanly", step)
        self.telemetry.registry.counter("resilience/preemptions").inc()
        emit_final("preempt")
        raise resilience.Preempted(step, preempt.signum)

    def _rollback_to_checkpoint(self, guard, build_iter, it):
        """Bad-step rollback: restore the latest checkpoint and replay
        from it (exactly, when the data is a callable)."""
        restored = None
        if self._ckpt is not None:
            self._ckpt.wait()
            restored = self._ckpt.restore_latest(self.state)
        if restored is None:
            raise resilience.BadStepError(
                "bad_step_policy=rollback needs a checkpoint to restore, but none exists under "
                f"workdir={self.config.workdir!r}. {guard.status()}")
        self.state, step = restored
        guard.note_rollback(step)  # raises on a repeat
        log.warning("bad-step rollback: restored checkpoint at step %d (%s)", step,
                    guard.status())
        if build_iter is None:
            log.warning("train iterator is not resumable (pass a callable (start) -> iterator "
                        "for exact replay); continuing on the live stream after rollback")
            return it
        return build_iter(step)

    @torch.no_grad()
    def evaluate(self, eval_iter: Iterable, *, per_host: bool = False) -> dict[str, float]:
        """Weighted mean of ``task.eval_fn`` over ``eval_iter``'s batches
        (each batch's ``weight`` entry, else 1), through
        ``task.eval_finalize`` when the task has one. On a mesh every rank
        reads the same global batches and evaluates its rows; the weighted
        totals are summed over the batch axes and averaged over
        ``context`` (its ranks split each example's tokens). ``per_host``:
        each rank's iterator yields its own rows (per-rank shards, on a
        mesh of batch axes only); shorter streams are padded with
        zero-weight batches (:func:`_pad_per_host_batches`)."""
        if self.task.eval_fn is None:
            return {}
        layout = self.layout
        if per_host and layout is not None and set(layout.grad_axes) - set(layout.batch_axes):
            raise ValueError("per-host eval streams need a mesh of batch axes only: model and "
                             "context ranks must read the same rows")
        params = self._compute_params(self.state.params)
        totals: dict[str, torch.Tensor] = {}
        count = None
        batches = _pad_per_host_batches(iter(eval_iter)) if per_host and layout else eval_iter
        try:
            for batch in batches:
                batch = put_batch(batch, self.device) if per_host else self.put_batch(batch)
                m = dict(self.task.eval_fn(params, self.state.model_state,
                                           self.policy.cast_compute(batch)))
                w = m.pop("weight", torch.ones((), device=self.device)).float()
                for k, v in m.items():
                    totals[k] = totals[k] + v.float() * w if k in totals else v.float() * w
                count = w if count is None else count + w
        finally:
            close = getattr(eval_iter, "close", None)
            if close is not None:  # a background pipeline's threads
                close()
        if count is None:
            return {}
        if layout is not None:
            ctx = tuple(a for a in layout.grad_axes if a not in layout.batch_axes)
            n_ctx = self.mesh.axis_size(ctx) if ctx else 1
            totals = {k: coll._all_reduce(v, layout.grad_axes, self.mesh) / n_ctx
                      for k, v in totals.items()}
            count = coll._all_reduce(count, layout.batch_axes, self.mesh)
        means = {k: float(v) / max(float(count), 1.0) for k, v in totals.items()}
        if self.task.eval_finalize is not None:
            means = dict(self.task.eval_finalize(means))
        return means


class _LocalRows:
    """This rank's rows of each batch of a global stream; an error of the
    stream's (a corrupt batch the prefetcher skips) passes through and
    the stream goes on."""

    def __init__(self, src, rows):
        self._src, self._rows = iter(src), rows

    def __iter__(self):
        return self

    def __next__(self):
        return self._rows(next(self._src))


def _pad_per_host_batches(it: Iterator) -> Iterator:
    """Equalize per-rank eval streams: every rank yields batches until
    the longest stream is exhausted, padding with zero-weight copies
    (``mask`` of zeros), one batch resident at a time, as the reference.

    Per batch the ranks allgather a status flag (0 exhausted, 1 a batch,
    2 a batch of another shape than this rank's last): a ragged batch on
    any rank, or a rank with no batch at all (no padding template),
    raises the same error on every rank instead of leaving its peers in
    the next collective. Every batch must share one shape."""
    pad = None
    first = True
    while True:
        batch = next(it, None)
        ragged = (batch is not None and pad is not None
                  and any(k in pad and np.shape(v) != pad[k].shape for k, v in batch.items()))
        flags = distributed.allgather_host(np.asarray(0 if batch is None else (2 if ragged else 1)))
        if (flags == 2).max():
            raise ValueError("per-host eval batches must share one shape; a host yielded a "
                             "differently-shaped batch (pad ragged final batches with zero-mask "
                             f"rows); status flags: {flags}")
        if first and flags.min() != flags.max():
            raise ValueError("per-host eval requires at least one local batch on every host "
                             "(needed as the zero-weight padding template); have-batch flags "
                             f"across hosts: {flags}")
        first = False
        if flags.max() == 0:
            return
        if batch is None:
            yield pad
            continue
        batch = dict(batch)
        if "mask" not in batch:
            batch["mask"] = np.ones(len(next(iter(batch.values()))), np.float32)
        pad = {k: np.zeros_like(v) for k, v in batch.items()}
        yield batch


@contextlib.contextmanager
def _debug_nans(step):
    """``debug_nans`` around one step's forward and backward: the model's
    and the loss's finite checks, the backward under autograd's anomaly
    mode, whose NaN report becomes a ``FloatingPointError`` too; the
    error names the step."""
    try:
        with nans.finite_checks(), torch.autograd.detect_anomaly(check_nan=True):
            yield
    except FloatingPointError as e:
        raise FloatingPointError(f"{e} at step {step}") from None
    except RuntimeError as e:
        if "nan values" not in str(e):
            raise
        raise FloatingPointError(f"debug_nans: {e} (step {step})") from e


def _window_means(window: list[dict], finite_only: bool) -> dict[str, float]:
    """Each metric's mean over the window (a bundle's metrics are [k]:
    every step counts). With the guard on, over the finite values only
    (a skipped step's NaN loss must not poison the window; NaN only if
    nothing was finite); with it off, a NaN mean is the divergence
    signal."""
    means = {}
    for k in (window[0] if window else {}):
        vals = torch.cat([m[k].float().reshape(-1) for m in window])
        if finite_only:
            vals = vals[torch.isfinite(vals)]
        means[k] = float(vals.mean()) if vals.numel() else float("nan")
    return means
