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
host on the happy path except the log windows. Dropout keys are
``step_rng(PRNGKey(seed + 1), step)``, as in the reference.

``fit`` runs steps from an iterator (or a ``start_step -> iterator``
callable, which makes resume and rollback replay exact) and has the
reference's exit paths: with a ``workdir`` it restores the latest
checkpoint when ``resume`` is set, saves every ``checkpoint_every``
steps and at the end (``train/checkpoint.py``); SIGTERM/SIGINT save at
the next step boundary and raise ``Preempted`` (exit code 0); the host
guard (``train/resilience.py``) escalates repeated bad steps to a
rollback or an abort. Each log window lands a telemetry line
(``telemetry/hub.py``) and keeps the window's means in ``history``;
every exit path lands a ``final`` line and closes the sinks and the
checkpoint writer. Meshes, prefetch, the watchdog and profiler windows
are later slices. The trainer runs on ``cuda`` unless ``config.device``
is ``cpu``, and raises without a GPU.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Callable, Iterable, Iterator, Mapping

import numpy as np
import torch

from tensorflow_examples_torch.core import rng
from tensorflow_examples_torch.core.device import resolve_device
from tensorflow_examples_torch.core.precision import PrecisionPolicy
from tensorflow_examples_torch.models.convert import flatten_tree
from tensorflow_examples_torch.telemetry.hub import Telemetry
from tensorflow_examples_torch.train import optimizers, resilience
from tensorflow_examples_torch.train.checkpoint import CheckpointManager
from tensorflow_examples_torch.train.config import TrainConfig
from tensorflow_examples_torch.train.state import TrainState
from tensorflow_examples_torch.train.task import Task

log = logging.getLogger(__name__)


class Trainer:
    """Runs a :class:`Task` under a :class:`TrainConfig` on one device.

    ``init_params``: an optional param tree in the reference's layout
    (nested dicts of arrays, or ``/``-joined flat keys) that replaces the
    task's random init, e.g. weights carried over from the JAX package.
    """

    def __init__(self, task: Task, config: TrainConfig, *, init_params: Mapping | None = None):
        self.task = task
        self.config = config
        self.device = resolve_device(config.device)
        if self.device.type == "cuda":
            # f32 means f32: TF32 matmuls keep ~3 decimal digits.
            torch.backends.cuda.matmul.allow_tf32 = False
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
        log.info("initialized %s: %.2fM params on %s", self.task.name, self.n_params / 1e6,
                 self.device)
        return TrainState.create(params=params, tx=self.task.make_optimizer(self.config),
                                 model_state=variables)

    # ------------------------------------------------------------- steps

    def put_batch(self, batch: Mapping) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _train_step(self, state: TrainState, batch: Mapping[str, torch.Tensor]):
        key = rng.step_rng(self._seed_key, state.step)
        leaves = {k: p.detach().requires_grad_(True) for k, p in state.params.items()}
        loss, metrics, new_model_state = self.task.loss_fn(
            self.policy.cast_compute(leaves), state.model_state,
            self.policy.cast_compute(batch), rng=key, train=True,
        )
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        with torch.no_grad():
            new_state = state.apply_gradients(grads)
            new_state.model_state = new_model_state
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["loss"] = loss.detach().float()
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

    def train_step(self, batch: Mapping) -> dict[str, torch.Tensor]:
        """One step on a host or device batch; metrics stay on the device."""
        self.state, metrics = self._train_step(self.state, self.put_batch(batch))
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
        # Config mistakes raise before any handler is installed.
        guard = self._guard = resilience.BadStepGuard.from_config(cfg)
        telemetry = self.telemetry = Telemetry.from_config(cfg, n_params=self.n_params,
                                                           device=self.device)
        preempt = resilience.PreemptionGuard().install() if cfg.preempt_checkpoint else None
        window: list[dict] = []
        emit_final = None
        try:
            if cfg.workdir:
                self._ckpt = CheckpointManager(cfg.workdir)
                if cfg.resume:
                    restored = self._ckpt.restore_latest(self.state)
                    if restored is not None:
                        self.state = restored[0]
            telemetry.note_memory_init(self.state, step=self.state.step)
            resumable = callable(train_data) and not hasattr(train_data, "__next__")
            build_iter = train_data if resumable else None
            it = train_data(self.state.step) if resumable else iter(train_data)
            last: dict[str, float] = {}
            evaluated_now = False
            stepped_once = False  # the first step pays first-call set-up

            def emit_final(reason: str) -> None:
                telemetry.note_steps(len(window))
                means = _window_means(window, guard is not None)
                window.clear()
                telemetry.final_window(self.state.step, means, exit_reason=reason)

            t_window = t_iter = time.perf_counter()
            while True:
                if guard is not None and guard.poll(
                        drain=self.state.step >= num_steps) == "rollback":
                    it = self._rollback_to_checkpoint(guard, build_iter, it)
                    telemetry.note_steps(len(window))  # discarded, but stepped
                    window.clear()
                    t_window = t_iter = time.perf_counter()
                    continue
                if self.state.step >= num_steps:
                    break
                with telemetry.span("data_fetch"):
                    batch = next(it)
                with telemetry.span("device_step"):
                    metrics = self.train_step(batch)
                step = self.state.step
                if stepped_once:
                    telemetry.record_step_time(time.perf_counter() - t_iter)
                stepped_once = True
                window.append(metrics)
                if guard is not None:
                    guard.observe(step - 1, metrics)
                if (cfg.log_every and step % cfg.log_every == 0) or step == num_steps:
                    with telemetry.span("metric_flush"):
                        means = _window_means(window, guard is not None)  # syncs
                        dt = time.perf_counter() - t_window
                        means["step_time_s"] = dt / len(window)
                        means["steps_per_sec"] = len(window) / dt
                        means["examples_per_sec"] = len(window) * cfg.global_batch_size / dt
                        self.history.append({"step": step, **means})
                        last.update(means)
                        telemetry.note_steps(len(window))
                        window.clear()
                        telemetry.log_window(step, means)
                        t_window = time.perf_counter()
                if preempt is not None and preempt.requested:
                    # Before the eval: the kill grace window is ticking.
                    self._preempt_exit(step, preempt, emit_final)
                evaluated_now = False
                if cfg.eval_every and eval_iter_fn is not None and step % cfg.eval_every == 0:
                    with telemetry.span("eval"):
                        eval_metrics = self.evaluate(eval_iter_fn())
                    telemetry.log_window(step, eval_metrics, prefix="eval", kind="eval")
                    last.update({f"eval_{k}": v for k, v in eval_metrics.items()})
                    evaluated_now = step == num_steps
                    t_window = time.perf_counter()
                if self._ckpt and cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                    self._ckpt.save(step, self.state)
                if preempt is not None and preempt.requested:
                    self._preempt_exit(step, preempt, emit_final)
                t_iter = time.perf_counter()

            if preempt is not None and preempt.requested:
                self._preempt_exit(self.state.step, preempt, emit_final)
            if eval_iter_fn is not None and not evaluated_now:
                with telemetry.span("eval"):
                    eval_metrics = self.evaluate(eval_iter_fn())
                telemetry.log_window(self.state.step, eval_metrics, prefix="eval", kind="eval")
                last.update({f"eval_{k}": v for k, v in eval_metrics.items()})
            if self._ckpt and self._ckpt.latest_step() != self.state.step:
                self._ckpt.save(self.state.step, self.state)
            emit_final("complete")
            return last
        finally:
            if preempt is not None:
                preempt.uninstall()
            exc = sys.exc_info()[1]
            if exc is not None and not isinstance(exc, resilience.Preempted) and emit_final:
                try:
                    emit_final(f"error:{type(exc).__name__}")
                except Exception:  # pragma: no cover - telemetry is best effort here
                    log.exception("final telemetry line failed")
            telemetry.close()
            if self._ckpt is not None:
                try:
                    self._ckpt.close()
                finally:
                    self._ckpt = None

    def _preempt_exit(self, step: int, preempt, emit_final) -> None:
        """Synchronous checkpoint, the final line, then a clean exit."""
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
    def evaluate(self, eval_iter: Iterable) -> dict[str, float]:
        """Weighted mean of ``task.eval_fn`` over ``eval_iter``'s batches
        (each batch's ``weight`` entry, else 1)."""
        if self.task.eval_fn is None:
            return {}
        params = self.policy.cast_compute(self.state.params)
        totals: dict[str, torch.Tensor] = {}
        count = None
        for batch in eval_iter:
            m = dict(self.task.eval_fn(params, self.state.model_state,
                                       self.policy.cast_compute(self.put_batch(batch))))
            w = m.pop("weight", torch.ones((), device=self.device)).float()
            for k, v in m.items():
                totals[k] = totals[k] + v.float() * w if k in totals else v.float() * w
            count = w if count is None else count + w
        if count is None:
            return {}
        return {k: float(v) / max(float(count), 1.0) for k, v in totals.items()}


def _window_means(window: list[dict], finite_only: bool) -> dict[str, float]:
    """Each metric's mean over the window. With the guard on, over the
    finite values only (a skipped step's NaN loss must not poison the
    window; NaN only if nothing was finite); with it off, a NaN mean is
    the divergence signal."""
    means = {}
    for k in (window[0] if window else {}):
        vals = torch.stack([m[k].float() for m in window])
        if finite_only:
            vals = vals[torch.isfinite(vals)]
        means[k] = float(vals.mean()) if vals.numel() else float("nan")
    return means
