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
the sinks and the checkpoint writer. Meshes are a later slice. The
trainer runs on ``cuda`` unless ``config.device`` is ``cpu``, and
raises without a GPU.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import sys
import time
from typing import Callable, Iterable, Iterator, Mapping

import numpy as np
import torch

from tensorflow_examples_torch.core import nans, rng
from tensorflow_examples_torch.core.device import resolve_device
from tensorflow_examples_torch.core.precision import PrecisionPolicy
from tensorflow_examples_torch.data.prefetch import bundle_batches, device_prefetch, put_batch
from tensorflow_examples_torch.models.convert import flatten_tree
from tensorflow_examples_torch.telemetry.compilation import CompilationSentinel
from tensorflow_examples_torch.telemetry.hub import Telemetry
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
        log.info("initialized %s: %.2fM params on %s", self.task.name, self.n_params / 1e6,
                 self.device)
        return TrainState.create(params=params, tx=self.task.make_optimizer(self.config),
                                 model_state=variables)

    # ------------------------------------------------------------- steps

    def put_batch(self, batch: Mapping) -> dict[str, torch.Tensor]:
        return put_batch(batch, self.device)

    def step_key(self, step: int) -> np.ndarray:
        """Step ``step``'s key: ``step_rng(PRNGKey(seed + 1), step)``."""
        return rng.step_rng(self._seed_key, step)

    def _train_step(self, state: TrainState, batch: Mapping[str, torch.Tensor], noise=None):
        """One step; ``noise`` (default: the trainer's own, staged from the
        step key) supplies dropout and router jitter. ``state.step`` is an
        int, or a device tensor inside a captured graph."""
        if noise is None:
            noise = self._noise.stage(self.step_key(state.step))
        debug = self.config.debug_nans
        leaves = {k: p.detach().requires_grad_(True) for k, p in state.params.items()}
        with (_debug_nans(state.step) if debug else contextlib.nullcontext()):
            loss, metrics, new_model_state = self.task.loss_fn(
                self.policy.cast_compute(leaves), state.model_state,
                self.policy.cast_compute(batch), rng=noise, train=True,
            )
            nans.check_finite(loss, "the loss")
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
        # Config mistakes raise before any handler or thread exists.
        faults_engine = faults.active()
        guard = self._guard = resilience.BadStepGuard.from_config(cfg)
        telemetry = self.telemetry = Telemetry.from_config(cfg, n_params=self.n_params,
                                                           device=self.device)
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
        try:
            if cfg.workdir:
                self._ckpt = CheckpointManager(cfg.workdir)
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
                return device_prefetch(src if k == 1 else bundle_batches(src, k), self.device,
                                       depth=max(cfg.prefetch_depth, 1),
                                       depth_max=cfg.prefetch_depth_max,
                                       max_skips=cfg.max_skipped_batches)

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
            exc = sys.exc_info()[1]
            if exc is not None and not isinstance(exc, resilience.Preempted) and emit_final:
                try:
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
    def evaluate(self, eval_iter: Iterable) -> dict[str, float]:
        """Weighted mean of ``task.eval_fn`` over ``eval_iter``'s batches
        (each batch's ``weight`` entry, else 1), through
        ``task.eval_finalize`` when the task has one."""
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
        means = {k: float(v) / max(float(count), 1.0) for k, v in totals.items()}
        if self.task.eval_finalize is not None:
            means = dict(self.task.eval_finalize(means))
        return means


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
