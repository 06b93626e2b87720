"""The shared training loop: the port of the single-device path of
``tensorflow_examples_tpu/train/loop.py``.

One step (``Trainer._train_step``) is the reference's: the loss and its
gradient with respect to the f32 master parameters, cast to the compute
dtype on the way in (``core/precision.py``); the optimizer update; the
f32 global gradient norm; and the bad-step guard compiled into the
reference's step, here a select on the device: with
``bad_step_policy="skip"`` a step whose loss or gradient norm is not
finite keeps the old parameters and optimizer state while ``step``
still advances, and reports ``bad_step`` = 1. Nothing syncs with the
host on the happy path except the log windows. Dropout keys are
``step_rng(PRNGKey(seed + 1), step)``, as in the reference.

``fit`` runs steps from an iterator (or a ``start_step -> iterator``
callable), logs one line per ``log_every`` window with the window's mean
metrics and step time, runs ``evaluate`` every ``eval_every`` steps, and
keeps each window's numbers in ``history``. Meshes, checkpoints,
prefetch, telemetry sinks, the watchdog and the host-side escalation of
repeated bad steps are later slices. The trainer runs on ``cuda`` unless
``config.device`` is ``cpu``, and raises without a GPU.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Iterator, Mapping

import numpy as np
import torch

from tensorflow_examples_torch.core import rng
from tensorflow_examples_torch.core.device import resolve_device
from tensorflow_examples_torch.core.precision import PrecisionPolicy
from tensorflow_examples_torch.models.convert import flatten_tree
from tensorflow_examples_torch.train import optimizers
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
        self._guard = config.bad_step_policy not in ("off", "")
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
            if self._guard:
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
        ``config.train_steps``); returns the last window's metrics (and
        the last eval's, prefixed ``eval_``)."""
        cfg = self.config
        num_steps = cfg.train_steps if num_steps is None else num_steps
        it = train_data(self.state.step) if callable(train_data) else iter(train_data)
        window: list[dict] = []
        last: dict[str, float] = {}
        t_window = time.perf_counter()
        while self.state.step < num_steps:
            window.append(self.train_step(next(it)))
            step = self.state.step
            if (cfg.log_every and step % cfg.log_every == 0) or step == num_steps:
                means = {k: float(torch.stack([m[k] for m in window]).float().mean())
                         for k in window[0]}
                dt = time.perf_counter() - t_window  # the float() above synced
                means["step_time_s"] = dt / len(window)
                means["examples_per_sec"] = len(window) * cfg.global_batch_size / dt
                log.info("step %d: %s", step,
                         " ".join(f"{k} {v:.6g}" for k, v in sorted(means.items())))
                self.history.append({"step": step, **means})
                last.update(means)
                window.clear()
                t_window = time.perf_counter()
            if cfg.eval_every and eval_iter_fn is not None and step % cfg.eval_every == 0:
                metrics = self.evaluate(eval_iter_fn())
                log.info("step %d: eval %s", step, metrics)
                last.update({f"eval_{k}": v for k, v in metrics.items()})
                t_window = time.perf_counter()
        return last

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
