"""AdamW with a warmup-cosine schedule, global-norm clipping and gradient
accumulation: the port of ``adamw_cosine`` and its parts from
``tensorflow_examples_tpu/train/optimizers.py``.

optax's transformations are written out on tensors with optax's
arithmetic, so a port run takes the reference's updates:

* the schedule is a function of the update count, evaluated on the
  device in f32 (update 0 uses ``schedule(0)`` = 0 under warmup);
* ``clip_by_global_norm`` scales every gradient by ``max_norm / norm``
  when the global norm is at least ``max_norm``;
* AdamW: ``mu_hat / (sqrt(nu_hat) + eps)`` with eps outside the sqrt,
  plus decoupled decay ``wd * p``, times ``-lr``;
* ``MultiSteps``: the mean of ``k`` micro-batch gradients goes to the
  inner chain every ``k``-th step; the steps between return zero
  updates and leave the inner state alone.

An optimizer is a pair of functions like optax's: ``init(params) ->
state`` and ``update(grads, state, params) -> (updates, state)``, over
dicts of tensors; a state is a nested dict of tensors (counts are 0-d
device tensors, so nothing syncs with the host and an update can be
captured in a CUDA graph: no host value enters it after capture).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from tensorflow_examples_torch.train.config import TrainConfig


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable
    update: Callable


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensor leaves of nested dicts/tuples/lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(t.float().square()) for t in tree_leaves(tree)))


def _updates(cfg: TrainConfig, steps: int) -> int:
    """Loop steps -> optimizer updates: under accumulation the schedule
    ticks once per applied update."""
    return max(steps // max(cfg.grad_accum_steps, 1), 1)


def warmup_cosine(cfg: TrainConfig, *, end_value: float = 0.0) -> Callable:
    """optax ``warmup_cosine_decay_schedule(0, lr, warmup, decay, end)``:
    linear from 0 to the peak over ``warmup`` updates, then cosine to
    ``end_value`` at ``decay`` updates (decay includes warmup). Takes a
    count (int or tensor), returns an f32 tensor."""
    warmup = _updates(cfg, max(cfg.warmup_steps, 1))
    decay = max(_updates(cfg, cfg.train_steps), warmup + 1, 2)
    peak = cfg.learning_rate
    alpha = 0.0 if peak == 0.0 else end_value / peak

    def schedule(count):
        count = torch.as_tensor(count).float()
        frac = 1.0 - torch.clamp(count, 0.0, float(warmup)) / warmup
        linear = (0.0 - peak) * frac + peak
        since = torch.clamp(count - warmup, max=float(decay - warmup))
        cosine = 0.5 * (1.0 + torch.cos(math.pi * since / (decay - warmup)))
        decayed = peak * ((1.0 - alpha) * cosine + alpha)
        return torch.where(count < warmup, linear, decayed)

    return schedule


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(grads, state, params=None):
        norm = global_norm(grads)
        keep = norm < max_norm
        return tree_map(lambda g: torch.where(keep, g, g / norm.to(g.dtype) * max_norm),
                        grads), state

    return GradientTransformation(lambda params: {}, update)


def adamw(schedule: Callable, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax ``adamw``: scale_by_adam, add_decayed_weights,
    scale_by_learning_rate, in that order."""

    def init(params):
        device = next(iter(params.values())).device
        zeros = lambda p: torch.zeros_like(p)
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "lr_count": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params):
        count = state["count"] + 1
        # A Python base: no host tensor to copy, so a CUDA graph can hold it.
        c1 = 1.0 - torch.pow(b1, count.float())
        c2 = 1.0 - torch.pow(b2, count.float())
        mu = tree_map(lambda g, m: (1.0 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1.0 - b2) * (g * g) + b2 * v, grads, state["nu"])
        lr = schedule(state["lr_count"])

        def step(m, v, p):
            u = (m / c1.to(m.dtype)) / (torch.sqrt(v / c2.to(v.dtype)) + eps)
            return (u + weight_decay * p) * (-lr).to(u.dtype)

        updates = tree_map(step, mu, nu, params)
        return updates, {"count": count, "mu": mu, "nu": nu, "lr_count": state["lr_count"] + 1}

    return GradientTransformation(init, update)


def chain(*parts: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(p.init(params) for p in parts)

    def update(grads, state, params=None):
        new = []
        for part, st in zip(parts, state):
            grads, st = part.update(grads, st, params)
            new.append(st)
        return grads, tuple(new)

    return GradientTransformation(init, update)


def multi_steps(inner: GradientTransformation, k: int) -> GradientTransformation:
    """optax ``MultiSteps(inner, every_k_schedule=k)`` with the gradient
    mean."""

    def init(params):
        device = next(iter(params.values())).device
        return {"mini_step": torch.zeros((), dtype=torch.int32, device=device),
                "inner": inner.init(params),
                "acc": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        n = state["mini_step"]
        acc = tree_map(lambda g, a: a + (g - a) / (n + 1).to(a.dtype), grads, state["acc"])
        updates, new_inner = inner.update(acc, state["inner"], params)
        emit = n == k - 1
        return tree_map(lambda u: torch.where(emit, u, torch.zeros_like(u)), updates), {
            "mini_step": (n + 1) % k,
            "inner": tree_map(lambda new, old: torch.where(emit, new, old),
                              new_inner, state["inner"]),
            "acc": tree_map(lambda a: torch.where(emit, torch.zeros_like(a), a), acc),
        }

    return GradientTransformation(init, update)


def _maybe_wrap(cfg: TrainConfig, tx: GradientTransformation) -> GradientTransformation:
    """Clip (when ``grad_clip_norm`` > 0), then the optimizer; the whole
    chain under accumulation when ``grad_accum_steps`` > 1."""
    if cfg.grad_clip_norm > 0:
        tx = chain(clip_by_global_norm(cfg.grad_clip_norm), tx)
    if cfg.grad_accum_steps > 1:
        tx = multi_steps(tx, cfg.grad_accum_steps)
    return tx


def adamw_cosine(cfg: TrainConfig) -> GradientTransformation:
    """The GPT-2 optimizer: AdamW (b1 0.9, b2 0.95), warmup-cosine to
    0.1 x the peak rate, clipping and accumulation from the config."""
    return _maybe_wrap(cfg, adamw(warmup_cosine(cfg, end_value=0.1 * cfg.learning_rate),
                                  b1=0.9, b2=0.95, weight_decay=cfg.weight_decay))


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
