"""The workloads' optimizers and schedules: the port of ``adam``,
``adamw_cosine``, ``adamw_linear``, ``sgd_momentum_cosine`` and ``lars``
and their parts from ``tensorflow_examples_tpu/train/optimizers.py``,
with global-norm clipping and gradient accumulation.

optax's transformations are written out on tensors with optax's
arithmetic, so a port run takes the reference's updates:

* a schedule is a function of the update count, evaluated on the
  device in f32 (update 0 uses ``schedule(0)`` = 0 under warmup):
  warmup-cosine, warmup-linear (optax ``join_schedules`` of two
  ``linear_schedule``s) or a constant;
* ``clip_by_global_norm`` scales every gradient by ``max_norm / norm``
  when the global norm is at least ``max_norm``;
* Adam(W): ``mu_hat / (sqrt(nu_hat) + eps)`` with eps outside the sqrt,
  plus decoupled decay ``wd * p`` (every parameter: optax's default has
  no mask), times ``-lr``;
* SGD: ``add_decayed_weights`` (``g + wd * p``), then optax's ``trace``
  with Nesterov momentum (``t = g + m t``, update ``g + m t``), times
  ``-lr``;
* LARS (optax ``lars``): ``add_decayed_weights``, then each tensor
  scaled by its trust ratio ``tc * |p| / (|u| + eps)`` (1 where either
  norm is 0), times ``-lr``, then the momentum ``trace`` (no Nesterov):
  the learning rate enters before the momentum, as optax chains it;
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

import contextlib
import contextvars
import dataclasses
import math
from typing import Callable

import torch

from tensorflow_examples_torch.train.config import TrainConfig


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable
    update: Callable
    # True where the update reads a whole tensor's norm (LARS's trust
    # ratio), which a rank holding a shard of the tensor cannot compute.
    whole_tensors: bool = False


# Set by sharded_norms: maps {name: this rank's sum of squares} to the
# global sum, for a step whose tensors are this rank's shards.
_SUMSQ_REDUCE: contextvars.ContextVar = contextvars.ContextVar("sumsq_reduce", default=None)


@contextlib.contextmanager
def sharded_norms(reduce: Callable):
    """Within: :func:`global_norm` of a ``{name: tensor}`` dict sums each
    tensor's squares through ``reduce({name: local sum of squares}) ->
    global sum``, so clipping and the reported norm see the whole
    gradient when each rank holds shards of it (``sharding/layout.py``)."""
    token = _SUMSQ_REDUCE.set(reduce)
    try:
        yield
    finally:
        _SUMSQ_REDUCE.reset(token)


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
    """sqrt of the sum of squares of every leaf, in f32 (across ranks
    inside :func:`sharded_norms`)."""
    reduce = _SUMSQ_REDUCE.get()
    if reduce is not None and isinstance(tree, dict):
        return torch.sqrt(reduce({k: torch.sum(t.float().square()) for k, t in tree.items()}))
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


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable:
    """optax ``linear_schedule``: from ``init_value`` to ``end_value``
    over ``transition_steps`` counts, then held."""

    def schedule(count):
        count = torch.clamp(torch.as_tensor(count), 0, transition_steps).float()
        frac = 1.0 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def warmup_linear(cfg: TrainConfig) -> Callable:
    """The BERT fine-tune schedule: linear from 0 to the peak rate over
    ``warmup`` updates, then linear to 0 at ``train_steps`` (optax
    ``join_schedules`` with the boundary at ``warmup``)."""
    warmup = _updates(cfg, max(cfg.warmup_steps, 1))
    rise = linear_schedule(0.0, cfg.learning_rate, warmup)
    fall = linear_schedule(cfg.learning_rate, 0.0, max(_updates(cfg, cfg.train_steps) - warmup, 1))

    def schedule(count):
        count = torch.as_tensor(count)
        return torch.where(count < warmup, rise(count), fall(count - warmup))

    return schedule


def constant(value: float) -> Callable:
    """A fixed rate, as an f32 tensor on the count's device."""
    return lambda count: torch.full((), value, dtype=torch.float32,
                                    device=torch.as_tensor(count).device)


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
    scale_by_learning_rate, in that order; ``weight_decay`` 0 is optax
    ``adam``."""

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
            if weight_decay:
                u = u + weight_decay * p
            return u * (-lr).to(u.dtype)

        updates = tree_map(step, mu, nu, params)
        return updates, {"count": count, "mu": mu, "nu": nu, "lr_count": state["lr_count"] + 1}

    return GradientTransformation(init, update)


def sgd(schedule: Callable, *, momentum: float = 0.9, nesterov: bool = True,
        weight_decay: float = 0.0) -> GradientTransformation:
    """optax ``chain(add_decayed_weights(weight_decay), sgd(schedule,
    momentum, nesterov))``: the decay (when nonzero), the momentum trace,
    then ``-lr``."""

    def init(params):
        device = next(iter(params.values())).device
        return {"trace": tree_map(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        trace = tree_map(lambda g, t: g + momentum * t, grads, state["trace"])
        updates = tree_map(lambda g, t: g + momentum * t, grads, trace) if nesterov else trace
        step = -schedule(state["count"])
        return (tree_map(lambda u: step.to(u.dtype) * u, updates),
                {"trace": trace, "count": state["count"] + 1})

    return GradientTransformation(init, update)


def lars_transform(schedule: Callable, *, weight_decay: float = 0.0,
                   trust_coefficient: float = 0.001, eps: float = 0.0, momentum: float = 0.9,
                   nesterov: bool = False) -> GradientTransformation:
    """optax ``lars(schedule, weight_decay, trust_coefficient, eps,
    momentum=momentum, nesterov=nesterov)`` with its default masks (every
    tensor decays and is trust-scaled): ``add_decayed_weights``,
    ``scale_by_trust_ratio``, ``scale_by_learning_rate``, ``trace``."""

    def init(params):
        device = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "trace": tree_map(torch.zeros_like, params)}

    def trust(u, p):
        p_norm = torch.sqrt(torch.sum(p * p))
        u_norm = torch.sqrt(torch.sum(u * u))
        ratio = trust_coefficient * p_norm / (u_norm + eps)
        one = torch.ones((), dtype=p.dtype, device=p.device)
        return u * torch.where((p_norm == 0.0) | (u_norm == 0.0), one, ratio)

    def update(grads, state, params):
        u = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        u = tree_map(trust, u, params)
        step = -schedule(state["count"])
        u = tree_map(lambda x: step.to(x.dtype) * x, u)
        trace = tree_map(lambda x, t: x + momentum * t, u, state["trace"])
        updates = tree_map(lambda x, t: x + momentum * t, u, trace) if nesterov else trace
        return updates, {"count": state["count"] + 1, "trace": trace}

    return GradientTransformation(init, update, whole_tensors=True)


def chain(*parts: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(p.init(params) for p in parts)

    def update(grads, state, params=None):
        new = []
        for part, st in zip(parts, state):
            grads, st = part.update(grads, st, params)
            new.append(st)
        return grads, tuple(new)

    return GradientTransformation(init, update, any(p.whole_tensors for p in parts))


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

    return GradientTransformation(init, update, inner.whole_tensors)


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


def adam(cfg: TrainConfig) -> GradientTransformation:
    """The MNIST optimizer: Adam at the constant ``learning_rate``."""
    return _maybe_wrap(cfg, adamw(constant(cfg.learning_rate), weight_decay=0.0))


def adamw_linear(cfg: TrainConfig) -> GradientTransformation:
    """The BERT fine-tune optimizer: AdamW (b2 0.999, eps 1e-6) under
    warmup-linear."""
    return _maybe_wrap(cfg, adamw(warmup_linear(cfg), b1=0.9, b2=0.999, eps=1e-6,
                                  weight_decay=cfg.weight_decay))


def sgd_momentum_cosine(cfg: TrainConfig, *, nesterov: bool = True) -> GradientTransformation:
    """The ResNet optimizer: weight decay, then SGD with (Nesterov)
    momentum 0.9 under warmup-cosine to 0."""
    return _maybe_wrap(cfg, sgd(warmup_cosine(cfg), momentum=0.9, nesterov=nesterov,
                                weight_decay=cfg.weight_decay))


def lars(cfg: TrainConfig) -> GradientTransformation:
    """LARS for large-batch ResNet-50: momentum 0.9 under warmup-cosine to
    0, weight decay from the config, optax's trust coefficient (0.001),
    eps (0) and masks."""
    return _maybe_wrap(cfg, lars_transform(warmup_cosine(cfg), weight_decay=cfg.weight_decay,
                                           momentum=0.9))


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
