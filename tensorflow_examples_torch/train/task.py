"""Task: what a workload defines to run on the shared loop (the port of
``tensorflow_examples_tpu/train/task.py``).

* ``init_fn(seed, device) -> {"params": {name: tensor}, ...}``: f32
  parameters (and any non-trainable collections, which become
  ``TrainState.model_state``);
* ``loss_fn(params, model_state, batch, *, rng, train) -> (loss,
  metrics, new_model_state)``: ``params`` in the compute dtype, ``rng``
  the step's random input, a staged ``core/rng.StepNoise`` (dropout and
  router jitter), ``batch`` tensors on the device;
* ``make_optimizer(config) -> GradientTransformation``;
* ``eval_fn(params, model_state, batch) -> metrics`` with an optional
  ``weight`` entry that weights the mean (padded-batch masking);
* ``eval_finalize(means) -> metrics``, optional: turns the weighted
  means into the final metrics where a score is a function of global
  means, not a mean itself (GLUE's F1 and MCC from confusion rates,
  Pearson from moments, ``ops/glue_metrics.py``);
* ``sharding_rules``, optional: the (param-path regex -> spec) table
  that places the parameters on a mesh (``core/sharding.py``); None
  replicates every parameter.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from tensorflow_examples_torch.train.config import TrainConfig
from tensorflow_examples_torch.train.optimizers import GradientTransformation

LossFn = Callable[..., tuple[torch.Tensor, Mapping[str, torch.Tensor], Any]]


@dataclasses.dataclass
class Task:
    name: str
    init_fn: Callable[[int, torch.device], Mapping[str, Any]]
    loss_fn: LossFn
    make_optimizer: Callable[[TrainConfig], GradientTransformation]
    eval_fn: Callable[..., Mapping[str, torch.Tensor]] | None = None
    eval_finalize: Callable[[dict], dict] | None = None
    sharding_rules: Any = None
