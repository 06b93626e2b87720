"""TrainState: everything a training step reads and writes.

The port of ``tensorflow_examples_tpu/train/state.py``. ``params`` is a
flat ``{name: tensor}`` dict of f32 masters (a :class:`GPT2`'s parameter
names, which are the reference's param paths with ``.`` for ``/``);
``opt_state`` is the optimizer's nested dict of tensors; ``step`` a
Python int. A step builds a new state (JAX's functional update, kept so
the bad-step guard can choose between old and new on the device).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from tensorflow_examples_torch.train import optimizers


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict[str, torch.Tensor]
    opt_state: Any
    # Non-trainable collections (running statistics); {} when stateless.
    model_state: dict = dataclasses.field(default_factory=dict)
    tx: optimizers.GradientTransformation | None = None

    @classmethod
    def create(cls, *, params, tx, model_state=None) -> "TrainState":
        return cls(step=0, params=params, opt_state=tx.init(params),
                   model_state={} if model_state is None else model_state, tx=tx)

    def apply_gradients(self, grads) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
        return dataclasses.replace(self, step=self.step + 1,
                                   params=optimizers.apply_updates(self.params, updates),
                                   opt_state=opt_state)

    def byte_breakdown(self) -> dict[str, int]:
        """Tensor bytes per state component: params, optimizer state and
        non-trainable collections."""
        size = lambda tree: sum(t.numel() * t.element_size()
                                for t in optimizers.tree_leaves(tree))
        return {"params": size(self.params), "opt_state": size(self.opt_state),
                "model_state": size(self.model_state)}
