"""CIFAR-10 ResNet-20 workload: the port of
``tensorflow_examples_tpu/workloads/cifar10.py``.

``Cifar10Config`` keeps the reference's recipe: batch 128, 64 000
steps, SGD with Nesterov momentum 0.9 and weight decay 1e-4 under
warmup-cosine from 0.1 (warmup 400), bf16 compute with f32 BatchNorm
statistics and head, and crop/flip augmentation on the host
(``data/augment.cifar_augment``: real data stays uint8 so the crop,
flip and normalize run fused in the native library). The BatchNorm
running statistics are ``TrainState.model_state["batch_stats"]``: a
training step returns them updated, eval normalizes with them. On a
mesh the parameters are replicated (``REPLICATED``, the reference's
rules) and the batch's rows split over the batch axes, whose ranks sum
each BatchNorm's moments.
"""

from __future__ import annotations

import dataclasses

import torch

from tensorflow_examples_torch.data.augment import cifar_augment
from tensorflow_examples_torch.data.sources import load_cifar10
from tensorflow_examples_torch.core.sharding import REPLICATED
from tensorflow_examples_torch.models import resnet
from tensorflow_examples_torch.ops.losses import accuracy_metrics, softmax_cross_entropy
from tensorflow_examples_torch.train import optimizers
from tensorflow_examples_torch.train.config import TrainConfig
from tensorflow_examples_torch.train.task import Task


@dataclasses.dataclass
class Cifar10Config(TrainConfig):
    global_batch_size: int = 128
    train_steps: int = 64000
    warmup_steps: int = 400
    learning_rate: float = 0.1
    weight_decay: float = 1e-4
    eval_every: int = 4000
    checkpoint_every: int = 4000
    augment: bool = True


def make_task(cfg: Cifar10Config, mesh=None) -> Task:
    """The task; ``mesh``: the ``core/mesh.Mesh`` the trainer runs on
    (None: one device). The parameters are replicated on it, and a
    training step's BatchNorm moments are summed over its batch axes
    (``models/resnet.py``)."""
    mcfg = resnet.resnet20(num_classes=10)

    def init_fn(seed: int, device: torch.device):
        return resnet.variables(resnet.ResNet(mcfg, seed=seed, device=device))

    def loss_fn(params, model_state, batch, *, rng, train):
        logits, stats = resnet.apply(mcfg, params, model_state["batch_stats"], batch["image"],
                                     train=train, mesh=mesh)
        loss = softmax_cross_entropy(logits, batch["label"])
        return loss, accuracy_metrics(logits, batch["label"]), {"batch_stats": stats}

    def eval_fn(params, model_state, batch):
        logits, _ = resnet.apply(mcfg, params, model_state["batch_stats"], batch["image"])
        m = accuracy_metrics(logits, batch["label"], weights=batch["mask"])
        m["loss"] = softmax_cross_entropy(logits, batch["label"], weights=batch["mask"])
        return m

    return Task(name="cifar10_resnet20", init_fn=init_fn, loss_fn=loss_fn,
                make_optimizer=optimizers.sgd_momentum_cosine, eval_fn=eval_fn,
                sharding_rules=REPLICATED)


def datasets(cfg: Cifar10Config):
    """(train, eval): real training data stays uint8 when augmenting, so
    the crop, flip and normalize run fused in the native library."""
    return load_cifar10(cfg.data_dir, "train", normalized=not cfg.augment), eval_dataset(cfg)


def eval_dataset(cfg: Cifar10Config):
    return load_cifar10(cfg.data_dir, "test")


def train_augment(cfg: Cifar10Config):
    return cifar_augment if cfg.augment else None
