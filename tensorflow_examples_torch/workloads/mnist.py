"""MNIST dense-MLP workload: the port of
``tensorflow_examples_tpu/workloads/mnist.py``.

``MnistConfig`` keeps the reference's defaults: batch 256, 2000 steps,
Adam at 1e-3, two hidden layers of 128 with dropout 0.1, bf16 compute.
Softmax cross-entropy and accuracy in f32 (``ops/losses.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from tensorflow_examples_torch.core.sharding import REPLICATED
from tensorflow_examples_torch.data.sources import load_mnist
from tensorflow_examples_torch.models import mlp
from tensorflow_examples_torch.models.transformer import ParamView
from tensorflow_examples_torch.ops.losses import accuracy_metrics, softmax_cross_entropy
from tensorflow_examples_torch.train import optimizers
from tensorflow_examples_torch.train.config import TrainConfig
from tensorflow_examples_torch.train.task import Task


@dataclasses.dataclass
class MnistConfig(TrainConfig):
    global_batch_size: int = 256
    train_steps: int = 2000
    learning_rate: float = 1e-3
    hidden: int = 128
    num_layers: int = 2
    dropout: float = 0.1


def model_config(cfg: MnistConfig) -> mlp.MLPConfig:
    return mlp.MLPConfig(in_features=28 * 28, features=(cfg.hidden,) * cfg.num_layers,
                         num_classes=10, dropout_rate=cfg.dropout)


def make_task(cfg: MnistConfig, mesh=None) -> Task:
    """The task; on a mesh (``mesh``) the MLP is replicated and its
    batch rows split over the batch axes, which the trainer does alone."""
    del mesh
    mcfg = model_config(cfg)

    def init_fn(seed: int, device: torch.device):
        model = mlp.MLP(mcfg, seed=seed, device=device)
        return {"params": {k: p.detach() for k, p in model.named_parameters()}}

    def loss_fn(params, model_state, batch, *, rng, train):
        logits = mlp.forward(mcfg, ParamView(params), batch["image"], train=train,
                             noise=rng if train else None)
        loss = softmax_cross_entropy(logits, batch["label"])
        return loss, accuracy_metrics(logits, batch["label"]), model_state

    def eval_fn(params, model_state, batch):
        logits = mlp.forward(mcfg, ParamView(params), batch["image"])
        m = accuracy_metrics(logits, batch["label"], weights=batch["mask"])
        m["loss"] = softmax_cross_entropy(logits, batch["label"], weights=batch["mask"])
        return m

    return Task(name="mnist_mlp", init_fn=init_fn, loss_fn=loss_fn,
                make_optimizer=optimizers.adam, eval_fn=eval_fn, sharding_rules=REPLICATED)


def datasets(cfg: MnistConfig):
    return load_mnist(cfg.data_dir, "train"), eval_dataset(cfg)


def eval_dataset(cfg: MnistConfig):
    return load_mnist(cfg.data_dir, "test")
