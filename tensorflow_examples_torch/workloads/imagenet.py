"""ResNet on ImageNet: the port of
``tensorflow_examples_tpu/workloads/imagenet.py``.

``ImagenetConfig`` keeps the reference's 90-epoch recipe at global batch
1024: ResNet-50 at 224 px over 1000 classes, SGD with Nesterov momentum
0.9 and weight decay 1e-4 under warmup-cosine from 0.4 (warmup 6255),
label smoothing 0.1, bf16 compute with f32 BatchNorm statistics and
head; ``optimizer="lars"`` takes LARS for large batches. Eval reports
``accuracy``, ``top5_accuracy`` and the unsmoothed loss under the
batch's ``mask``. On a mesh the parameters are replicated and the
batch axes' ranks sum each BatchNorm's moments (``models/resnet.py``).

The workload streams its data (the protocol ``train/cli.py`` reads):
``make_train_iter(cfg, start)`` and ``make_eval_iter(cfg)`` read
``train-*`` and ``validation-*`` TFRecord shards under ``data_dir``
through ``data/imagenet.parallel_tfrecord_iter`` (``input_readers``
shard readers, ``input_workers`` decode workers, 0 decoding inline),
and otherwise the seeded synthetic streams.
"""

from __future__ import annotations

import dataclasses

import torch

from tensorflow_examples_torch.data import imagenet as imagenet_data
from tensorflow_examples_torch.core.sharding import REPLICATED
from tensorflow_examples_torch.models import resnet
from tensorflow_examples_torch.ops.losses import accuracy_metrics, softmax_cross_entropy
from tensorflow_examples_torch.train import optimizers
from tensorflow_examples_torch.train.config import TrainConfig
from tensorflow_examples_torch.train.task import Task


@dataclasses.dataclass
class ImagenetConfig(TrainConfig):
    # The 90-epoch recipe at batch 1024: lr 0.4 (0.1 x batch / 256) cosine
    # with a 5-epoch warmup, weight decay 1e-4, label smoothing 0.1.
    image_size: int = 224
    num_classes: int = 1000
    model: str = "resnet50"  # resnet18|34|50|101|152
    label_smoothing: float = 0.1
    optimizer: str = "sgd"  # sgd | lars (large batch)
    global_batch_size: int = 1024
    train_steps: int = 112590  # 90 epochs x 1.28M / 1024
    warmup_steps: int = 6255
    learning_rate: float = 0.4
    weight_decay: float = 1e-4
    eval_every: int = 5000
    checkpoint_every: int = 5000
    eval_batches: int = 8  # the synthetic eval's length (shards: the whole split)
    # The reference's switch between its exact-resume tf.data stream and a
    # faster one; the port's shard stream is always exact and resumable.
    deterministic_input: bool = True


def make_task(cfg: ImagenetConfig, mesh=None) -> Task:
    """The task; ``mesh``: the ``core/mesh.Mesh`` the trainer runs on
    (None: one device). The parameters are replicated on it, and a
    training step's BatchNorm moments are summed over its batch axes
    (``models/resnet.py``)."""
    depth = getattr(resnet, cfg.model, None)
    if depth is None:
        raise ValueError(f"unknown --model={cfg.model}; one of resnet18/34/50/101/152")
    mcfg = depth(num_classes=cfg.num_classes)

    def init_fn(seed: int, device: torch.device):
        return resnet.variables(resnet.ResNet(mcfg, seed=seed, device=device))

    def loss_fn(params, model_state, batch, *, rng, train):
        logits, stats = resnet.apply(mcfg, params, model_state["batch_stats"], batch["image"],
                                     train=train, mesh=mesh)
        loss = softmax_cross_entropy(logits, batch["label"],
                                     label_smoothing=cfg.label_smoothing)
        return loss, accuracy_metrics(logits, batch["label"]), {"batch_stats": stats}

    def eval_fn(params, model_state, batch):
        logits, _ = resnet.apply(mcfg, params, model_state["batch_stats"], batch["image"])
        m = accuracy_metrics(logits, batch["label"], weights=batch["mask"], top5=True)
        m["loss"] = softmax_cross_entropy(logits, batch["label"], weights=batch["mask"])
        return m

    return Task(name=f"imagenet_{cfg.model}", init_fn=init_fn, loss_fn=loss_fn,
                make_optimizer=(optimizers.lars if cfg.optimizer == "lars"
                                else optimizers.sgd_momentum_cosine),
                eval_fn=eval_fn, sharding_rules=REPLICATED)


def train_iter_is_per_host(cfg: ImagenetConfig) -> bool:
    """Shards are split by host (each yields its share of the batch);
    the synthetic stream is the same on every host."""
    return imagenet_data.has_tfrecords(cfg.data_dir, "train")


def make_train_iter(cfg: ImagenetConfig, start_step: int):
    if imagenet_data.has_tfrecords(cfg.data_dir, "train"):
        return imagenet_data.parallel_tfrecord_iter(
            cfg.data_dir, "train", cfg.global_batch_size, train=True,
            image_size=cfg.image_size, seed=cfg.seed, num_readers=max(cfg.input_readers, 1),
            num_workers=cfg.input_workers, start_step=start_step)
    return imagenet_data.synthetic_train_iter(cfg.global_batch_size, image_size=cfg.image_size,
                                              num_classes=cfg.num_classes, seed=cfg.seed,
                                              start_step=start_step)


def make_eval_iter(cfg: ImagenetConfig):
    batch = max(cfg.eval_batch_size or cfg.global_batch_size, 1)
    if imagenet_data.has_tfrecords(cfg.data_dir, "validation"):
        return imagenet_data.parallel_tfrecord_iter(
            cfg.data_dir, "validation", batch, train=False, image_size=cfg.image_size,
            num_readers=max(cfg.input_readers, 1), num_workers=cfg.input_workers)
    return imagenet_data.synthetic_eval_iter(batch, image_size=cfg.image_size,
                                             num_classes=cfg.num_classes,
                                             batches=cfg.eval_batches, seed=1)
