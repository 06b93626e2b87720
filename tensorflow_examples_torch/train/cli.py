"""Train a workload with the PyTorch/CUDA port.

    python -m tensorflow_examples_torch.train.cli --workload gpt2 --train_steps 20
    python -m tensorflow_examples_torch.train.cli --workload bert_glue --task cola
    python -m tensorflow_examples_torch.train.cli --workload cifar10
    python -m tensorflow_examples_torch.train.cli --workload mnist
    python -m tensorflow_examples_torch.train.cli --workload imagenet [--data_dir SHARDS]

Every field of the workload's config dataclass is a flag of the same
name (the counterpart of the reference's ``define_flags_from_config``);
booleans take true/false. Runs on ``cuda`` unless ``--device cpu``.
Without ``--data_dir`` the data are the seeded synthetic sets. A
workload that streams (ImageNet) defines ``make_train_iter(cfg, start)``
and ``make_eval_iter(cfg)``, which feed the trainer directly;
the others hold their sets in memory (``data/memory.py``), and a
workload's ``train_augment(cfg)``, where it has one, augments each
training batch on the host (CIFAR-10's crop and flip). With
``--workdir`` the run checkpoints there every ``--checkpoint_every``
steps and at the end, resumes from the latest checkpoint (unless
``--resume false``), writes ``telemetry/metrics.jsonl`` and
``telemetry/trace.json``, and exits 0 after checkpointing on SIGTERM.
Hard-fault tracebacks go to ``<workdir>/debugging/`` and file reads
retry ``--io_retries`` times (``utils/``), as the reference's CLI sets
up; ``TPU_FAULT_INJECT`` arms the fault plan of ``utils/faults.py``.
Prints the final metrics, the final eval's included, as one JSON line.
``python -m tensorflow_examples_torch.train.eval`` evaluates the latest
checkpoint of a workdir.

On a mesh, one process a rank under ``torchrun``:

    torchrun --nproc_per_node 2 -m tensorflow_examples_torch.train.cli \
        --mesh_data 2 --workdir /tmp/run   # or --mesh_fsdp / --mesh_model /
                                           # --mesh_context / --mesh_pipe, --zero1 true

The process group starts from ``torchrun``'s environment
(``core/distributed.initialize``: NCCL with a card a rank, gloo when ranks
share one), the ``--mesh_*`` flags (or ``--sharding_config``) shape the
mesh, every rank feeds its rows of the same seeded global batches, and
only rank 0 writes checkpoints, telemetry and the JSON line. A resume
may use another mesh shape: checkpoints hold whole tensors.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging

from tensorflow_examples_torch.core import distributed
from tensorflow_examples_torch.data.memory import eval_batches, train_iterator
from tensorflow_examples_torch.sharding import ShardingConfig
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.utils.diagnostics import install_crash_handlers
from tensorflow_examples_torch.utils.faults import configure_io_retry
from tensorflow_examples_torch.workloads import bert_glue, cifar10, gpt2, imagenet, mnist

WORKLOADS = {"gpt2": (gpt2, gpt2.Gpt2Config), "bert_glue": (bert_glue, bert_glue.BertGlueConfig),
             "cifar10": (cifar10, cifar10.Cifar10Config), "mnist": (mnist, mnist.MnistConfig),
             "imagenet": (imagenet, imagenet.ImagenetConfig)}


def _parse_bool(s: str) -> bool:
    if s.lower() in ("1", "true", "yes"):
        return True
    if s.lower() in ("0", "false", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {s!r}")


def add_config_flags(parser: argparse.ArgumentParser, config) -> None:
    """One flag per dataclass field, typed by its default."""
    for f in dataclasses.fields(config):
        default = getattr(config, f.name)
        kind = _parse_bool if isinstance(default, bool) else type(default)
        parser.add_argument(f"--{f.name}", type=kind, default=default, help=f"default {default!r}")


def _workload(argv) -> str:
    """The ``--workload`` of ``argv`` (default ``gpt2``): it decides which
    config's fields become flags."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--workload", default="gpt2")
    return pre.parse_known_args(argv)[0].workload


def build_parser(workload: str = "gpt2") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", choices=sorted(WORKLOADS), default="gpt2")
    if workload in WORKLOADS:
        add_config_flags(p, WORKLOADS[workload][1]())
    return p


def parse_config(argv=None, description: str | None = None):
    """(parser, args, the workload module, its config) from the command
    line; an unknown workload is a usage error naming it."""
    workload = _workload(argv)
    parser = build_parser(workload)
    if description:
        parser.description = description
    args = parser.parse_args(argv)
    module, config_cls = WORKLOADS[args.workload]
    cfg = config_cls(**{f.name: getattr(args, f.name) for f in dataclasses.fields(config_cls)})
    return parser, args, module, cfg


def iterators(module, cfg):
    """(``start -> train iterator``, ``() -> eval iterator``) of a
    workload: its own streams where it defines them, else batches of its
    in-memory sets."""
    if hasattr(module, "make_train_iter"):
        return (lambda start: module.make_train_iter(cfg, start),
                lambda: module.make_eval_iter(cfg))
    train_ds, eval_ds = module.datasets(cfg)
    augment = module.train_augment(cfg) if hasattr(module, "train_augment") else None
    eval_bs = cfg.eval_batch_size or cfg.global_batch_size
    return (lambda start: train_iterator(train_ds, cfg.global_batch_size, seed=cfg.seed,
                                         start_step=start, augment=augment),
            lambda: eval_batches(eval_ds, eval_bs))


def build_trainer(module, cfg) -> Trainer:
    """The trainer of a workload on the mesh its flags (or
    ``--sharding_config``) shape, the task made for that mesh."""
    sharding = (ShardingConfig.load(cfg.sharding_config) if cfg.sharding_config
                else ShardingConfig.from_train_config(cfg))
    mesh = sharding.build_mesh(device=distributed.local_device(cfg.device))
    return Trainer(module.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sharding)


def main(argv=None) -> int:
    _, args, module, cfg = parse_config(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    install_crash_handlers(cfg.workdir)
    configure_io_retry(cfg.io_retries, cfg.io_backoff_secs)
    distributed.initialize(device=cfg.device)
    try:
        train_fn, eval_fn = iterators(module, cfg)
        trainer = build_trainer(module, cfg)
        metrics = trainer.fit(train_fn, eval_iter_fn=eval_fn)
        if distributed.is_primary():
            print(json.dumps({"workload": args.workload, "device": str(trainer.device),
                              "mesh": dict(trainer.mesh.shape), "steps": trainer.state.step,
                              **metrics}))
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
