"""Evaluate the latest checkpoint of a training run.

    python -m tensorflow_examples_torch.train.eval --workload gpt2 --workdir RUN

The counterpart of the reference's ``eval_main``: takes the training
CLI's flags (the model's widths must be the run's), restores the newest
intact checkpoint under ``--workdir`` and prints the eval metrics (after
the task's ``eval_finalize``: GLUE's MCC, F1 or Pearson), with the
restored step, as one JSON line. It reads only the eval split: the
workload's ``make_eval_iter`` stream where it has one (ImageNet), else
its ``eval_dataset``. Without ``--workdir`` it is a usage
error (exit code 2); a workdir without a checkpoint exits non-zero.
Under ``torchrun`` with the ``--mesh_*`` flags (or
``--sharding_config``) it evaluates on that mesh, as ``train.cli``
trains: the task made for the mesh, the checkpoint cut into each rank's
pieces, the totals summed over the batch axes; rank 0 prints the line.
"""

from __future__ import annotations

import json
import logging

from tensorflow_examples_torch.core import distributed
from tensorflow_examples_torch.data.memory import eval_batches
from tensorflow_examples_torch.train.checkpoint import CheckpointManager
from tensorflow_examples_torch.train.cli import build_trainer, parse_config


def main(argv=None) -> int:
    parser, args, module, cfg = parse_config(argv, description=__doc__.split("\n\n")[0])
    if not cfg.workdir:
        parser.error("--workdir is required for eval")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    distributed.initialize(device=cfg.device)
    try:
        trainer = build_trainer(module, cfg)
        restored = CheckpointManager(cfg.workdir, layout=trainer.layout,
                                     primary=distributed.is_primary()).restore_latest(trainer.state)
        if restored is None:
            raise SystemExit(f"no checkpoint under {cfg.workdir}")
        trainer.state = restored[0]
        if hasattr(module, "make_eval_iter"):
            batches = module.make_eval_iter(cfg)
        else:
            batches = eval_batches(module.eval_dataset(cfg),
                                   cfg.eval_batch_size or cfg.global_batch_size)
        metrics = trainer.evaluate(batches)
        if distributed.is_primary():
            print(json.dumps({"workload": args.workload, "device": str(trainer.device),
                              "step": restored[1], **{f"eval_{k}": v for k, v in metrics.items()}}))
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
