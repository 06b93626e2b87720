"""Evaluate the latest checkpoint of a training run.

    python -m tensorflow_examples_torch.train.eval --workload gpt2 --workdir RUN

The counterpart of the reference's ``eval_main``: takes the training
CLI's flags (the model's widths must be the run's), restores the newest
intact checkpoint under ``--workdir`` and prints the eval metrics (after
the task's ``eval_finalize``: GLUE's MCC, F1 or Pearson), with the
restored step, as one JSON line. It loads only the eval split, through
the workload's ``eval_dataset``. Without ``--workdir`` it is a usage
error (exit code 2); a workdir without a checkpoint exits non-zero.
"""

from __future__ import annotations

import json
import logging

from tensorflow_examples_torch.data.memory import eval_batches
from tensorflow_examples_torch.train.checkpoint import CheckpointManager
from tensorflow_examples_torch.train.cli import parse_config
from tensorflow_examples_torch.train.loop import Trainer


def main(argv=None) -> int:
    parser, args, module, cfg = parse_config(argv, description=__doc__.split("\n\n")[0])
    if not cfg.workdir:
        parser.error("--workdir is required for eval")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    trainer = Trainer(module.make_task(cfg), cfg)
    restored = CheckpointManager(cfg.workdir).restore_latest(trainer.state)
    if restored is None:
        raise SystemExit(f"no checkpoint under {cfg.workdir}")
    trainer.state = restored[0]
    eval_ds = module.eval_dataset(cfg)
    metrics = trainer.evaluate(eval_batches(eval_ds, cfg.eval_batch_size or cfg.global_batch_size))
    print(json.dumps({"workload": args.workload, "device": str(trainer.device),
                      "step": restored[1], **{f"eval_{k}": v for k, v in metrics.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
