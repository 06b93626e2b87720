"""Train a workload with the PyTorch/CUDA port.

    python -m tensorflow_examples_torch.train.cli --workload gpt2 --train_steps 20

Every field of the workload's config dataclass is a flag of the same
name (the counterpart of the reference's ``define_flags_from_config``);
booleans take true/false. Runs on ``cuda`` unless ``--device cpu``.
Without ``--data_dir`` the data are the seeded synthetic streams. With
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
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging

from tensorflow_examples_torch.data.memory import eval_batches, train_iterator
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.utils.diagnostics import install_crash_handlers
from tensorflow_examples_torch.utils.faults import configure_io_retry
from tensorflow_examples_torch.workloads import gpt2

WORKLOADS = {"gpt2": (gpt2, gpt2.Gpt2Config)}


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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", choices=sorted(WORKLOADS), default="gpt2")
    add_config_flags(p, gpt2.Gpt2Config())  # the one workload ported so far
    return p


def parse_config(argv=None, description: str | None = None):
    """(args, the workload module, its config) from the command line."""
    parser = build_parser()
    if description:
        parser.description = description
    args = parser.parse_args(argv)
    module, config_cls = WORKLOADS[args.workload]
    cfg = config_cls(**{f.name: getattr(args, f.name) for f in dataclasses.fields(config_cls)})
    return parser, args, module, cfg


def main(argv=None) -> int:
    _, args, module, cfg = parse_config(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    install_crash_handlers(cfg.workdir)
    configure_io_retry(cfg.io_retries, cfg.io_backoff_secs)
    train_ds, eval_ds = module.datasets(cfg)
    trainer = Trainer(module.make_task(cfg), cfg)
    eval_bs = cfg.eval_batch_size or cfg.global_batch_size
    metrics = trainer.fit(
        lambda start: train_iterator(train_ds, cfg.global_batch_size, seed=cfg.seed,
                                     start_step=start),
        eval_iter_fn=lambda: eval_batches(eval_ds, eval_bs),
    )
    print(json.dumps({"workload": args.workload, "device": str(trainer.device),
                      "steps": trainer.state.step, **metrics}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
