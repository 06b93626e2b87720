"""Serve GPT-2 over HTTP with the PyTorch/CUDA port: one replica.

    python -m tensorflow_examples_torch.serve --init_seed 0 --port 8000 \\
        --kv_block_size 16 --attention paged_flash [--role prefill|decode]

Weights come from ``--workdir`` (the params of the newest intact
checkpoint a training run wrote there, ``train/checkpoint.py``), from
``--params_npz`` (the JAX param tree flattened with ``/``-joined keys,
``models/convert.py``) or, without either, a random init from
``--init_seed``. The width flags must be the checkpoint's. The model
defaults to GPT-2 124M. Runs on ``cuda`` unless ``--device cpu``. Every
``ServeConfig`` field is a flag (``--role``, ``--weight_dtype int8|fp8``,
``--kv_dtype int8|fp8``, ``--spec_decode_k``, ``--prefill_chunk_tokens``,
``--brownout`` and its watermarks, ``--watchdog_secs`` ...).

The engine warms every rung of its ladder before the first request (on
the card, capturing each decode and verify rung's CUDA graph); then the
replica serves ``POST /generate /classify /prefill /resume`` and
``GET /health /metrics /window /series`` (``serving/frontend.py``).
``--role prefill`` and ``--role decode`` replicas behind a router
(``python -m tensorflow_examples_torch.serve_fleet``, ``serving/router.py``;
either package's router fronts them) serve ``/generate`` as a
``/prefill`` -> ``/resume`` hand-off. A request's ``trace`` context comes
back as the reply's ``trace_spans``.

**Sharded serving.** A run trained on a mesh keeps its placement as
``workdir/sharding.json``; ``--serve_sharding_config`` takes the
reference's meaning: empty loads that file when it is there, a path is
explicit, ``off`` serves one replica. The config's ``data`` axis is
collapsed to 1. Under ``torchrun`` every rank builds the engine over
its own pieces of the checkpoint (read whole on the host, each rank
cutting its pieces, as the trainer's restore does) and its heads of the
KV pool; rank 0 alone binds the port and runs the batcher, and the
other ranks replay its engine calls (``serving/mesh_driver.py``)::

    torchrun --nproc_per_node 2 -m tensorflow_examples_torch.serve --workdir RUN \
        --kv_block_size 16 --attention paged_flash

Any ``--role`` serves sharded: a prefill replica's pages are gathered
over ``model`` into the reference's whole-H payload, and a decode
replica sends each rank only its heads of what it imports, so either
half of a disaggregated fleet may be a mesh behind either package's
router. A run trained with ``fsdp`` serves on its mesh, each weight cut
over ``fsdp`` gathered where it is read. An auto-loaded config that does
not fit the world prints the reference's line to stderr and rank 0
serves one replica; an explicit one raises. ``/health`` and the serving line then carry ``mesh_shape``
and ``param_sharding_digest``. Ranks that share one card talk over gloo
through host memory, which a CUDA graph cannot hold: such an engine
runs its rungs eagerly, and the startup line says so.

Text in and out goes through the BPE of ``--vocab_dir`` (or
``--data_dir``) when it holds ``vocab.json`` + ``merges.txt``, else raw
bytes for a byte vocabulary (``vocab_size <= 256``); otherwise clients
send token ids as ``prompt``. Every ``--stats_every`` seconds a
``kind="serving"`` line is appended to ``serving.jsonl`` in
``--stats_dir`` (default ``--workdir``) and the ``/series`` store takes a
sample on the same tick. SIGTERM or SIGINT drains: new requests get 503,
accepted ones finish, exit code 0; a second signal force-quits.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import threading

from tensorflow_examples_torch.core import distributed
from tensorflow_examples_torch.data.tokenizers import load_tokenizer
from tensorflow_examples_torch.generate import restore_model
from tensorflow_examples_torch.models import convert, transformer
from tensorflow_examples_torch.serving.batcher import ContinuousBatcher
from tensorflow_examples_torch.serving.engine import (
    ATTENTION_IMPLS,
    InferenceEngine,
    ServeConfig,
)
from tensorflow_examples_torch.serving.frontend import ServingFrontend, run_until_preempted
from tensorflow_examples_torch.serving.mesh_driver import MeshDriver
from tensorflow_examples_torch.serving.scheduler import ROLES
from tensorflow_examples_torch.sharding import ShardingConfig
from tensorflow_examples_torch.train.resilience import PreemptionGuard

# The model's widths; its training knobs (dropout, attention, remat) do not
# apply to serving, whose attention is ServeConfig.attention.
MODEL_FIELDS = ("vocab_size", "max_len", "num_layers", "num_heads", "d_model", "d_ff")
# The CLI's own defaults where they differ from ServeConfig's (the
# reference CLI's): a serving process watches its loop for hangs.
CLI_DEFAULTS = {"watchdog_secs": 60.0}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    weights = p.add_mutually_exclusive_group()
    weights.add_argument("--workdir", help="training run whose latest checkpoint to serve")
    weights.add_argument("--params_npz", help="flattened JAX param tree (.npz)")
    weights.add_argument("--init_seed", type=int, default=0,
                         help="random-init seed when no --params_npz is given")
    model_defaults = transformer.gpt2_124m()
    for name in MODEL_FIELDS:
        p.add_argument(f"--{name}", type=int, default=getattr(model_defaults, name))
    serve_defaults = ServeConfig()
    for f in dataclasses.fields(ServeConfig):
        default = CLI_DEFAULTS.get(f.name, getattr(serve_defaults, f.name))
        if f.type in ("bool", bool):
            p.add_argument(f"--{f.name}", type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=default)
        elif f.name == "attention":
            p.add_argument("--attention", choices=ATTENTION_IMPLS, default=default)
        elif f.name == "role":
            p.add_argument("--role", choices=ROLES, default=default)
        elif f.name in ("weight_dtype", "kv_dtype"):
            p.add_argument(f"--{f.name}", choices=("", "int8", "fp8"), default=default)
        else:
            p.add_argument(f"--{f.name}", type=type(default), default=default)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--host", default="127.0.0.1", help="address to bind")
    p.add_argument("--port", type=int, default=8000, help="HTTP port (0: any free port)")
    p.add_argument("--vocab_dir", default="", help="dir with vocab.json + merges.txt")
    p.add_argument("--data_dir", default="", help="corpus dir, searched for a vocab next")
    p.add_argument("--stats_every", type=float, default=10.0,
                   help="seconds between serving.jsonl lines (0 disables)")
    p.add_argument("--stats_dir", default="",
                   help="where serving.jsonl goes (default: --workdir)")
    p.add_argument("--serve_sharding_config", default="",
                   help="ShardingConfig JSON for sharded serving; default: <workdir>/sharding.json "
                        "when present, else one replica; 'off' serves one replica")
    return p


def resolve_sharding(src: str, workdir: str | None) -> ShardingConfig | None:
    """The config a sharded engine is placed by, the reference's rule:
    ``src`` "off" -> None; a path -> that file; "" -> ``workdir/sharding.json``
    when it exists. ``data`` is collapsed to 1 (serving has no data
    parallelism). A config the world's ranks do not fit raises when it
    was asked for and, auto-loaded, is dropped with a line on stderr."""
    if src == "off":
        return None
    path = src or os.path.join(workdir or "", "sharding.json")
    if not src and not (workdir and os.path.exists(path)):
        return None
    sharding = ShardingConfig.load(path)
    sharding = dataclasses.replace(sharding, mesh={**sharding.mesh, "data": 1})
    try:
        sharding.mesh_config().resolve(distributed.process_count())
    except ValueError as e:
        if src:
            raise
        print(f"sharding config {path} does not fit this host ({e}); serving with "
              "replicated params", file=sys.stderr)
        return None
    print(f"sharding config: {path}", file=sys.stderr)
    return sharding


def _stats_loop(batcher, frontend, path: str, every: float) -> None:
    """One tick: a time-series sample and one serving line, appended."""
    while not batcher._stop.wait(every):
        frontend.series.sample()
        with open(path, "a") as f:
            f.write(json.dumps(batcher.stats_line()) + "\n")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # Installed first: a SIGTERM during the load and warm-up drains too.
    guard = PreemptionGuard().install()
    # The process group is torn down before the interpreter exits: gloo's
    # threads left to the exit abort the process ("terminate called
    # without an active exception", exit -6) when a peer closes first.
    try:
        frontend = _start(args)
    except BaseException:
        guard.uninstall()
        distributed.shutdown()
        raise
    if frontend is None:  # a rank that replayed rank 0's calls to the stop
        guard.uninstall()
        distributed.shutdown()
        return 0
    try:
        return run_until_preempted(frontend, guard=guard)
    finally:
        driver = getattr(frontend.batcher.engine, "driver", None)
        if driver is not None:
            driver.stop()
        distributed.shutdown()


def _start(args) -> ServingFrontend | None:
    """Load, warm and start the replica: engine, batcher, frontend and
    the stats tick. Under ``torchrun`` every rank loads its pieces; the
    ranks but 0 replay rank 0's calls until its stop and return None."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    backend = distributed.initialize(device=args.device)
    rank = distributed.process_index()
    sharding = resolve_sharding(args.serve_sharding_config, args.workdir)
    if sharding is None and rank > 0:
        logging.info("rank %d: no sharded engine for this world; rank 0 serves one replica",
                     rank)
        return None
    model_cfg = transformer.TransformerConfig(**{n: getattr(args, n) for n in MODEL_FIELDS})
    serve_cfg = ServeConfig(**{f.name: getattr(args, f.name)
                               for f in dataclasses.fields(ServeConfig)})
    if args.workdir:
        params, step = restore_model(model_cfg, args.workdir, "cpu")
        logging.info("serving the checkpoint of step %d from %s", step, args.workdir)
    elif args.params_npz:
        params = convert.load_npz(args.params_npz)
    else:
        params = transformer.GPT2(model_cfg, seed=args.init_seed)
    # A CUDA graph cannot hold collectives staged through host memory.
    staged = sharding is not None and backend == "gloo" and args.device != "cpu"
    engine = InferenceEngine(model_cfg, params, cfg=serve_cfg, device=args.device,
                             sharding=sharding, cuda_graphs=not staged)
    if engine.mesh is not None and engine.mesh.size > 1:
        driver = MeshDriver()
        if rank > 0:
            logging.info("rank %d replayed %d calls of rank 0", rank, driver.follow(engine))
            return None
        engine = driver.leader(engine)
    counts = engine.warmup()
    logging.info("warm: %d of %d expected rungs (%s)", sum(counts.values()),
                 engine.expected_compiles(), ", ".join(sorted(counts)))
    batcher = ContinuousBatcher(engine).start()
    frontend = ServingFrontend(batcher, port=args.port, bind_host=args.host,
                               tokenizer=load_tokenizer(model_cfg.vocab_size, args.vocab_dir,
                                                        args.data_dir)).start()
    stats_dir = args.stats_dir or args.workdir
    if args.stats_every > 0 and stats_dir:
        os.makedirs(stats_dir, exist_ok=True)
        threading.Thread(target=_stats_loop, name="serving-stats", daemon=True, args=(
            batcher, frontend, os.path.join(stats_dir, "serving.jsonl"), args.stats_every,
        )).start()
    sharded = ""
    if engine.mesh is not None:
        sharded = (f", mesh {engine.mesh_shape}, param_sharding_digest "
                   f"{engine.param_sharding_digest}, backend {backend or 'none'}")
        if staged:
            sharded += ", cuda graphs off (collectives staged through host memory)"
    logging.info("serving on %s (device %s, role %s, attention %s%s)", frontend.url(),
                 engine.device, serve_cfg.role, serve_cfg.attention, sharded)
    return frontend


if __name__ == "__main__":
    raise SystemExit(main())
