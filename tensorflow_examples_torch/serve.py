"""Serve GPT-2 over HTTP with the PyTorch/CUDA port.

    python -m tensorflow_examples_torch.serve --init_seed 0 --port 8000 \\
        --kv_block_size 16 --attention paged_flash

Weights come from ``--workdir`` (the params of the newest intact
checkpoint a training run wrote there, ``train/checkpoint.py``), from
``--params_npz`` (the JAX param tree flattened with ``/``-joined keys,
``models/convert.py``) or, without either, a random init from
``--init_seed``. The width flags must be the checkpoint's. The model defaults to GPT-2 124M. Runs on ``cuda``
unless ``--device cpu``. Every ``ServeConfig`` field is a flag
(``--weight_dtype int8|fp8``, ``--kv_dtype int8|fp8``,
``--spec_decode_k``, ``--draft_ngram``, ``--prefill_chunk_tokens`` ...).
The engine warms every rung of its ladder before the first request (on
the card, capturing each decode and verify rung's CUDA graph) and logs
how many it expected; then it serves ``POST /generate``, ``GET /health``
and ``GET /metrics`` until SIGINT or SIGTERM.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import signal
import threading

from tensorflow_examples_torch.generate import restore_model
from tensorflow_examples_torch.models import convert, transformer
from tensorflow_examples_torch.serving.batcher import ContinuousBatcher
from tensorflow_examples_torch.serving.engine import (
    ATTENTION_IMPLS,
    InferenceEngine,
    ServeConfig,
)
from tensorflow_examples_torch.serving.frontend import ServingFrontend


# The model's widths; its training knobs (dropout, attention, remat) do not
# apply to serving, whose attention is ServeConfig.attention.
MODEL_FIELDS = ("vocab_size", "max_len", "num_layers", "num_heads", "d_model", "d_ff")


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
        default = getattr(serve_defaults, f.name)
        if f.type in ("bool", bool):
            p.add_argument(f"--{f.name}", type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=default)
        elif f.name == "attention":
            p.add_argument("--attention", choices=ATTENTION_IMPLS, default=default)
        elif f.name in ("weight_dtype", "kv_dtype"):
            p.add_argument(f"--{f.name}", choices=("", "int8", "fp8"), default=default)
        else:
            p.add_argument(f"--{f.name}", type=type(default), default=default)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--host", default="127.0.0.1", help="address to bind")
    p.add_argument("--port", type=int, default=8000)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    model_cfg = transformer.TransformerConfig(**{name: getattr(args, name) for name in MODEL_FIELDS})
    serve_cfg = ServeConfig(**{f.name: getattr(args, f.name) for f in dataclasses.fields(ServeConfig)})
    if args.workdir:
        params, step = restore_model(model_cfg, args.workdir, "cpu")
        logging.info("serving the checkpoint of step %d from %s", step, args.workdir)
    elif args.params_npz:
        params = convert.load_npz(args.params_npz)
    else:
        params = transformer.GPT2(model_cfg, seed=args.init_seed)
    engine = InferenceEngine(model_cfg, params, cfg=serve_cfg, device=args.device)
    counts = engine.warmup()
    logging.info("warm: %d of %d expected rungs (%s)", sum(counts.values()),
                 engine.expected_compiles(), ", ".join(sorted(counts)))
    batcher = ContinuousBatcher(engine).start()
    frontend = ServingFrontend(batcher, port=args.port, bind_host=args.host).start()
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    logging.info("serving on %s (device %s, attention %s)", frontend.url(),
                 engine.device, serve_cfg.attention)
    stop.wait()
    frontend.close()
    batcher.close(drain=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
