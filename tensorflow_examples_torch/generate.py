"""Sample from a GPT-2 checkpoint with the PyTorch/CUDA port.

    python -m tensorflow_examples_torch.generate --workdir RUN \\
        --num_tokens 64 --temperature 0.8 --top_k 40

The counterpart of the reference's ``examples/gpt2/generate.py``. Takes
the training CLI's flags (the model's widths must be the run's),
restores the params of the newest intact checkpoint under ``--workdir``
and decodes through the KV cache (``models/transformer.generate``:
flash-decode under ``--attention flash``, the plain reference under
``xla``) with the key ``PRNGKey(--seed)``. ``--prompt`` is taken as
bytes when the vocabulary has at most 256 entries; otherwise give
comma-separated ``--prompt_ids`` (the BPE tokenizer is not ported yet).
Prints the token ids, and the decoded bytes for a byte vocabulary.
Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import logging

import torch

from tensorflow_examples_torch.core import rng
from tensorflow_examples_torch.core.device import resolve_device
from tensorflow_examples_torch.models import convert, transformer
from tensorflow_examples_torch.train.checkpoint import CheckpointManager
from tensorflow_examples_torch.train.cli import build_parser
from tensorflow_examples_torch.workloads import gpt2


def restore_model(model_cfg: transformer.TransformerConfig, workdir: str,
                  device=None) -> tuple[transformer.GPT2, int]:
    """(a GPT-2 of ``model_cfg``'s widths holding the f32 params of the
    newest intact checkpoint under ``workdir``, on ``device``; its step).
    Raises when there is no checkpoint or its params do not fit."""
    found = CheckpointManager(workdir).load_latest()
    if found is None:
        raise FileNotFoundError(f"no checkpoint under {workdir}")
    saved, step = found
    tree = {k.replace(".", "/"): v.numpy() for k, v in saved["params"].items()}
    return convert.model_from_params(model_cfg, tree, device=resolve_device(device)), step


def generate_from_workdir(cfg: gpt2.Gpt2Config, prompt_ids: list[int], *, num_tokens: int,
                          temperature: float, top_k: int) -> tuple[list[int], int]:
    """(prompt + sampled token ids, the checkpoint's step), on
    ``cfg.device``, with ``cfg.attention`` and the key ``PRNGKey(cfg.seed)``."""
    mcfg = gpt2.model_config(cfg)
    model, step = restore_model(mcfg, cfg.workdir, cfg.device)
    prompt = torch.tensor([prompt_ids], dtype=torch.long, device=model.wte.embedding.device)
    out = transformer.generate(mcfg, model, prompt, num_tokens=num_tokens,
                               key=rng.PRNGKey(cfg.seed), temperature=temperature, top_k=top_k)
    return out[0].tolist(), step


def main(argv=None) -> int:
    parser = build_parser()
    parser.description = __doc__.split("\n\n")[0]
    parser.add_argument("--num_tokens", type=int, default=64, help="tokens to sample")
    parser.add_argument("--temperature", type=float, default=0.8, help="0 = greedy")
    parser.add_argument("--top_k", type=int, default=40, help="0 disables top-k filtering")
    parser.add_argument("--prompt", default="The ", help="text prompt (byte vocabularies)")
    parser.add_argument("--prompt_ids", default="", help="comma-separated token ids")
    args = parser.parse_args(argv)
    cfg = gpt2.Gpt2Config(**{f: getattr(args, f) for f in gpt2.Gpt2Config.__dataclass_fields__})
    if not cfg.workdir:
        parser.error("--workdir is required for generate")
    if args.prompt_ids:
        ids = [int(t) for t in args.prompt_ids.split(",")]
    elif cfg.vocab_size <= 256:
        ids = list(args.prompt.encode())
    else:
        parser.error("--prompt needs a byte vocabulary (vocab_size <= 256); pass --prompt_ids")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    toks, _ = generate_from_workdir(cfg, ids, num_tokens=args.num_tokens,
                                    temperature=args.temperature, top_k=args.top_k)
    print("token ids:", toks)
    if cfg.vocab_size <= 256:
        print(bytes(min(max(t, 0), 255) for t in toks).decode(errors="replace"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
