"""GPT-2 124M causal-LM workload: the port of the non-pipeline path of
``tensorflow_examples_tpu/workloads/gpt2.py`` (no vocab-parallel head).

``Gpt2Config`` keeps the reference's recipe (AdamW b2 0.95, warmup-cosine
from 6e-4, weight decay 0.1, clip 1.0, bf16 compute, dropout 0.1, batch
16 x 1024), ``fused_ce`` True included: the loss runs through the fused
cross-entropy kernels of ``ops/csrc/cross_entropy.cu`` on the card (their
plain versions on the CPU); ``fused_ce=False`` takes the plain f32
reference, differentiated by autograd.

``moe_experts`` E > 0 swaps the MLP of every ``moe_every``-th block for a
top-``moe_top_k`` MoE (``models/transformer.py``): the loss is then
``mean(nll) + moe_aux_weight * moe_aux`` and the step's metrics carry
``moe_aux`` (summed over the MoE blocks) and ``moe_drop`` (their mean
dropped fraction), as the reference's. ``moe_impl`` "" takes the device's
default dispatch: ``grouped`` (the grouped-matmul kernels) on the card,
``scatter`` on the CPU.

``remat_policy`` (with ``remat``) picks what a recomputed block saves
(``models/transformer.py``); ``pretrained`` names a local HF
``GPT2LMHeadModel`` directory whose weights replace the random init
(``models/hf_import.py``), as the reference's.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from tensorflow_examples_torch.data.sources import load_lm_tokens
from tensorflow_examples_torch.models import convert, hf_import, transformer
from tensorflow_examples_torch.ops.cross_entropy import cross_entropy_per_example
from tensorflow_examples_torch.ops.losses import weighted_mean
from tensorflow_examples_torch.train import optimizers
from tensorflow_examples_torch.train.config import TrainConfig
from tensorflow_examples_torch.train.task import Task


@dataclasses.dataclass
class Gpt2Config(TrainConfig):
    vocab_size: int = 50257
    seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    dropout: float = 0.1
    attention: str = "flash"  # flash | xla
    remat_policy: str = "none"  # none | dots | dots_no_batch: what a --remat block saves
    fused_ce: bool = True  # the fused cross-entropy kernels (False: plain f32 reference)
    pretrained: str = ""  # local HF GPT2LMHeadModel directory to start from
    # Mixture-of-Experts: 0 = dense GPT-2.
    moe_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 1
    moe_aux_weight: float = 0.01
    moe_impl: str = ""  # "" = grouped on CUDA, scatter on the CPU; pin one to compare

    global_batch_size: int = 16
    train_steps: int = 20000
    warmup_steps: int = 2000
    learning_rate: float = 6e-4
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    eval_every: int = 2000
    log_every: int = 50
    checkpoint_every: int = 2000


def model_config(cfg: Gpt2Config) -> transformer.TransformerConfig:
    # The enum fails fast whatever the flags, as the reference's does.
    if cfg.remat_policy not in ("none", "dots", "dots_no_batch"):
        raise ValueError(f"remat_policy={cfg.remat_policy!r} not in "
                         "('none', 'dots', 'dots_no_batch')")
    return transformer.TransformerConfig(
        vocab_size=cfg.vocab_size, max_len=cfg.seq_len, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, d_model=cfg.d_model, dropout=cfg.dropout,
        attention=cfg.attention, remat=cfg.remat, remat_policy=cfg.remat_policy,
        moe_experts=cfg.moe_experts,
        moe_every=cfg.moe_every, moe_top_k=cfg.moe_top_k, moe_impl=cfg.moe_impl,
    )


def make_task(cfg: Gpt2Config, **model_overrides) -> Task:
    """The task; ``model_overrides`` replace fields of
    :func:`model_config`'s result (e.g. ``moe_capacity_factor``, which the
    reference's workload config does not carry either)."""
    mcfg = dataclasses.replace(model_config(cfg), **model_overrides)

    def init_fn(seed: int, device: torch.device):
        if cfg.pretrained:
            try:
                _, tree = hf_import.import_gpt2(cfg.pretrained, mcfg)
            except (KeyError, ValueError) as e:  # a missing tensor, a reshape that cannot fit
                raise ValueError(f"pretrained={cfg.pretrained!r} does not fit the configured "
                                 f"model: {e}") from e
            model = transformer.GPT2(mcfg, device="meta")
            params = {k.replace("/", "."): v for k, v in convert.flatten_tree(tree).items()}
            for k, p in model.named_parameters():
                if k not in params or tuple(params[k].shape) != tuple(p.shape):
                    raise ValueError(f"pretrained={cfg.pretrained!r}: {k} is "
                                     f"{getattr(params.get(k), 'shape', 'missing')}, the "
                                     f"model's is {tuple(p.shape)}")
            return {"params": {k: torch.as_tensor(np.array(params[k], np.float32)).to(device)
                               for k, _ in model.named_parameters()}}
        model = transformer.GPT2(mcfg, seed=seed, device=device)
        return {"params": {k: p.detach() for k, p in model.named_parameters()}}

    def token_nll(params, batch, *, rng, train):
        inputs, labels = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
        logits, moe_aux, moe_drop = transformer.forward(
            mcfg, transformer.ParamView(params), inputs, train=train,
            noise=rng if train else None, moe_stats=True)
        nll = cross_entropy_per_example(logits.reshape(-1, logits.shape[-1]),
                                        labels.reshape(-1), fused=cfg.fused_ce)
        return nll.reshape(labels.shape), moe_aux, moe_drop

    def loss_fn(params, model_state, batch, *, rng, train):
        nll, moe_aux, moe_drop = token_nll(params, batch, rng=rng, train=train)
        if not cfg.moe_experts:
            return nll.mean(), {}, model_state
        loss = nll.mean() + cfg.moe_aux_weight * moe_aux
        return loss, {"moe_aux": moe_aux, "moe_drop": moe_drop}, model_state

    def eval_fn(params, model_state, batch):
        per_example = token_nll(params, batch, rng=None, train=False)[0].mean(dim=-1)
        mask = batch.get("mask")
        weight = mask.float().sum() if mask is not None else torch.tensor(
            float(per_example.shape[0]), device=per_example.device)
        return {"nll": weighted_mean(per_example, mask), "weight": weight}

    return Task(name="gpt2_124m", init_fn=init_fn, loss_fn=loss_fn,
                make_optimizer=optimizers.adamw_cosine, eval_fn=eval_fn)


def datasets(cfg: Gpt2Config):
    """(train, eval) token windows: files under ``data_dir`` or the
    seeded synthetic bigram streams. A ``data_dir`` without a ``val``
    split evaluates on synthetic data, with a warning, as the reference
    does."""
    has_val = bool(cfg.data_dir) and any(
        os.path.exists(os.path.join(cfg.data_dir, "val" + ext)) for ext in (".bin", ".npy", ".txt")
    )
    if cfg.data_dir and not has_val:
        logging.getLogger(__name__).warning(
            "--data_dir=%s has no val.{bin,npy,txt}; eval runs on SYNTHETIC data", cfg.data_dir)
    kw = dict(seq_len=cfg.seq_len, vocab_size=cfg.vocab_size)
    return (load_lm_tokens(cfg.data_dir, "train", **kw),
            load_lm_tokens(cfg.data_dir if has_val else "", "val", **kw))
