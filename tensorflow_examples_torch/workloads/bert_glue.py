"""BERT-base GLUE fine-tuning: the port of
``tensorflow_examples_tpu/workloads/bert_glue.py``.

``BertGlueConfig`` keeps the reference's recipe and defaults (batch 32 x
128 tokens, AdamW b2 0.999 eps 1e-6 with weight decay 0.01 under
warmup-linear from 2e-5, warmup 600 of 6000 steps, clip 1.0, bf16
compute, dropout 0.1). ``attention`` defaults to ``"xla"``, the plain
path, as the reference's; ``"flash"`` runs the flash kernels non-causal
with the padding mask as their key bias (``models/bert.py``). The head
has ``GLUE_NUM_LABELS[task]`` outputs; STS-B's single output is a
regression trained on the squared error (its labels cast to the compute
dtype with the rest of the batch, as the reference's). Eval emits
weighted means, and ``eval_finalize`` turns them into the task's score:
MCC for CoLA, F1 for MRPC and QQP (from confusion rates), Pearson for
STS-B (from moments) (``ops/glue_metrics.py``). ``pretrained`` names a
local HF BERT directory (``models/hf_import.import_bert``); its head is
kept only when its shape fits the task's. On a mesh the layers are cut
by ``bert.BERT_RULES`` (qkv by heads and the FFN by columns over
``model``, the kernels' other dim over ``fsdp``), as the reference's.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from tensorflow_examples_torch.data.sources import GLUE_NUM_LABELS, load_glue
from tensorflow_examples_torch.models import bert, convert, hf_import
from tensorflow_examples_torch.models.transformer import ParamView
from tensorflow_examples_torch.ops import glue_metrics
from tensorflow_examples_torch.ops.losses import softmax_cross_entropy, weighted_mean
from tensorflow_examples_torch.train import optimizers
from tensorflow_examples_torch.train.config import TrainConfig
from tensorflow_examples_torch.train.task import Task


@dataclasses.dataclass
class BertGlueConfig(TrainConfig):
    task: str = "sst2"
    seq_len: int = 128
    vocab_size: int = 30522
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    dropout: float = 0.1
    attention: str = "xla"  # xla (plain) | flash (the flash kernels, key-bias padding mask)
    pretrained: str = ""  # local HF BERT directory; "" = random init

    global_batch_size: int = 32
    train_steps: int = 6000
    warmup_steps: int = 600
    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    grad_clip_norm: float = 1.0
    eval_every: int = 1000
    checkpoint_every: int = 1000
    log_every: int = 50


def model_config(cfg: BertGlueConfig) -> bert.BertConfig:
    return bert.BertConfig(vocab_size=cfg.vocab_size, num_layers=cfg.num_layers,
                           num_heads=cfg.num_heads, d_model=cfg.d_model, d_ff=cfg.d_ff,
                           dropout=cfg.dropout, attention=cfg.attention)


def make_task(cfg: BertGlueConfig, mesh=None) -> Task:
    """The task; ``mesh``: the ``core/mesh.Mesh`` the trainer runs on
    (None: one device), whose ``model`` and ``fsdp`` axes cut the layers
    under ``bert.BERT_RULES``."""
    if mesh is not None and mesh.trivial:
        mesh = None
    num_labels = GLUE_NUM_LABELS[cfg.task]
    regression = num_labels == 1
    mcfg = model_config(cfg)

    def init_fn(seed: int, device: torch.device):
        model = bert.BertClassifier(mcfg, num_labels, seed=seed, device=device)
        params = {k: p.detach() for k, p in model.named_parameters()}
        if cfg.pretrained:
            _, tree = hf_import.import_bert(cfg.pretrained)
            head = tree.get("classifier")
            if head is None or tuple(head["kernel"].shape) != tuple(
                    params["classifier.kernel"].shape):
                tree.pop("classifier", None)  # keep the fresh head
            imported = convert.variables_from_tree({"params": tree})["params"]
            for k, v in imported.items():
                if k not in params or tuple(v.shape) != tuple(params[k].shape):
                    raise ValueError(f"pretrained={cfg.pretrained!r}: {k} is "
                                     f"{tuple(v.shape)}, the model's is "
                                     f"{getattr(params.get(k), 'shape', 'missing')}")
                params[k] = v.to(device)
        return {"params": params}

    def forward(params, batch, *, rng, train):
        return bert.forward(mcfg, ParamView(params), batch["tokens"], batch["attention_mask"],
                            batch["token_type_ids"], train=train, noise=rng if train else None,
                            mesh=mesh)

    def loss_fn(params, model_state, batch, *, rng, train):
        logits = forward(params, batch, rng=rng, train=train)
        if regression:
            return torch.mean((logits[:, 0] - batch["label"]) ** 2), {}, model_state
        loss = softmax_cross_entropy(logits, batch["label"])
        acc = (torch.argmax(logits, -1) == batch["label"].long()).float().mean()
        return loss, {"accuracy": acc}, model_state

    def eval_fn(params, model_state, batch):
        logits = forward(params, batch, rng=None, train=False)
        w = batch.get("mask")
        if regression:
            pred = logits[:, 0]
            m = glue_metrics.moment_means(pred, batch["label"], w)
            m["loss"] = weighted_mean((pred - batch["label"]) ** 2, w)
        else:
            pred = torch.argmax(logits, -1)
            m = {"accuracy": weighted_mean((pred == batch["label"].long()).float(), w),
                 "loss": softmax_cross_entropy(logits, batch["label"], weights=w)}
            if num_labels == 2:
                m.update(glue_metrics.confusion_rates(pred, batch["label"], w))
        m["weight"] = (w.float().sum() if w is not None else
                       torch.tensor(float(batch["tokens"].shape[0]), device=logits.device))
        return m

    def eval_finalize(means: dict) -> dict:
        out = dict(means)
        if regression:
            out["pearson"] = glue_metrics.pearson_from_moments(means)
            for k in ("x", "y", "xx", "yy", "xy"):
                out.pop(k, None)
        elif num_labels == 2:
            if cfg.task == "cola":
                out["mcc"] = glue_metrics.mcc_from_rates(means)
            if cfg.task in ("mrpc", "qqp"):
                out["f1"] = glue_metrics.f1_from_rates(means)
            for k in ("tp", "fp", "fn", "tn"):
                out.pop(k, None)
        return out

    return Task(name=f"bert_glue_{cfg.task}", init_fn=init_fn, loss_fn=loss_fn,
                make_optimizer=optimizers.adamw_linear, eval_fn=eval_fn,
                eval_finalize=eval_finalize, sharding_rules=bert.BERT_RULES)


def datasets(cfg: BertGlueConfig):
    kw = dict(seq_len=cfg.seq_len, vocab_size=cfg.vocab_size)
    return load_glue(cfg.data_dir, cfg.task, "train", **kw), eval_dataset(cfg)


def eval_dataset(cfg: BertGlueConfig):
    """The validation split; a ``data_dir`` without one evaluates on
    synthetic data, with a warning, as the reference does."""
    has_val = bool(cfg.data_dir) and os.path.exists(
        os.path.join(cfg.data_dir, f"{cfg.task}_validation.npz"))
    if cfg.data_dir and not has_val:
        logging.getLogger(__name__).warning(
            "--data_dir=%s has no %s_validation.npz; eval runs on SYNTHETIC data - reported "
            "metrics are not real GLUE scores", cfg.data_dir, cfg.task)
    return load_glue(cfg.data_dir if has_val else "", cfg.task, "validation",
                     seq_len=cfg.seq_len, vocab_size=cfg.vocab_size)
