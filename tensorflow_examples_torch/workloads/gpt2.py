"""GPT-2 124M causal-LM workload: the port of
``tensorflow_examples_tpu/workloads/gpt2.py``.

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

On a mesh (``make_task(cfg, mesh=...)``, ``core/mesh.py``) the task runs
this rank's part of the step: its rows of the batch and, with
``context`` > 1, its contiguous shard of the sequence (``seq_len`` must
divide by ``context``), through the mesh-aware forward
(``models/transformer.py``) under :data:`transformer.GPT2_RULES`. The
loss is token-sharded (``ops/cross_entropy.mesh_cross_entropy_per_example``)
or, with ``tp_vocab`` on a ``model`` > 1 mesh, vocab-parallel
(``tp_cross_entropy_from_hidden``). ``tp_vocab`` also splits the tied
table over ``model`` by vocab when the vocab divides (the rule is
prepended, first match wins); GPT-2's odd 50257 keeps it replicated and
the head still runs vocab-parallel, as in the reference.

On a mesh with ``pipe`` > 1 the task is the pipeline-parallel one
(:func:`_make_pipeline_task`): the blocks stacked over ``pipe``, trained
by the 1F1B schedule (``pipeline_schedule`` "1f1b", interleaved over
``pipe_interleave`` virtual stages a rank) or by GPipe ("gpipe"), over
``num_microbatches`` microbatches of this rank's rows; evaluation runs
GPipe in logical layer order.

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
from tensorflow_examples_torch.core import collectives as coll
from tensorflow_examples_torch.core.mesh import AxisNames
from tensorflow_examples_torch.core.sharding import ShardingRules
from tensorflow_examples_torch.ops.cross_entropy import (cross_entropy_per_example,
                                                         mesh_cross_entropy_per_example,
                                                         tp_cross_entropy_from_hidden)
from tensorflow_examples_torch.ops.losses import weighted_mean
from tensorflow_examples_torch.parallel.pipeline import (interleave_perm, pipeline_1f1b,
                                                         pipeline_apply)
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
    attention: str = "flash"  # flash | xla | ring | ulysses (the context-parallel algorithm)
    remat_policy: str = "none"  # none | dots | dots_no_batch: what a --remat block saves
    fused_ce: bool = True  # the fused cross-entropy kernels (False: plain f32 reference)
    pretrained: str = ""  # local HF GPT2LMHeadModel directory to start from
    # Pipeline parallelism (mesh_pipe > 1): microbatches over the `pipe`
    # axis, schedule "1f1b" or "gpipe", and virtual stages a rank for the
    # interleaved 1F1B (the blocks then stored slot-major).
    num_microbatches: int = 4
    pipeline_schedule: str = "1f1b"
    pipe_interleave: int = 1
    # Mixture-of-Experts: 0 = dense GPT-2.
    moe_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 1
    moe_aux_weight: float = 0.01
    moe_impl: str = ""  # "" = grouped on CUDA, scatter on the CPU; pin one to compare
    # Vocab-parallel LM head and CE over the `model` axis (Megatron's
    # parallel cross-entropy); needs mesh_model > 1 to take effect.
    tp_vocab: bool = False

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


def _context_shard(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous shard of ``x``'s sequence dim (1)."""
    c = mesh.axis_size(AxisNames.CONTEXT)
    if c == 1:
        return x
    if x.shape[1] % c:
        raise ValueError(f"seq_len {x.shape[1]} must divide by mesh_context {c}")
    s = x.shape[1] // c
    i = mesh.axis_index(AxisNames.CONTEXT)
    return x[:, i * s:(i + 1) * s].contiguous()


def make_task(cfg: Gpt2Config, mesh=None, **model_overrides) -> Task:
    """The task; ``mesh``: the ``core/mesh.Mesh`` the trainer runs on
    (None: one device). ``model_overrides`` replace fields of
    :func:`model_config`'s result (e.g. ``moe_capacity_factor``, which the
    reference's workload config does not carry either)."""
    mcfg = dataclasses.replace(model_config(cfg), **model_overrides)
    if mesh is not None and mesh.trivial:
        mesh = None
    if mesh is not None and mesh.axis_size(AxisNames.PIPE) > 1:
        return _make_pipeline_task(cfg, mesh, mcfg)
    model_axis = 1 if mesh is None else mesh.axis_size(AxisNames.MODEL)
    tp_vocab = cfg.tp_vocab and model_axis > 1

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
        if mesh is not None:
            inputs, labels = _context_shard(inputs, mesh), _context_shard(labels, mesh)
        view = transformer.ParamView(params)
        out, moe_aux, moe_drop = transformer.forward(
            mcfg, view, inputs, train=train, noise=rng if train else None, moe_stats=True,
            mesh=mesh, return_hidden=tp_vocab)
        if tp_vocab:
            nll = tp_cross_entropy_from_hidden(out.reshape(-1, out.shape[-1]),
                                               view.wte.embedding, labels.reshape(-1),
                                               mesh=mesh, vocab_size=cfg.vocab_size)
        elif mesh is not None:
            nll = mesh_cross_entropy_per_example(out, labels, mesh=mesh, fused=cfg.fused_ce)
        else:
            nll = cross_entropy_per_example(out.reshape(-1, out.shape[-1]),
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

    rules = transformer.GPT2_RULES
    if tp_vocab and cfg.vocab_size % model_axis == 0:
        # Vocab-split table (first match wins: prepended) only when the
        # vocab divides; the parallel CE itself takes any vocab.
        rules = ShardingRules([(r"wte/embedding", (AxisNames.MODEL, None))]) + rules
    return Task(name="gpt2_124m", init_fn=init_fn, loss_fn=loss_fn,
                make_optimizer=optimizers.adamw_cosine, eval_fn=eval_fn,
                sharding_rules=rules)


def _stacked(params, key: str) -> dict:
    """``{block param: tensor}`` of the stacked blocks under ``key``."""
    return {n[len(key) + 1:]: t for n, t in params.items() if n.startswith(key + ".")}


def _make_pipeline_task(cfg: Gpt2Config, mesh, mcfg) -> Task:
    """Pipeline-parallel GPT-2 (``pipe`` > 1), the reference's
    ``_make_pipeline_task``: ``embed.*`` (wte, wpe, ln_f) on every rank,
    ``<blocks key>.*`` stacked [num_layers, ...] with the layer dim split
    over ``pipe`` and, with ``model`` > 1, the Megatron layout of
    :data:`transformer.GPT2_RULES` on each stage (its specs with ``pipe``
    prepended and ``fsdp`` dropped: the batch still splits over
    ``fsdp``). With ``pipe_interleave`` v > 1 the blocks are stored
    slot-major (``parallel/pipeline.interleave_perm``) under the key
    ``blocks_slotmajor_p{P}v{v}``, so a checkpoint written under another
    (P, v) fails to restore, loudly. Layouts without a pipeline route
    raise ``ValueError``: MoE (the reference's stacked blocks are dense,
    so it would train a dense model), context parallelism and the
    vocab-parallel head."""
    n_stages = mesh.axis_size(AxisNames.PIPE)
    v = cfg.pipe_interleave
    if v < 1:
        raise ValueError(f"pipe_interleave must be >= 1, got {v}")
    s_total = n_stages * v
    if cfg.num_layers % s_total:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by "
                         f"pipe={n_stages} x interleave={v}")
    if cfg.pipeline_schedule not in ("1f1b", "gpipe"):
        raise ValueError(f"unknown pipeline_schedule={cfg.pipeline_schedule}")
    if v > 1 and cfg.pipeline_schedule != "1f1b":
        raise ValueError("pipe_interleave > 1 requires the 1f1b schedule")
    if cfg.moe_experts:
        raise ValueError(f"moe_experts={cfg.moe_experts} with mesh_pipe={n_stages}: the "
                         "pipeline's stacked blocks are dense, so MoE has no pipeline route")
    if mesh.axis_size(AxisNames.CONTEXT) > 1:
        raise ValueError("mesh_context > 1 with mesh_pipe > 1: context parallelism has no "
                         "pipeline route")
    if cfg.tp_vocab:
        raise ValueError("tp_vocab with mesh_pipe > 1: the vocab-parallel head has no "
                         "pipeline route (the last stage runs the tied head whole)")
    embed_head = transformer.EmbedHead()
    per_stage = cfg.num_layers // s_total
    m = cfg.num_microbatches
    blocks_key = "blocks" if v == 1 else f"blocks_slotmajor_p{n_stages}v{v}"
    if v > 1:
        row_perm = np.concatenate([np.arange(s * per_stage, (s + 1) * per_stage)
                                   for s in interleave_perm(n_stages, v)])
        row_unperm = torch.as_tensor(np.argsort(row_perm))
    stage = mesh.axis_index(AxisNames.PIPE)

    def init_fn(seed: int, device: torch.device):
        # The unsplit model's init (random from the seed, or pretrained), stacked.
        params = make_task(cfg).init_fn(seed, device)["params"]
        stacked = transformer.stack_params_for_pipeline(params, cfg.num_layers)
        out = {k: t for k, t in stacked.items() if k.startswith("embed.")}
        for k, t in stacked.items():
            if k.startswith("blocks."):
                out[blocks_key + k[len("blocks"):]] = t[row_perm] if v > 1 else t
        return {"params": out}

    def head_loss_fn(head, y, lbl):
        """ln_f, the tied head and the CE, mean over the microbatch (the
        last virtual stage's, inside the 1F1B schedule)."""
        logits = embed_head.logits(transformer.ParamView(head), y)
        return cross_entropy_per_example(logits.reshape(-1, cfg.vocab_size), lbl.reshape(-1),
                                         fused=cfg.fused_ce).mean()

    def encode(view, inputs, drop):
        return embed_head.encode(view.embed, inputs, drop)

    def logical_stage(params) -> dict:
        """This rank's logical stage [L/P, ...] (GPipe and eval): the
        stored rows themselves, or for slot-major storage the whole stack
        gathered over ``pipe``, un-permuted and cut."""
        local = _stacked(params, blocks_key)
        if v == 1:
            return local
        rows = cfg.num_layers // n_stages
        return {n: coll.all_gather(t, AxisNames.PIPE, mesh=mesh, dim=0)[
            row_unperm.to(t.device)][stage * rows:(stage + 1) * rows] for n, t in local.items()}

    def token_nll(params, batch, *, rng, train):
        inputs, labels = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
        view = transformer.ParamView(params)
        drop = transformer.Dropout(cfg.dropout if train else 0.0, rng if train else None)
        x = encode(view, inputs, drop)
        sp = logical_stage(params)
        layer0 = stage * (cfg.num_layers // n_stages)
        x = pipeline_apply(
            lambda h, k: transformer.apply_stacked_blocks(mcfg, sp, h, layer0=layer0, drop=drop,
                                                          mb=k, mesh=mesh),
            x, mesh=mesh, num_microbatches=m)
        logits = embed_head.logits(view.embed, x)
        return mesh_cross_entropy_per_example(logits, labels, mesh=mesh, fused=cfg.fused_ce)

    def loss_fn(params, model_state, batch, *, rng, train):
        if not (train and cfg.pipeline_schedule == "1f1b"):
            return token_nll(params, batch, rng=rng, train=train).mean(), {}, model_state
        inputs, labels = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
        view = transformer.ParamView(params)
        drop = transformer.Dropout(cfg.dropout, rng)
        x = encode(view, inputs, drop)

        def stage_fn(chunk, h, j, k):
            return transformer.apply_stacked_blocks(
                mcfg, chunk, h, layer0=(j * n_stages + stage) * per_stage, drop=drop, mb=k,
                mesh=mesh)

        head = {"wte.embedding": params["embed.wte.embedding"],
                "ln_f.scale": params["embed.ln_f.scale"], "ln_f.bias": params["embed.ln_f.bias"]}
        loss = pipeline_1f1b(stage_fn, head_loss_fn, _stacked(params, blocks_key), head, x,
                             labels, mesh=mesh, num_microbatches=m, num_virtual_stages=v)
        return loss, {}, model_state

    def eval_fn(params, model_state, batch):
        per_example = token_nll(params, batch, rng=None, train=False).mean(dim=-1)
        mask = batch.get("mask")
        weight = mask.float().sum() if mask is not None else torch.tensor(
            float(per_example.shape[0]), device=per_example.device)
        return {"nll": weighted_mean(per_example, mask), "weight": weight}

    def stage_spec(spec):
        return (AxisNames.PIPE, *(None if a == AxisNames.FSDP else a for a in spec))

    rules = ShardingRules(
        [("^" + blocks_key + "/" + pat.pattern, stage_spec(spec))
         for pat, spec in transformer.GPT2_RULES.rules]
        + [("^" + blocks_key + "/", (AxisNames.PIPE,))])
    return Task(name="gpt2_124m_pp", init_fn=init_fn, loss_fn=loss_fn,
                make_optimizer=optimizers.adamw_cosine, eval_fn=eval_fn, sharding_rules=rules)


def datasets(cfg: Gpt2Config):
    """(train, eval) token windows: files under ``data_dir`` or the
    seeded synthetic bigram streams."""
    kw = dict(seq_len=cfg.seq_len, vocab_size=cfg.vocab_size)
    return load_lm_tokens(cfg.data_dir, "train", **kw), eval_dataset(cfg)


def eval_dataset(cfg: Gpt2Config):
    """The ``val`` split; a ``data_dir`` without one evaluates on
    synthetic data, with a warning, as the reference does."""
    has_val = bool(cfg.data_dir) and any(
        os.path.exists(os.path.join(cfg.data_dir, "val" + ext)) for ext in (".bin", ".npy", ".txt")
    )
    if cfg.data_dir and not has_val:
        logging.getLogger(__name__).warning(
            "--data_dir=%s has no val.{bin,npy,txt}; eval runs on SYNTHETIC data", cfg.data_dir)
    return load_lm_tokens(cfg.data_dir if has_val else "", "val", seq_len=cfg.seq_len,
                          vocab_size=cfg.vocab_size)
