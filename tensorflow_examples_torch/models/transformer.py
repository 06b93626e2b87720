"""GPT-2 decoder-only transformer as a PyTorch module.

The port of ``tensorflow_examples_tpu/models/transformer.py``. Parameter
names and layouts are the reference's, so a ``state_dict`` key is the
flax param path with ``.`` for ``/`` (``models/convert.py`` relies on
that):

* ``wte.embedding`` [V, d], ``wpe.embedding`` [max_len, d];
* ``h_i.ln_1`` / ``h_i.ln_2`` / ``ln_f``: ``scale`` and ``bias`` [d];
* ``h_i.attn.qkv.kernel`` [d, 3, H, hd] with ``bias`` [3, H, hd];
* ``h_i.attn.proj.kernel`` [H, hd, d] with ``bias`` [d];
* ``h_i.mlp_fc`` ([d, ff], [ff]) and ``h_i.mlp_proj`` ([ff, d], [d]);
  in an MoE block (``cfg.use_moe(i)``) ``h_i.moe`` in their place:
  ``gate`` [d, E], ``w_in`` [E, d, ff], ``b_in`` [E, ff], ``w_out``
  [E, ff, d], ``b_out`` [E, d];
* the LM head is tied: ``logits = x @ wte.embedding.T``.

Random init follows the reference: normal(0.02) for kernels and
``wte``, normal(0.01) for ``wpe``, std 0.02 / sqrt(2 L) for the residual
projections (``attn.proj``, ``mlp_proj`` and ``moe.w_out``), zero
biases, unit LayerNorm scales, drawn from an explicit ``torch.Generator``.

The layer math (``_embed``, ``_layer_norm``, ``_qkv``, ``_attn_out``,
``_block_mlp``) lives here and the serving engine imports it. Math is
the reference's: pre-LN blocks, LayerNorm eps 1e-5 with its statistics
in f32 whatever the compute dtype (as flax's), tanh-approximate gelu,
logits in the compute dtype from the tied ``wte``. ``GPT2.forward`` is
the training forward: causal self-attention through the flash kernels
(``attention="flash"``) or the plain reference (``"xla"``); under
``train=True`` dropout at the reference's three sites (embeddings,
attention output, MLP output) with masks from the step's noise source
(``core/rng.StepNoise``: explicit generators keyed by the step key, not
flax's bits; each site's mask is drawn once a step and kept for a
recomputed block).

``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, non-reentrant), and ``remat_policy`` says
what a checkpointed block saves, as the reference's
``jax.checkpoint_policies``: ``none`` saves nothing and recomputes the
whole block; ``dots`` saves the outputs of the matrix products
(``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``) through
``torch.utils.checkpoint.create_selective_checkpoint_contexts`` and
recomputes the rest; ``dots_no_batch`` saves only ``mm``/``addmm`` (the
batched products are attention's). The hand-written flash attention and
cross-entropy kernels are bound through the port's own loader
(``ops/_build.py``), not as dispatcher ops, so no policy can see them:
they are recomputed under every policy. Numerics are identical across
policies; only memory moves. Under ``core/nans.finite_checks`` (the
trainer's ``debug_nans``) the forward raises ``FloatingPointError``
naming the first block whose output is not finite. Parameters run in whatever dtype they hold:
the precision policy (``core/precision.py``) hands the module
compute-dtype copies.

Mixture-of-Experts (``moe_experts`` E > 0): the MLP of every
``moe_every``-th block is a top-``moe_top_k`` MoE over E experts
(``parallel/moe.py``; the expert weights cast to the activations' dtype,
the router in f32). At ``train=True`` with a noise source, block i's
router jitter comes from ``fold_in_static(key, ("h_i", "moe", 1))``, the
key flax's ``make_rng("dropout")`` gives the reference's ``MoeMlp``, so
the jitter equals jax's bit for bit (``core/rng.StepNoise.router_jitter``). ``forward(..., moe_stats=True)`` also
returns the summed aux loss and the mean dropped fraction of the MoE
blocks, which the reference sows as intermediates.

Meshes (``forward(..., mesh=...)``, per-rank code): the block takes
this rank's shards under :data:`GPT2_RULES`, the reference's table. qkv
``[d, 3, H, hd]`` is split over ``model`` by heads (dim 2; the kernel is
flattened to ``[d, 3 * H/m * hd]`` only after the split), ``proj`` and
``mlp_proj`` by rows, ``mlp_fc`` by columns: each normalized input
enters through ``collectives.copy_to`` and each row-parallel output is
summed with ``psum`` before its bias. Attention runs through
``parallel/attention.mesh_attention`` (the ring or Ulysses over
``context``), positions start at this rank's sequence shard, and a token
table split by vocab looks its ids up on the rank holding them. An MoE
block runs ``parallel/moe.moe_ffn_ep``: its experts split over
``model``, the router's jitter key folded by each route axis's index.

Decoding (the reference's ``sample_tokens``, ``init_cache`` and
``generate``): :class:`KVCache` holds each layer's keys and values at
[B, H, max_len, D] and the next write position; :func:`decode_step`
appends q_len tokens and attends over the cache through the
flash-decode kernel (``attention="flash"``, ``ops/decode.py``) or the
plain masked reference (``"xla"``), as the reference's
``_decode_attend``; an MoE block routes its tokens without jitter. The
cache is updated in place, where the reference threads a new one through
each call. :func:`generate` prefills the
prompt in one call, then takes one token per call; its keys come from
``core/rng.split`` as jax's, so greedy and sampled streams follow the
reference's. Both take ``mesh=``: each rank decodes its batch rows with
its heads (``parallel/attention.mesh_decode_attention`` under
``"flash"``), the row-parallel products summed over ``model``, as the
training forward's tensor parallelism.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint, create_selective_checkpoint_contexts,
                                     noop_context_fn)

from tensorflow_examples_torch.core import collectives as coll
from tensorflow_examples_torch.core import rng as rng_mod
from tensorflow_examples_torch.core.mesh import AxisNames
from tensorflow_examples_torch.core.nans import check_finite
from tensorflow_examples_torch.core.sharding import ShardingRules, batch_rows
from tensorflow_examples_torch.core.precision import materialize as _w
from tensorflow_examples_torch.core.precision import take_rows as _rows
from tensorflow_examples_torch.ops.attention import NEG_INF, attention_reference, flash_attention
from tensorflow_examples_torch.ops.decode import decode_attention_reference
from tensorflow_examples_torch.parallel.attention import (decode_spec, mesh_attention,
                                                         mesh_decode_attention)
from tensorflow_examples_torch.parallel.moe import moe_ffn, moe_ffn_ep

ATTENTION_IMPLS = ("flash", "xla", "ring", "ulysses")
_aten = torch.ops.aten
# What a checkpointed block saves under each remat_policy ("none": nothing).
REMAT_SAVES = {
    "none": (),
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    max_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 0  # 0 -> 4 * d_model
    dropout: float = 0.1
    attention: str = "flash"  # flash (the flash kernels) | xla (plain) | ring | ulysses
    #   (the context-parallel algorithm on a mesh with context > 1; flash elsewhere)
    remat: bool = False  # recompute each block in the backward
    remat_policy: str = "none"  # none | dots | dots_no_batch: what a remat block saves
    # Mixture-of-Experts: 0 = dense MLP everywhere; E > 0 swaps the MLP of
    # every moe_every-th block for a top-moe_top_k MoE of E experts.
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1
    # "" = the device's default (grouped on CUDA, scatter on the CPU); pin
    # "grouped" (dropless) or "scatter" (drops at capacity) for one function.
    moe_impl: str = ""

    def use_moe(self, layer: int) -> bool:
        return self.moe_experts > 0 and layer % self.moe_every == self.moe_every - 1

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model


def gpt2_124m(**overrides) -> TransformerConfig:
    return TransformerConfig(**overrides)


# TP/FSDP rules (core/sharding.py), the reference's GPT2_RULES: axes of
# size 1 drop out, so one table serves pure DP through 2-D meshes. qkv
# [d, 3, H, hd] is split by heads (dim 2), the projections row-parallel.
_M, _F = AxisNames.MODEL, AxisNames.FSDP
GPT2_RULES = ShardingRules([
    (r"attn/qkv/kernel", (_F, None, _M, None)),
    (r"attn/qkv/bias", (None, _M, None)),
    (r"attn/proj/kernel", (_M, None, _F)),
    (r"mlp_fc/kernel", (_F, _M)),
    (r"mlp_fc/bias", (_M,)),
    (r"mlp_proj/kernel", (_M, _F)),
    # MoE expert parallelism: experts ride the `model` axis.
    (r"moe/w_in", (_M, None, None)),
    (r"moe/b_in", (_M, None)),
    (r"moe/w_out", (_M, None, None)),
    (r"moe/b_out", (_M, None)),
])


def _normal(shape, std, generator, device):
    if generator is None:  # meta device: shapes only
        return nn.Parameter(torch.empty(shape, device=device))
    # Drawn on the CPU generator, then moved: a seed gives the same
    # weights whichever device serves them.
    t = torch.empty(shape, dtype=torch.float32).normal_(0.0, std, generator=generator)
    return nn.Parameter(t.to(device))


class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral`` layout: ``kernel`` [in..., out...]."""

    def __init__(self, kernel_shape, bias_shape, std, generator=None, device=None):
        super().__init__()
        self.kernel = _normal(kernel_shape, std, generator, device)
        self.bias = nn.Parameter(torch.zeros(bias_shape, device=device))


class LayerNorm(nn.Module):
    def __init__(self, d, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))


class Embed(nn.Module):
    def __init__(self, n, d, std, generator=None, device=None):
        super().__init__()
        self.embedding = _normal((n, d), std, generator, device)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator=None, device=None):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
        out_std = 0.02 / (2 * cfg.num_layers) ** 0.5
        self.qkv = Dense((d, 3, h, hd), (3, h, hd), 0.02, generator, device)
        self.proj = Dense((h, hd, d), (d,), out_std, generator, device)


class MoeMlp(nn.Module):
    """The reference's ``MoeMlp`` parameters: router ``gate`` and the
    experts' FFN weights with a leading [E] axis."""

    def __init__(self, cfg: TransformerConfig, generator=None, device=None):
        super().__init__()
        e, d, ff = cfg.moe_experts, cfg.d_model, cfg.ff_dim
        out_std = 0.02 / (2 * cfg.num_layers) ** 0.5
        self.gate = _normal((d, e), 0.02, generator, device)
        self.w_in = _normal((e, d, ff), 0.02, generator, device)
        self.b_in = nn.Parameter(torch.zeros(e, ff, device=device))
        self.w_out = _normal((e, ff, d), out_std, generator, device)
        self.b_out = nn.Parameter(torch.zeros(e, d, device=device))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator=None, device=None, use_moe=False):
        super().__init__()
        d, ff = cfg.d_model, cfg.ff_dim
        out_std = 0.02 / (2 * cfg.num_layers) ** 0.5
        self.ln_1 = LayerNorm(d, device)
        self.attn = Attention(cfg, generator, device)
        self.ln_2 = LayerNorm(d, device)
        if use_moe:
            self.moe = MoeMlp(cfg, generator, device)
        else:
            self.mlp_fc = Dense((d, ff), (ff,), 0.02, generator, device)
            self.mlp_proj = Dense((ff, d), (d,), out_std, generator, device)


# ------------------------------------------------------------ layer math
#
# Plain functions over the GPT2 module's parameters (the reference's
# names), shared by the training forward here and the serving engine.
# Every matmul weight is read through ``core/precision.materialize``
# (``_w``) and every embedding table through ``take_rows`` (``_rows``):
# the identity (``F.embedding`` for a table) on a plain tensor, a
# dequantization where the serving engine holds a QuantizedWeight.


def _embed(model: "GPT2", tokens, positions):
    return _rows(model.wte.embedding, tokens) + _rows(model.wpe.embedding, positions)


def _embed_vocab_parallel(wte, tokens, mesh):
    """Rows of a token table split over ``model`` by vocab (this rank's
    rows ``[i*V/m, (i+1)*V/m)``): each rank looks up the ids it holds and
    ``psum`` adds the pieces, each id found on exactly one rank."""
    rows = wte.shape[0]
    local = tokens - mesh.axis_index(AxisNames.MODEL) * rows
    mine = (local >= 0) & (local < rows)
    emb = _rows(wte, torch.where(mine, local, 0))
    return coll.psum(emb * mine[..., None].to(emb.dtype), AxisNames.MODEL, mesh=mesh)


def _vocab_split(params, cfg: TransformerConfig, mesh) -> bool:
    """Whether this rank holds only its ``model`` share of the token table
    (``tp_vocab``'s rows)."""
    return mesh is not None and params.wte.embedding.shape[0] < cfg.vocab_size


def _embed_on(params, cfg: TransformerConfig, tokens, positions, mesh=None):
    """:func:`_embed` of this rank's params: a token table split by vocab
    looks its ids up on the rank holding them."""
    if _vocab_split(params, cfg, mesh):
        return (_embed_vocab_parallel(params.wte.embedding, tokens, mesh)
                + _rows(params.wpe.embedding, positions))
    return _embed(params, tokens, positions)


def _lm_head(x, params, cfg: TransformerConfig, mesh=None):
    """The tied head's logits; a token table split by vocab gathers each
    rank's columns over ``model``, so every rank holds all of them."""
    logits = x @ _w(params.wte.embedding).T
    if _vocab_split(params, cfg, mesh):
        logits = coll.all_gather(logits, AxisNames.MODEL, mesh=mesh, dim=logits.dim() - 1)
    return logits


def _layer_norm(x, ln, eps=1e-5):
    """flax ``LayerNorm``: mean and variance in f32 whatever ``x``'s
    dtype, the affine map in f32, the result in ``x``'s dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * ln.scale.float() + ln.bias.float()
    return y.to(x.dtype)


def _block_mlp(x, blk, reduce=None):
    """``reduce``: the ``model`` psum of the row-parallel product's
    partial sums, before its (replicated) bias."""
    h = F.gelu(x @ _w(blk.mlp_fc.kernel) + blk.mlp_fc.bias, approximate="tanh")
    y = h @ _w(blk.mlp_proj.kernel)
    return (reduce(y) if reduce is not None else y) + blk.mlp_proj.bias


def _mlp(x, blk, cfg: TransformerConfig, layer: int, moe_rng, reduce=None, mesh=None):
    """Block ``layer``'s MLP of ``x`` [B, L, d]: (y, moe aux, moe drop),
    the last two None for a dense block. ``moe_rng``: the router jitter's
    source (``parallel/moe.moe_ffn``'s ``rng``; None: no jitter). On a
    mesh an MoE block runs ``moe_ffn_ep`` (expert parallelism over
    ``model``; the single-program path where ``model`` is 1)."""
    if not cfg.use_moe(layer):
        return _block_mlp(x, blk, reduce), None, None
    moe, dt = blk.moe, x.dtype
    args = (moe.gate, moe.w_in.to(dt), moe.b_in.to(dt), moe.w_out.to(dt), moe.b_out.to(dt), x)
    kw = dict(capacity_factor=cfg.moe_capacity_factor, top_k=cfg.moe_top_k, rng=moe_rng,
              impl=cfg.moe_impl)
    if mesh is not None:
        return moe_ffn_ep(*args, mesh=mesh, **kw)
    return moe_ffn(*args, **kw)


def _qkv(x, attn):
    """[..., d] -> q, k, v each [..., H, hd]."""
    w = _w(attn.qkv.kernel)  # [d, 3, H, hd]
    y = (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])
    y = y + attn.qkv.bias
    return y[..., 0, :, :], y[..., 1, :, :], y[..., 2, :, :]


def _attn_out(att, attn, reduce=None):
    """[..., H, hd] attention output -> [..., d] residual contribution;
    ``reduce`` as :func:`_block_mlp`'s."""
    w = _w(attn.proj.kernel)  # [H, hd, d]
    y = att.reshape(*att.shape[:-2], -1) @ w.reshape(-1, w.shape[-1])
    return (reduce(y) if reduce is not None else y) + attn.proj.bias


def _self_attend(q, k, v, impl: str, mesh=None, stage: bool = False):
    """Causal self-attention of [B, S, H, hd] operands (this rank's
    shards on a mesh: ``parallel/attention.mesh_attention``; ``stage``:
    inside a pipeline stage)."""
    swap = lambda t: t.transpose(1, 2)  # [B,S,H,D] <-> [B,H,S,D]
    if mesh is not None:
        out = mesh_attention(swap(q), swap(k), swap(v), mesh=mesh, causal=True, impl=impl,
                             stage=stage)
    elif impl != "xla":
        out = flash_attention(swap(q), swap(k), swap(v), causal=True)
    else:
        out = attention_reference(swap(q), swap(k), swap(v), causal=True)
    return swap(out)


class Dropout:
    """The reference's dropout (``nn.Dropout``: keep with probability
    1 - rate, scale kept values by 1 / (1 - rate)) at numbered sites.
    Site ``i``'s mask comes from ``noise.dropout_uniform(i, ...)`` (a
    ``core/rng.StepNoise``), so a step's masks are a pure function of
    its key. Each site's mask is drawn once
    and kept, so a block recomputed under remat reuses it (a graph's
    generator cannot redraw the same bits). ``rate`` 0 or no noise: the
    identity."""

    def __init__(self, rate: float, noise):
        self.rate = float(rate) if noise is not None else 0.0
        self.noise = noise
        self._keep: dict[int, torch.Tensor] = {}

    def __call__(self, x: torch.Tensor, site: int) -> torch.Tensor:
        if self.rate <= 0.0:
            return x
        keep = self._keep.get(site)
        if keep is None:
            keep = self._keep[site] = (
                self.noise.dropout_uniform(site, x.shape, x.device) < 1.0 - self.rate)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))


def remat_context(policy: str):
    """The checkpoint ``context_fn`` of a ``remat_policy``."""
    if policy not in REMAT_SAVES:
        raise ValueError(f"remat_policy={policy!r} not in {sorted(REMAT_SAVES)}")
    if not REMAT_SAVES[policy]:
        return noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts, list(REMAT_SAVES[policy]))


def _block(x, blk, cfg: TransformerConfig, drop: Dropout, layer: int, moe_rng, mesh=None,
           stage: bool = False):
    """One training block: (x, moe aux, moe drop), as :func:`_mlp`. On a
    mesh with ``model`` > 1 (tensor parallelism, Megatron's layout) the
    block holds its heads' slice of qkv and its rows of ``proj``, and
    its ``d_ff`` slice of the MLP: each normalized input enters the
    sharded products through ``copy_to`` (its backward sums the
    partial input gradients over ``model``) and each row-parallel
    output is summed with ``psum`` before its bias. An MoE block's input
    goes to ``moe_ffn_ep`` as it is (replicated over ``model``): the
    expert-parallel dispatch splits the tokens itself. ``stage``: the
    block runs inside a pipeline stage."""
    enter = reduce = None
    if mesh is not None and mesh.axis_size(AxisNames.MODEL) > 1:
        enter = functools.partial(coll.copy_to, axis=AxisNames.MODEL, mesh=mesh)
        reduce = functools.partial(coll.psum, axis=AxisNames.MODEL, mesh=mesh)
    h = _layer_norm(x, blk.ln_1)
    q, k, v = _qkv(enter(h) if enter else h, blk.attn)
    att = _self_attend(q, k, v, cfg.attention, mesh, stage)
    x = x + drop(_attn_out(att, blk.attn, reduce), 2 * layer + 1)
    h = _layer_norm(x, blk.ln_2)
    if cfg.use_moe(layer):
        y, aux, dropped = _mlp(h, blk, cfg, layer, moe_rng, mesh=mesh)
    else:
        y, aux, dropped = _mlp(enter(h) if enter else h, blk, cfg, layer, moe_rng, reduce)
    return x + drop(y, 2 * layer + 2), aux, dropped


class GPT2(nn.Module):
    """GPT-2 causal LM; ``forward(tokens [B, L])`` returns logits
    [B, L, vocab]. ``seed`` draws the random init from a CPU
    ``torch.Generator`` (``device="meta"`` builds shapes only)."""

    def __init__(self, cfg: TransformerConfig, *, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        gen = None
        if torch.device(device or "cpu").type != "meta":
            gen = torch.Generator(device="cpu").manual_seed(seed)
        self.wte = Embed(cfg.vocab_size, cfg.d_model, 0.02, gen, device)
        self.wpe = Embed(cfg.max_len, cfg.d_model, 0.01, gen, device)
        for i in range(cfg.num_layers):
            self.add_module(f"h_{i}", Block(cfg, gen, device, cfg.use_moe(i)))
        self.ln_f = LayerNorm(cfg.d_model, device)

    def block(self, i: int) -> Block:
        return getattr(self, f"h_{i}")

    def forward(self, tokens: torch.Tensor, *, train: bool = False,
                noise: rng_mod.StepNoise | None = None) -> torch.Tensor:
        return forward(self.cfg, self, tokens, train=train, noise=noise)


class ParamView:
    """Attribute access over a flat ``{"h_0.attn.qkv.kernel": tensor}``
    dict (a :class:`GPT2`'s parameter names), so the layer math runs on
    any set of tensors: the precision policy's compute-dtype copies, or
    a trainer's parameters. Tensors are held, not copied, so a block
    recomputed under remat reads the very tensors the graph was built
    from."""

    def __init__(self, params, prefix: str = ""):
        self._params = params
        self._prefix = prefix

    def __getattr__(self, name):
        key = self._prefix + name
        if key in self._params:
            return self._params[key]
        if not any(k.startswith(key + ".") for k in self._params):
            raise AttributeError(f"no parameter under {key!r}")
        return ParamView(self._params, key + ".")

    def block(self, i: int) -> "ParamView":
        return getattr(self, f"h_{i}")


def forward(cfg: TransformerConfig, params, tokens: torch.Tensor, *, train: bool = False,
            noise: rng_mod.StepNoise | None = None, moe_stats: bool = False, mesh=None,
            return_hidden: bool = False):
    """The training forward: logits [B, L, vocab] of ``tokens`` [B, L] in
    the parameters' dtype. ``params`` is a :class:`GPT2` or a
    :class:`ParamView`. ``train`` turns dropout and the MoE router jitter
    on, drawn from ``noise``, the step's staged ``core/rng.StepNoise``
    (None: neither). ``moe_stats``: return
    ``(logits, moe_aux, moe_drop)``, the MoE blocks' summed aux loss and
    mean dropped fraction (f32 scalars; 0 for a dense model).
    ``return_hidden``: the final normalized hidden states [B, L, d] in
    place of the logits (the vocab-parallel head's input).

    ``mesh`` (``core/mesh.Mesh``): ``tokens`` are this rank's rows and,
    with ``context`` > 1, its contiguous sequence shard (positions start
    at ``context index * L``); ``params`` hold this rank's shards under
    :data:`GPT2_RULES` (FSDP pieces already gathered), with a token
    table split by vocab over ``model`` when its rows are fewer than
    ``vocab_size`` (``workloads/gpt2.py`` ``tp_vocab``)."""
    if cfg.attention not in ATTENTION_IMPLS:
        raise ValueError(f"attention={cfg.attention!r} not in {ATTENTION_IMPLS}")
    if mesh is not None and mesh.trivial:
        mesh = None
    noise = noise if train else None
    drop = Dropout(cfg.dropout, noise)
    start = 0
    if mesh is not None:
        start = mesh.axis_index(AxisNames.CONTEXT) * tokens.shape[1]
    positions = torch.arange(start, start + tokens.shape[1], device=tokens.device)
    x = drop(_embed_on(params, cfg, tokens, positions[None], mesh), 0)
    check_finite(x, "the embeddings")
    remat = cfg.remat and torch.is_grad_enabled()
    context_fn = remat_context(cfg.remat_policy) if remat else None
    auxes, drops = [], []
    for layer in range(cfg.num_layers):
        moe_rng = None
        if noise is not None and cfg.use_moe(layer):
            moe_rng = functools.partial(noise.router_jitter, layer)
        args = (x, params.block(layer), cfg, drop, layer, moe_rng, mesh)
        if remat:
            # No default generator draws inside a block (dropout and jitter
            # come from the step's noise), so nothing to stash for the
            # recompute; stashing would also touch generator state that a
            # CUDA graph capture forbids.
            x, aux, dropped = checkpoint(_block, *args, use_reentrant=False,
                                         preserve_rng_state=False, context_fn=context_fn)
        else:
            x, aux, dropped = _block(*args)
        check_finite(x, f"h_{layer}")
        if aux is not None:
            auxes.append(aux)
            drops.append(dropped)
    hidden = _layer_norm(x, params.ln_f)
    if return_hidden:
        logits = hidden
    else:
        logits = hidden @ params.wte.embedding.T
        check_finite(logits, "the LM head")
    if not moe_stats:
        return logits
    if not auxes:
        zero = torch.zeros((), device=tokens.device)
        return logits, zero, zero
    return logits, sum(auxes), sum(drops) / len(drops)


# ---------------------------------------------------------------- decoding


def sample_tokens(logits: torch.Tensor, key: np.ndarray | None, *, temperature: float = 1.0,
                  top_k: int = 0) -> torch.Tensor:
    """Next-token ids [...] from ``logits`` [..., vocab]: greedy at
    ``temperature == 0``, else a categorical draw under ``key`` after
    dividing by the temperature and, with ``top_k > 0``, keeping the k
    largest logits."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, NEG_INF, logits)
    return torch.as_tensor(rng_mod.categorical(key, logits)).to(logits.device)


@dataclasses.dataclass
class KVCache:
    """Per-layer keys and values [B, H, max_len, D] and the next write
    position (the reference's ``cache`` collection)."""
    k: list[torch.Tensor]
    v: list[torch.Tensor]
    index: int = 0


def init_cache(cfg: TransformerConfig, batch_size: int, *, dtype=torch.float32,
               device=None, num_heads: int | None = None) -> KVCache:
    """An empty cache of zeros in ``dtype``; ``num_heads``: the heads this
    rank holds (all of them by default)."""
    shape = (batch_size, num_heads or cfg.num_heads, cfg.max_len, cfg.head_dim)
    zeros = lambda: [torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(cfg.num_layers)]
    return KVCache(zeros(), zeros())


def _decode_attend(cfg: TransformerConfig, q, k, v, cache: KVCache, layer: int, mesh=None):
    """Write the new k/v [B, q_len, H, D] into the cache at its index and
    attend q over the populated prefix; returns [B, q_len, H, D]."""
    i0, q_len = cache.index, q.shape[1]
    swap = lambda t: t.transpose(1, 2)  # [B,S,H,D] <-> [B,H,S,D]
    ck, cv = cache.k[layer], cache.v[layer]
    ck[:, :, i0:i0 + q_len] = swap(k).to(ck.dtype)
    cv[:, :, i0:i0 + q_len] = swap(v).to(cv.dtype)
    if cfg.attention == "xla":
        attend = decode_attention_reference
    else:
        attend = functools.partial(mesh_decode_attention, mesh=mesh)
    out = attend(swap(q).contiguous(), ck, cv, i0 + q_len, sm_scale=cfg.head_dim ** -0.5)
    return swap(out)


@torch.no_grad()
def decode_step(cfg: TransformerConfig, params, tokens: torch.Tensor, cache: KVCache, *,
                mesh=None) -> torch.Tensor:
    """Logits [B, q_len, vocab] of ``tokens`` [B, q_len] at positions
    ``cache.index ...``; appends their keys and values to ``cache``.

    ``mesh``: ``params`` are this rank's shards under :data:`GPT2_RULES`
    (its heads' qkv columns and proj rows, its ``mlp_fc`` columns and
    ``mlp_proj`` rows), ``tokens`` and ``cache`` its batch rows and heads
    (``parallel/attention.decode_spec``). Each row-parallel product is
    summed over ``model`` before its bias, decode attention under
    ``"flash"`` is ``mesh_decode_attention``, and a token table split by
    vocab looks its ids up on the rank holding them and gathers the
    logits: every rank of a ``model`` group returns the same logits."""
    if cfg.attention not in ATTENTION_IMPLS:
        raise ValueError(f"attention={cfg.attention!r} not in {ATTENTION_IMPLS}")
    if mesh is not None and mesh.trivial:
        mesh = None
    if mesh is not None and cfg.moe_experts:
        raise ValueError("decoding on a mesh covers dense models")
    reduce = None
    if mesh is not None and mesh.axis_size(AxisNames.MODEL) > 1:
        reduce = functools.partial(coll.psum, axis=AxisNames.MODEL, mesh=mesh)
    positions = cache.index + torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed_on(params, cfg, tokens, positions[None], mesh)
    for layer in range(cfg.num_layers):
        blk = params.block(layer)
        q, k, v = _qkv(_layer_norm(x, blk.ln_1), blk.attn)
        x = x + _attn_out(_decode_attend(cfg, q, k, v, cache, layer, mesh), blk.attn, reduce)
        x = x + _mlp(_layer_norm(x, blk.ln_2), blk, cfg, layer, None, reduce)[0]
    cache.index += tokens.shape[1]
    return _lm_head(_layer_norm(x, params.ln_f), params, cfg, mesh)


@torch.no_grad()
def generate(cfg: TransformerConfig, params, prompt: torch.Tensor, *, num_tokens: int,
             key: np.ndarray, temperature: float = 1.0, top_k: int = 0,
             mesh=None) -> torch.Tensor:
    """``num_tokens`` continuations of ``prompt`` [B, L] (greedy at
    temperature 0): one prefill call, then one call per token. Returns
    [B, L + num_tokens] on the prompt's device.

    ``mesh``: ``params`` are this rank's shards (:func:`decode_step`) and
    ``prompt`` the whole batch, of which the rank decodes its rows of
    ``parallel/attention.decode_spec`` (all of them when the batch axes
    do not divide B) with its heads; every rank returns the whole
    result, gathered over the batch axes. A sampled step draws from the
    whole batch's logits, gathered, so its noise is the one-device
    run's."""
    b, prompt_len = prompt.shape
    if prompt_len + num_tokens > cfg.max_len:
        raise ValueError(f"prompt ({prompt_len}) + num_tokens ({num_tokens}) exceeds "
                         f"max_len ({cfg.max_len})")
    if mesh is not None and mesh.trivial:
        mesh = None
    batch_axes = None
    if mesh is not None:
        entry = decode_spec(mesh, b, cfg.num_heads)[0]
        if entry is not None:
            batch_axes = (entry,) if isinstance(entry, str) else entry
            prompt = prompt[batch_rows(b, mesh, batch_axes)]
    # The cache's dtype follows the token-embedding table, as the reference's.
    cache = init_cache(cfg, prompt.shape[0], dtype=params.wte.embedding.dtype,
                       device=prompt.device,
                       num_heads=params.block(0).attn.qkv.kernel.shape[2])

    def sample(logits, k):
        if batch_axes is not None and temperature > 0.0:
            whole = coll.all_gather(logits, batch_axes, mesh=mesh, dim=0)
            return sample_tokens(whole, k, temperature=temperature,
                                 top_k=top_k)[batch_rows(b, mesh, batch_axes)]
        return sample_tokens(logits, k, temperature=temperature, top_k=top_k)

    logits = decode_step(cfg, params, prompt, cache, mesh=mesh)
    key, sub = rng_mod.split(key)
    out = [sample(logits[:, -1], sub)]
    keys = rng_mod.split(key, num_tokens - 1) if num_tokens > 1 else []
    for k in keys:
        out.append(sample(decode_step(cfg, params, out[-1][:, None], cache, mesh=mesh)[:, -1],
                          k))
    out = torch.cat([prompt, torch.stack(out, dim=1).to(prompt.dtype)], dim=1)
    if batch_axes is not None:
        out = coll.all_gather(out, batch_axes, mesh=mesh, dim=0)
    return out


# ------------------------------------------------------- pipeline pieces
#
# The reference's pipeline-parallel GPT-2 (workloads/gpt2.py,
# parallel/pipeline.py) keeps the embeddings and the tied head, which
# every pipe rank holds, apart from the blocks, stacked on a leading
# [num_layers] dim split over ``pipe``: parameters ``embed.{wte,wpe,ln_f}``
# and ``blocks.<block param>`` [L, ...] (the JAX tree ``{"embed": ...,
# "blocks": ...}`` with ``.`` for ``/``). The stacked blocks are dense, as
# the reference's ``Block(cfg, None, train, False)``.


class EmbedHead:
    """The embedding in (``encode``: wte + wpe, then the embedding
    dropout, site 0) and the tied head out (``logits``: ``ln_f``, then
    ``@ wte.T``) over a view of the ``embed`` parameters."""

    def encode(self, params, tokens: torch.Tensor, drop: "Dropout | None" = None):
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = _embed(params, tokens, positions[None])
        return drop(x, 0) if drop is not None else x

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        return _layer_norm(x, params.ln_f) @ params.wte.embedding.T


class _MicrobatchSites:
    """Dropout sites of microbatch ``mb``: a block's sites shifted past
    every earlier microbatch's (``2 L`` a microbatch, site 0 being the
    embedding's), so each (microbatch, layer, site) draws its own mask,
    whichever schedule runs it."""

    def __init__(self, drop: Dropout, offset: int):
        self.drop, self.offset = drop, offset

    def __call__(self, x, site: int):
        return self.drop(x, site + self.offset)


def stack_params_for_pipeline(params, num_layers: int) -> dict:
    """A :class:`GPT2`'s ``{name: tensor}`` (``wte``/``wpe``/``h_i``/``ln_f``)
    -> the pipeline layout ``{"embed.<name>": ..., "blocks.<block param>":
    [L, ...] stacked}`` (the reference's ``stack_params_for_pipeline``)."""
    out = {f"embed.{k}": v for k, v in params.items() if not k.startswith("h_")}
    names = [k[len("h_0."):] for k in params if k.startswith("h_0.")]
    for n in names:
        out[f"blocks.{n}"] = torch.stack([params[f"h_{i}.{n}"] for i in range(num_layers)])
    return out


def apply_stacked_blocks(cfg: TransformerConfig, params, x: torch.Tensor, *, layer0: int = 0,
                         drop: Dropout | None = None, mb: int = 0, mesh=None) -> torch.Tensor:
    """The blocks of ``params`` (``{block param: [k, ...]}``, logical layers
    ``layer0 .. layer0 + k - 1``) applied in order to ``x``, inside a
    pipeline stage on ``mesh``. ``drop``: the step's dropout
    (:class:`Dropout`), at microbatch ``mb``'s own sites."""
    names = list(params)
    sites = _MicrobatchSites(drop or Dropout(0.0, None), mb * 2 * cfg.num_layers)
    for i, tensors in enumerate(zip(*(torch.unbind(params[n]) for n in names))):
        blk = ParamView(dict(zip(names, tensors)))
        x = _block(x, blk, cfg, sites, layer0 + i, None, mesh, stage=True)[0]
        check_finite(x, f"h_{layer0 + i}")
    return x
