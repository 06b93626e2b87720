"""BERT encoder and GLUE heads: the port of
``tensorflow_examples_tpu/models/bert.py``.

Parameter names and layouts are the reference's flax paths with ``.``
for ``/`` (``models/convert.py``): under ``bert``, ``word_embeddings``,
``position_embeddings`` and ``token_type_embeddings`` (``embedding``
[n, d]), ``embeddings_ln``, and per layer ``layer_i.attn_qkv`` (kernel
[d, 3, H, hd], bias [3, H, hd]), ``attn_proj`` (kernel [H, hd, d]),
``attn_ln``, ``ffn_in`` ([d, ff]), ``ffn_out`` ([ff, d]) and ``ffn_ln``;
then ``bert.pooler`` [d, d] and the head ``classifier`` [d, num_labels]
(``num_labels`` 1 is STS-B's regression head). Random init follows
flax's: normal(0.02) embeddings, LeCun truncated-normal kernels, zero
biases, unit LayerNorm scales, from an explicit ``torch.Generator``.

The math is the reference's: post-LN layers ``LN(x + sublayer)`` with
eps 1e-12 and f32 statistics, exact (erf) gelu, a pooler
``tanh(Dense(x[:, 0]))``, and the head in f32 on the f32-cast pooled
output. The padding mask becomes an f32 key bias, 0 where a key is real
and ``NEG_INF`` where it is padding. ``attention="xla"`` is the plain
path: f32 scores plus the bias, softmax in f32, probabilities cast to the
compute dtype (``ops/attention.attention_reference``);
``attention="flash"`` runs the flash kernels non-causal with the bias as
their key bias (``ops/attention.flash_attention``, reached through
``parallel/attention.mesh_attention`` on one device and on a mesh), on
the tensor cores in bf16. Under ``train=True`` dropout runs at the reference's
sites (embeddings; each layer's attention and FFN outputs; the pooled
output) with masks from the step's ``core/rng.StepNoise``, as the GPT-2
forward's (``models/transformer.Dropout``).

Meshes (``encode``/``forward`` with ``mesh=``, per-rank code): the
parameters are this rank's shards under :data:`BERT_RULES`, the
reference's table (FSDP pieces already gathered by the trainer). On a
``model`` > 1 mesh a layer is Megatron's, as the GPT-2 block
(``models/transformer.py``): qkv ``[d, 3, H, hd]`` split by heads and
``ffn_in`` by columns take their input through ``collectives.copy_to``,
``attn_proj`` and ``ffn_out`` split by rows are summed with ``psum``
before their replicated bias, and attention runs on the rank's heads.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_examples_torch.core import collectives as coll
from tensorflow_examples_torch.core import rng as rng_mod
from tensorflow_examples_torch.core.mesh import AxisNames
from tensorflow_examples_torch.core.sharding import ShardingRules
from tensorflow_examples_torch.models.mlp import Dense
from tensorflow_examples_torch.models.transformer import Dropout, Embed, LayerNorm, _layer_norm
from tensorflow_examples_torch.ops.attention import attention_reference
from tensorflow_examples_torch.parallel.attention import mesh_attention

NEG_INF = -1e30
ATTENTION_IMPLS = ("xla", "flash")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_len: int = 512
    type_vocab_size: int = 2
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    attention: str = "xla"  # xla (plain) | flash (the flash kernels, key-bias mask)

    def __post_init__(self):
        if self.attention not in ATTENTION_IMPLS:
            raise ValueError(f"attention={self.attention!r}; expected 'xla' or 'flash'")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def bert_base(**overrides) -> BertConfig:
    return BertConfig(**overrides)


# The reference's BERT_RULES (core/sharding.py): the GPT-2 table's
# layout, qkv split by heads over ``model``, the projections
# row-parallel, the kernels' other dim over ``fsdp``.
_M, _F = AxisNames.MODEL, AxisNames.FSDP
BERT_RULES = ShardingRules([
    (r"attn_qkv/kernel", (_F, None, _M, None)),
    (r"attn_qkv/bias", (None, _M, None)),
    (r"attn_proj/kernel", (_M, None, _F)),
    (r"ffn_in/kernel", (_F, _M)),
    (r"ffn_in/bias", (_M,)),
    (r"ffn_out/kernel", (_M, _F)),
])


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None, device=None):
        super().__init__()
        d, h, hd, ff = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff
        self.attn_qkv = Dense((d, 3, h, hd), (3, h, hd), d, generator, device)
        self.attn_proj = Dense((h, hd, d), (d,), h * hd, generator, device)
        self.attn_ln = LayerNorm(d, device)
        self.ffn_in = Dense((d, ff), (ff,), d, generator, device)
        self.ffn_out = Dense((ff, d), (d,), ff, generator, device)
        self.ffn_ln = LayerNorm(d, device)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None, device=None):
        super().__init__()
        d = cfg.d_model
        self.word_embeddings = Embed(cfg.vocab_size, d, 0.02, generator, device)
        self.position_embeddings = Embed(cfg.max_len, d, 0.02, generator, device)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, d, 0.02, generator, device)
        self.embeddings_ln = LayerNorm(d, device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, generator, device))
        self.pooler = Dense((d, d), (d,), d, generator, device)


class BertClassifier(nn.Module):
    """The encoder and a task head; ``forward`` gives f32 logits
    [B, num_labels]. ``seed`` draws the random init from a CPU
    ``torch.Generator`` (``device="meta"`` builds shapes only)."""

    def __init__(self, cfg: BertConfig, num_labels: int = 2, *, seed: int = 0, device=None):
        super().__init__()
        self.cfg, self.num_labels = cfg, num_labels
        gen = None
        if torch.device(device or "cpu").type != "meta":
            gen = torch.Generator(device="cpu").manual_seed(seed)
        self.bert = BertEncoder(cfg, gen, device)
        self.classifier = Dense((cfg.d_model, num_labels), (num_labels,), cfg.d_model, gen, device)

    def forward(self, tokens, attention_mask=None, token_type_ids=None, *, train: bool = False,
                noise: rng_mod.StepNoise | None = None) -> torch.Tensor:
        return forward(self.cfg, self, tokens, attention_mask, token_type_ids, train=train,
                       noise=noise)


def key_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """The padding mask [B, S] as an f32 additive key bias: 0 on real
    keys, ``NEG_INF`` on padding."""
    zero = torch.zeros((), dtype=torch.float32, device=attention_mask.device)
    return torch.where(attention_mask > 0, zero, NEG_INF)


def _attend(q, k, v, bias, impl: str, mesh=None):
    """Bidirectional attention of [B, S, H, hd] operands under the key
    bias; ``mesh``: the operands are this rank's heads."""
    swap = lambda t: t.transpose(1, 2)  # [B,S,H,D] <-> [B,H,S,D]
    if impl == "flash":
        out = mesh_attention(swap(q), swap(k), swap(v), mesh=mesh, causal=False, key_bias=bias)
    else:
        out = attention_reference(swap(q), swap(k), swap(v), causal=False, key_bias=bias)
    return swap(out)


def _dense(x, dense):
    return x @ dense.kernel + dense.bias


def _layer(x, p, bias, cfg: BertConfig, drop: Dropout, layer: int, mesh=None):
    """One post-LN layer over ``p``, the layer's parameters (this rank's
    heads and FFN columns on a ``model`` mesh)."""
    enter = reduce = lambda t: t
    if mesh is not None and mesh.axis_size(AxisNames.MODEL) > 1:
        enter = lambda t: coll.copy_to(t, AxisNames.MODEL, mesh=mesh)
        reduce = lambda t: coll.psum(t, AxisNames.MODEL, mesh=mesh)
    w = p.attn_qkv.kernel  # [d, 3, H, hd]
    qkv = (enter(x) @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])
    qkv = qkv + p.attn_qkv.bias
    ctx = _attend(qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :], bias, cfg.attention,
                  mesh)
    proj = p.attn_proj.kernel  # [H, hd, d]
    attn_out = reduce(ctx.reshape(*ctx.shape[:-2], -1) @ proj.reshape(-1, proj.shape[-1]))
    attn_out = attn_out + p.attn_proj.bias
    x = _layer_norm(x + drop(attn_out, 2 * layer + 1), p.attn_ln, cfg.layer_norm_eps)
    h = F.gelu(_dense(enter(x), p.ffn_in))  # exact erf gelu
    y = reduce(h @ p.ffn_out.kernel) + p.ffn_out.bias
    return _layer_norm(x + drop(y, 2 * layer + 2), p.ffn_ln, cfg.layer_norm_eps)


def encode(cfg: BertConfig, params, tokens: torch.Tensor, attention_mask=None,
           token_type_ids=None, *, train: bool = False,
           noise: rng_mod.StepNoise | None = None, drop: Dropout | None = None, mesh=None):
    """(sequence output [B, S, d], pooled [B, d]) in the parameters'
    dtype; ``params`` is a :class:`BertClassifier` or a
    :class:`~tensorflow_examples_torch.models.transformer.ParamView`.
    ``mesh``: ``tokens`` are this rank's rows and ``params`` its shards
    under :data:`BERT_RULES` (see the module docstring)."""
    if mesh is not None and mesh.trivial:
        mesh = None
    if attention_mask is None:
        attention_mask = torch.ones_like(tokens)
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(tokens)
    enc = params.bert
    drop = drop or Dropout(cfg.dropout, noise if train else None)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    emb = F.embedding(tokens, enc.word_embeddings.embedding)
    emb = emb + F.embedding(positions, enc.position_embeddings.embedding)[None]
    # The type table has 2 rows, each looked up by half the batch's
    # tokens: a one-hot product, whose backward is a matmul. The embedding
    # backward over so many repeats of one row is not bitwise repeatable
    # on the card (chip_probe.py determinism); the forward gives the same
    # rows exactly.
    table = enc.token_type_embeddings.embedding
    emb = emb + F.one_hot(token_type_ids.long(), table.shape[0]).to(table.dtype) @ table
    x = drop(_layer_norm(emb, enc.embeddings_ln, cfg.layer_norm_eps), 0)
    bias = key_bias(attention_mask)
    for i in range(cfg.num_layers):
        x = _layer(x, getattr(enc, f"layer_{i}"), bias, cfg, drop, i, mesh)
    return x, torch.tanh(_dense(x[:, 0], enc.pooler))


def forward(cfg: BertConfig, params, tokens: torch.Tensor, attention_mask=None,
            token_type_ids=None, *, train: bool = False,
            noise: rng_mod.StepNoise | None = None, mesh=None) -> torch.Tensor:
    """The classifier's f32 logits [B, num_labels]: the encoder, dropout
    on the pooled output, then the head in f32 (``mesh``: see
    :func:`encode`)."""
    drop = Dropout(cfg.dropout, noise if train else None)
    _, pooled = encode(cfg, params, tokens, attention_mask, token_type_ids, train=train,
                       drop=drop, mesh=mesh)
    pooled = drop(pooled, 2 * cfg.num_layers + 1)
    head = params.classifier
    return pooled.float() @ head.kernel.float() + head.bias.float()

