"""GPT-2 decoder-only transformer as a PyTorch module.

The port of ``tensorflow_examples_tpu/models/transformer.py`` for the
serving path. Parameter names and layouts are the reference's, so a
``state_dict`` key is the flax param path with ``.`` for ``/``
(``models/convert.py`` relies on that):

* ``wte.embedding`` [V, d], ``wpe.embedding`` [max_len, d];
* ``h_i.ln_1`` / ``h_i.ln_2`` / ``ln_f``: ``scale`` and ``bias`` [d];
* ``h_i.attn.qkv.kernel`` [d, 3, H, hd] with ``bias`` [3, H, hd];
* ``h_i.attn.proj.kernel`` [H, hd, d] with ``bias`` [d];
* ``h_i.mlp_fc`` ([d, ff], [ff]) and ``h_i.mlp_proj`` ([ff, d], [d]);
* the LM head is tied: ``logits = x @ wte.embedding.T``.

Random init follows the reference: normal(0.02) for kernels and
``wte``, normal(0.01) for ``wpe``, std 0.02 / sqrt(2 L) for the residual
projections (``attn.proj`` and ``mlp_proj``), zero biases, unit
LayerNorm scales, drawn from an explicit ``torch.Generator``. The math
(LayerNorm eps 1e-5, tanh-approximate gelu) is the serving engine's;
``forward`` is the cacheless full forward.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    max_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 0  # 0 -> 4 * d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model


def gpt2_124m(**overrides) -> TransformerConfig:
    return TransformerConfig(**overrides)


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


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator=None, device=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.ff_dim
        out_std = 0.02 / (2 * cfg.num_layers) ** 0.5
        self.ln_1 = LayerNorm(d, device)
        self.attn = Attention(cfg, generator, device)
        self.ln_2 = LayerNorm(d, device)
        self.mlp_fc = Dense((d, ff), (ff,), 0.02, generator, device)
        self.mlp_proj = Dense((ff, d), (d,), out_std, generator, device)


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
            self.add_module(f"h_{i}", Block(cfg, gen, device))
        self.ln_f = LayerNorm(cfg.d_model, device)

    def block(self, i: int) -> Block:
        return getattr(self, f"h_{i}")

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        from tensorflow_examples_torch.serving.engine import forward_full

        return forward_full(self, tokens)[0]
