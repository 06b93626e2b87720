"""Dense MLP classifier, the MNIST workload's model: the port of
``tensorflow_examples_tpu/models/mlp.py``.

Parameters ``dense_i`` and ``head`` (``kernel`` [in, out], ``bias``
[out]) are the reference's flax paths with ``.`` for ``/``; kernels take
flax's default init (LeCun truncated normal, :func:`lecun_normal`), biases
zeros. The forward flattens an NHWC batch in the reference's order
(``x.reshape(B, -1)``), then ``Dense -> relu [-> dropout]`` per hidden
layer and the head, in the parameters' dtype.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tensorflow_examples_torch.core import rng as rng_mod
from tensorflow_examples_torch.models.transformer import Dropout


def lecun_normal(shape, fan_in: int, generator, device) -> nn.Parameter:
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled so the variance is 1 / fan_in (``generator`` None:
    an empty tensor, for the meta device)."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, device=device))
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return nn.Parameter(t.to(device))


class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral``: ``kernel`` [in..., out...] with
    LeCun init over ``fan_in``, zero ``bias`` [out...]."""

    def __init__(self, kernel_shape, bias_shape, fan_in: int, generator=None, device=None):
        super().__init__()
        self.kernel = lecun_normal(kernel_shape, fan_in, generator, device)
        self.bias = nn.Parameter(torch.zeros(bias_shape, device=device))


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_features: int = 28 * 28
    features: tuple = (128, 128)
    num_classes: int = 10
    dropout_rate: float = 0.0


class MLP(nn.Module):
    def __init__(self, cfg: MLPConfig, *, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        gen = None
        if torch.device(device or "cpu").type != "meta":
            gen = torch.Generator(device="cpu").manual_seed(seed)
        fan_in = cfg.in_features
        for i, f in enumerate(cfg.features):
            self.add_module(f"dense_{i}", Dense((fan_in, f), (f,), fan_in, gen, device))
            fan_in = f
        self.head = Dense((fan_in, cfg.num_classes), (cfg.num_classes,), fan_in, gen, device)

    def forward(self, x, *, train: bool = False, noise: rng_mod.StepNoise | None = None):
        return forward(self.cfg, self, x, train=train, noise=noise)


def forward(cfg: MLPConfig, params, x: torch.Tensor, *, train: bool = False,
            noise: rng_mod.StepNoise | None = None) -> torch.Tensor:
    """Logits [B, num_classes] of ``x`` [B, ...] (flattened row-major);
    ``params`` is an :class:`MLP` or a ``transformer.ParamView``. Dropout
    site ``i`` follows hidden layer ``i`` when the rate is set and
    ``train``."""
    drop = Dropout(cfg.dropout_rate, noise if train else None)
    x = x.reshape(x.shape[0], -1)
    for i in range(len(cfg.features)):
        layer = getattr(params, f"dense_{i}")
        x = drop(torch.relu(x @ layer.kernel + layer.bias), i)
    return x @ params.head.kernel + params.head.bias
