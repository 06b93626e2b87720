"""The ResNet family, every depth: the port of
``tensorflow_examples_tpu/models/resnet.py`` (ResNet-20 for CIFAR,
ResNet-18/34/50/101/152 for ImageNet).

Parameter and statistic names are the reference's flax paths with ``.``
for ``/``: ``stem_conv``, ``stem_bn``, ``stage{s}_block{b}`` holding
``Conv_i`` and ``BatchNorm_i`` (and ``proj``/``proj_bn`` where the
residual changes shape), ``head``. Layouts are flax's too: a conv
``kernel`` is HWIO [kh, kw, in, out] (the forward hands
``conv2d`` its OIHW view), a BatchNorm has ``scale`` and ``bias`` in the
params and ``mean`` and ``var`` in ``batch_stats`` (the module's
buffers), so ``models/convert.py`` moves a flax tree over as it is.
Init is flax's: conv kernels normal with variance 2 / fan_out, the head
normal with variance 1 / fan_in, each block's last BatchNorm scale zero.

The math is the reference's, where torch's own layers differ:

* ``padding="SAME"`` is XLA's rule, ``pad = max((ceil(n/s) - 1) s + k -
  n, 0)`` split low ``pad // 2``, high the rest: a 3x3/2 conv on 32 pads
  (0, 1) where torch's ``padding=1`` pads (1, 1). The ImageNet stem's
  7x7/2 conv and its 3x3/2 max pool (padded with -inf) follow it too.
* BatchNorm is flax's, not ``F.batch_norm``'s: in training the batch
  mean and the *biased* variance ``max(E[x²] - E[x]², 0)`` in f32 whatever
  the compute dtype, ``y = (x - mean) * (rsqrt(var + 1e-5) * scale) +
  bias`` in f32, cast back to the compute dtype; the running statistics
  move as ``ra = 0.9 ra + 0.1 batch`` in f32. In eval the running
  statistics normalize.
* The global average pool stays in the compute dtype; the head runs in
  f32 on the f32-cast pooled features.

Meshes (``apply(..., mesh=)``, per-rank code): in training the
BatchNorm moments are the global batch's, as the reference's sync-BN is
(one logical array under ``jit``; XLA all-reduces the moments). Each
rank sums ``Σx``, ``Σx²`` and its row count in f32 over its rows, the
mesh's batch axes (``data`` and ``fsdp`` where their size is above 1;
the trainer refuses a ``batch_axes`` that splits the batch otherwise)
sum them in one all-reduce a layer, and mean and variance follow from
the sums as on one rank; every rank then holds the same running
statistics. That all-reduce is summed in the
backward too (``collectives.copy_to`` over ``psum``): each rank's loss
covers its own rows only, so the moments' cotangent differs from rank
to rank, and the trainer's gradient mean over the batch axes is then
the global batch's gradient. In eval, or where the batch axes are of
size 1, nothing crosses ranks.

Convolutions, pooling and the elementwise ops are ``torch.nn.functional``
calls (cuDNN on the card): the reference computes them in XLA, outside
any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_examples_torch.core import collectives as coll
from tensorflow_examples_torch.core.mesh import AxisNames

BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple
    block: str  # basic | bottleneck
    num_classes: int
    num_filters: int = 64
    stem: str = "imagenet"  # cifar: one 3x3 conv | imagenet: 7x7/2 conv + 3x3/2 max pool
    bn_momentum: float = 0.9

    @property
    def expansion(self) -> int:
        return 4 if self.block == "bottleneck" else 1


def resnet20(num_classes: int = 10) -> ResNetConfig:
    """CIFAR ResNet-20: 3 stages of 3 basic blocks, 16/32/64 filters."""
    return ResNetConfig((3, 3, 3), "basic", num_classes, num_filters=16, stem="cifar")


def resnet18(num_classes: int = 1000) -> ResNetConfig:
    return ResNetConfig((2, 2, 2, 2), "basic", num_classes)


def resnet34(num_classes: int = 1000) -> ResNetConfig:
    return ResNetConfig((3, 4, 6, 3), "basic", num_classes)


def resnet50(num_classes: int = 1000) -> ResNetConfig:
    """ImageNet ResNet-50: 3/4/6/3 bottleneck blocks, a 64-filter stem."""
    return ResNetConfig((3, 4, 6, 3), "bottleneck", num_classes)


def resnet101(num_classes: int = 1000) -> ResNetConfig:
    return ResNetConfig((3, 4, 23, 3), "bottleneck", num_classes)


def resnet152(num_classes: int = 1000) -> ResNetConfig:
    return ResNetConfig((3, 8, 36, 3), "bottleneck", num_classes)


# ------------------------------------------------------------ modules


class Conv(nn.Module):
    """flax ``Conv`` without bias: ``kernel`` HWIO, normal init with
    variance 2 / fan_out (``variance_scaling(2.0, "fan_out", "normal")``)."""

    def __init__(self, cin: int, cout: int, size: int, generator=None, device=None):
        super().__init__()
        shape = (size, size, cin, cout)
        if generator is None:
            self.kernel = nn.Parameter(torch.empty(shape, device=device))
        else:
            std = math.sqrt(2.0 / (size * size * cout))
            t = torch.empty(shape).normal_(0.0, std, generator=generator)
            self.kernel = nn.Parameter(t.to(device))


class BatchNorm(nn.Module):
    """flax ``BatchNorm``'s variables: ``scale`` (ones, or zeros for a
    block's last) and ``bias`` parameters, ``mean`` and ``var`` buffers
    (the ``batch_stats``)."""

    def __init__(self, c: int, zero_scale: bool = False, device=None):
        super().__init__()
        self.scale = nn.Parameter((torch.zeros if zero_scale else torch.ones)(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-20/18/34)."""

    def __init__(self, cin: int, filters: int, strides: int, generator=None, device=None):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 3, generator, device)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, generator, device)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True, device=device)
        if strides != 1 or cin != filters:
            self.proj = Conv(cin, filters, 1, generator, device)
            self.proj_bn = BatchNorm(filters, device=device)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) bottleneck block (ResNet-50/101/152)."""

    def __init__(self, cin: int, filters: int, strides: int, generator=None, device=None):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 1, generator, device)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, generator, device)
        self.BatchNorm_1 = BatchNorm(filters, device=device)
        self.Conv_2 = Conv(filters, filters * 4, 1, generator, device)
        self.BatchNorm_2 = BatchNorm(filters * 4, zero_scale=True, device=device)
        if strides != 1 or cin != filters * 4:
            self.proj = Conv(cin, filters * 4, 1, generator, device)
            self.proj_bn = BatchNorm(filters * 4, device=device)


class ResNet(nn.Module):
    """A staged ResNet's variables. ``seed`` draws the init from a CPU
    ``torch.Generator`` (``device="meta"`` builds shapes only);
    :func:`variables` gives the ``params`` / ``batch_stats`` split the
    trainer keeps."""

    def __init__(self, cfg: ResNetConfig, *, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        gen = None
        if torch.device(device or "cpu").type != "meta":
            gen = torch.Generator(device="cpu").manual_seed(seed)
        stem = 3 if cfg.stem == "cifar" else 7
        self.stem_conv = Conv(3, cfg.num_filters, stem, gen, device)  # RGB
        self.stem_bn = BatchNorm(cfg.num_filters, device=device)
        block = BottleneckBlock if cfg.block == "bottleneck" else BasicBlock
        cin = cfg.num_filters
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            filters = cfg.num_filters * 2 ** stage
            for b in range(n_blocks):
                strides = 2 if stage > 0 and b == 0 else 1
                self.add_module(f"stage{stage}_block{b}", block(cin, filters, strides, gen, device))
                cin = filters * cfg.expansion
        self.head = nn.Module()
        if gen is None:
            self.head.kernel = nn.Parameter(torch.empty(cin, cfg.num_classes, device=device))
        else:
            std = math.sqrt(1.0 / cin)
            t = torch.empty(cin, cfg.num_classes).normal_(0.0, std, generator=gen)
            self.head.kernel = nn.Parameter(t.to(device))
        self.head.bias = nn.Parameter(torch.zeros(cfg.num_classes, device=device))

    def forward(self, x, *, train: bool = False):
        v = variables(self)
        return apply(self.cfg, v["params"], v["batch_stats"], x, train=train)[0]


def variables(model: ResNet) -> dict:
    """``{"params": {name: tensor}, "batch_stats": {name: tensor}}`` of a
    module, detached (names with ``.`` for flax's ``/``)."""
    return {"params": {k: p.detach() for k, p in model.named_parameters()},
            "batch_stats": {k: b.detach() for k, b in model.named_buffers()}}


# ------------------------------------------------------------ forward


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial axis: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """``x`` [B, C, H, W] padded by XLA's rule, and the padding left for
    the op itself (symmetric padding is the op's, asymmetric is done
    here)."""
    ph, pw = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def conv(x, kernel, stride: int = 1):
    """flax ``Conv(padding="SAME")`` of NCHW ``x`` with an HWIO kernel."""
    x, pad = _pad_same(x, kernel.shape[0], stride)
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), stride=stride, padding=pad)


def batch_norm(x, params: Mapping, stats: Mapping, name: str, *, train: bool,
               momentum: float, new_stats: dict, mesh=None, axes: tuple = ()):
    """flax ``BatchNorm`` over NCHW ``x`` (see the module docstring);
    in training, the updated running statistics go to ``new_stats``.
    ``axes``: the mesh axes whose ranks hold the rest of the batch."""
    xf = x.float()
    if train:
        c, dims = xf.shape[1], (0, 2, 3)
        rows = xf.new_full((1,), xf.numel() // c)
        sums = torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims), rows])
        if axes:
            sums = coll.copy_to(coll.psum(sums, axes, mesh=mesh), axes, mesh=mesh)
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
        with torch.no_grad():
            new_stats[f"{name}.mean"] = momentum * stats[f"{name}.mean"] + (1 - momentum) * mean
            new_stats[f"{name}.var"] = momentum * stats[f"{name}.var"] + (1 - momentum) * var
    else:
        mean, var = stats[f"{name}.mean"], stats[f"{name}.var"]
    mul = torch.rsqrt(var + BN_EPS) * params[f"{name}.scale"].float()
    y = (xf - mean[:, None, None]) * mul[:, None, None] + params[f"{name}.bias"].float()[:, None,
                                                                                          None]
    return y.to(x.dtype)


def _block(cfg: ResNetConfig, x, prefix: str, strides: int, params, bn):
    # The conv strides in order: the stride sits on the block's 3x3 conv.
    conv_strides = (1, strides, 1) if cfg.block == "bottleneck" else (strides, 1)
    y = x
    for i, stride in enumerate(conv_strides):
        y = bn(conv(y, params[f"{prefix}.Conv_{i}.kernel"], stride), f"BatchNorm_{i}")
        if i < len(conv_strides) - 1:
            y = torch.relu(y)
    residual = x
    if f"{prefix}.proj.kernel" in params:
        residual = bn(conv(x, params[f"{prefix}.proj.kernel"], strides), "proj_bn")
    return torch.relu(residual + y)


def apply(cfg: ResNetConfig, params: Mapping[str, torch.Tensor],
          batch_stats: Mapping[str, torch.Tensor], x: torch.Tensor, *, train: bool = False,
          mesh=None):
    """(f32 logits [B, num_classes], batch_stats after the step) of NHWC
    images ``x`` in the compute dtype. ``params`` and ``batch_stats`` are
    flat ``{name: tensor}`` dicts; in eval (``train=False``) the running
    statistics normalize and come back unchanged. ``mesh``: ``x`` is this
    rank's rows of a batch split over the mesh's batch axes (see the
    module docstring)."""
    new_stats: dict = {}
    axes = mesh.axes(AxisNames.BATCH_AXES) if mesh is not None else ()
    bn = lambda y, name: batch_norm(y, params, batch_stats, name, train=train,
                                    momentum=cfg.bn_momentum, new_stats=new_stats, mesh=mesh,
                                    axes=axes)
    x = x.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
    if cfg.stem == "cifar":
        x = torch.relu(bn(conv(x, params["stem_conv.kernel"]), "stem_bn"))
    else:
        x = torch.relu(bn(conv(x, params["stem_conv.kernel"], 2), "stem_bn"))
        x, pad = _pad_same(x, 3, 2, value=-math.inf)
        x = F.max_pool2d(x, 3, stride=2, padding=pad)
    for stage, n_blocks in enumerate(cfg.stage_sizes):
        for b in range(n_blocks):
            strides = 2 if stage > 0 and b == 0 else 1
            prefix = f"stage{stage}_block{b}"
            x = _block(cfg, x, prefix, strides, params,
                       lambda y, name, p=prefix: bn(y, f"{p}.{name}"))
    pooled = x.mean(dim=(2, 3))  # global average pool
    logits = pooled.float() @ params["head.kernel"].float() + params["head.bias"].float()
    # In the input's key order: a CUDA graph copies state back leaf by leaf.
    return logits, ({k: new_stats[k] for k in batch_stats} if train else dict(batch_stats))
