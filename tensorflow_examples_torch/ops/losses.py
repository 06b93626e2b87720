"""Loss helpers: the port of ``tensorflow_examples_tpu/ops/losses.py``
(the two the GPT-2 step uses)."""

from __future__ import annotations

import torch


def select_label(values: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``values[..., C]`` at ``labels[...]``. The reference avoids a
    gather for XLA's SPMD partitioner (its mask-and-reduce picks the same
    element); eagerly a gather is exact and reads one value per row."""
    return torch.gather(values, -1, labels.long()[..., None])[..., 0]


def weighted_mean(values: torch.Tensor, weights: torch.Tensor | None) -> torch.Tensor:
    """Weighted mean in f32 with a padded-batch-safe denominator (at
    least 1)."""
    values = values.float()
    if weights is None:
        return values.mean()
    weights = weights.float()
    return (values * weights).sum() / weights.sum().clamp_min(1.0)
