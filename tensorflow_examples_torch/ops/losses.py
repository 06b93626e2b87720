"""Loss helpers: the port of ``tensorflow_examples_tpu/ops/losses.py``
(the two the GPT-2 step uses)."""

from __future__ import annotations

import torch


def select_label(values: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``values[..., C]`` at ``labels[...]``, and 0 where a label lies
    outside ``[0, C)``, as the reference's mask-and-reduce gives (it
    matches no column there). Eagerly a gather of the clamped index,
    zeroed where out of range, is exact and reads one value per row; its
    gradient reaches no column for such a row, as the reference's does."""
    labels = labels.long()
    inside = (labels >= 0) & (labels < values.shape[-1])
    picked = torch.gather(values, -1, labels.clamp(0, values.shape[-1] - 1)[..., None])[..., 0]
    return torch.where(inside, picked, torch.zeros((), dtype=values.dtype, device=values.device))


def weighted_mean(values: torch.Tensor, weights: torch.Tensor | None) -> torch.Tensor:
    """Weighted mean in f32 with a padded-batch-safe denominator (at
    least 1)."""
    values = values.float()
    if weights is None:
        return values.mean()
    weights = weights.float()
    return (values * weights).sum() / weights.sum().clamp_min(1.0)
