"""Losses and classification metrics: the port of
``tensorflow_examples_tpu/ops/losses.py``. Every loss and mean is taken
in f32 whatever the logits' dtype, as the reference's."""

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


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy over (optionally weighted) examples: logits
    [..., C] of any float dtype, integer labels [...]; the log-softmax in
    f32."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    return weighted_mean(-select_label(log_probs, labels), weights)


def accuracy_metrics(logits: torch.Tensor, labels: torch.Tensor,
                     weights: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """``accuracy``, weighted; with weights also their sum as ``weight``,
    which the trainer's eval mean reads."""
    correct = (torch.argmax(logits, dim=-1) == labels.long()).float()
    out = {"accuracy": weighted_mean(correct, weights)}
    if weights is not None:
        out["weight"] = weights.float().sum()
    return out
