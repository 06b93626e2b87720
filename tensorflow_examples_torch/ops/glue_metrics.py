"""GLUE metrics as mean-composable pieces: the port of
``tensorflow_examples_tpu/ops/glue_metrics.py``.

The trainer's eval takes weighted means over batches. F1, MCC and
Pearson are not batch means, but they are functions of global means: the
confusion cells' indicator rates (tp, fp, fn, tn) and the raw moments
(x, y, x², y², xy). A task's ``eval_fn`` emits those per batch and its
``eval_finalize`` turns the aggregated means into the score.
"""

from __future__ import annotations

import torch

from tensorflow_examples_torch.ops.losses import weighted_mean


def confusion_rates(preds: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor | None) -> dict[str, torch.Tensor]:
    """Weighted means of the binary confusion indicators."""
    preds, labels = preds.long(), labels.long()
    cells = {"tp": (preds == 1) & (labels == 1), "fp": (preds == 1) & (labels == 0),
             "fn": (preds == 0) & (labels == 1), "tn": (preds == 0) & (labels == 0)}
    return {name: weighted_mean(cond.float(), weights) for name, cond in cells.items()}


def f1_from_rates(m: dict) -> float:
    tp, fp, fn = m["tp"], m["fp"], m["fn"]
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


def mcc_from_rates(m: dict) -> float:
    tp, fp, fn, tn = m["tp"], m["fp"], m["fn"], m["tn"]
    denom = ((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)) ** 0.5
    return (tp * tn - fp * fn) / denom if denom > 0 else 0.0


def moment_means(x: torch.Tensor, y: torch.Tensor,
                 weights: torch.Tensor | None) -> dict[str, torch.Tensor]:
    """Raw-moment means for the Pearson correlation, in f32."""
    x, y = x.float(), y.float()
    return {"x": weighted_mean(x, weights), "y": weighted_mean(y, weights),
            "xx": weighted_mean(x * x, weights), "yy": weighted_mean(y * y, weights),
            "xy": weighted_mean(x * y, weights)}


def pearson_from_moments(m: dict) -> float:
    cov = m["xy"] - m["x"] * m["y"]
    vx = max(m["xx"] - m["x"] ** 2, 0.0)
    vy = max(m["yy"] - m["y"] ** 2, 0.0)
    denom = (vx * vy) ** 0.5
    return cov / denom if denom > 0 else 0.0
