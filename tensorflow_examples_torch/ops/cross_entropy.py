"""Softmax cross-entropy for LM heads: the port of
``tensorflow_examples_tpu/ops/cross_entropy.py`` without its fused
kernels.

The reference's fused forward and backward Pallas kernels
(``_ce_fwd_kernel``, ``_ce_bwd_kernel``) are not ported yet (ROADMAP B,
rows 4-5): ``fused=True`` raises on every device rather than quietly
running the plain path. ``fused=False`` is the reference's
``cross_entropy_reference``: the f32 logsumexp minus the label's logit,
differentiated by autograd.
"""

from __future__ import annotations

import torch

from tensorflow_examples_torch.ops.losses import select_label, weighted_mean

_NOT_PORTED = (
    "fused cross-entropy: its kernels (_ce_fwd_kernel/_ce_bwd_kernel) are not "
    "ported yet (ROADMAP B rows 4-5); pass fused=False"
)


def cross_entropy_reference(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example NLL [N] in f32 from logits [N, V] and int labels [N]."""
    logits = logits.float()
    return torch.logsumexp(logits, dim=-1) - select_label(logits, labels)


def cross_entropy_per_example(logits: torch.Tensor, labels: torch.Tensor, *,
                              fused: bool = False) -> torch.Tensor:
    """Per-example NLL [N] (f32). The reference defaults to its fused
    kernel; here ``fused=True`` raises until that kernel is ported."""
    if fused:
        raise NotImplementedError(_NOT_PORTED)
    return cross_entropy_reference(logits, labels)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: torch.Tensor | None = None, *,
                       fused: bool = False) -> torch.Tensor:
    """Weighted-mean token cross-entropy: logits [..., V], labels [...],
    optional weights [...] masking padding."""
    vocab = logits.shape[-1]
    nll = cross_entropy_per_example(logits.reshape(-1, vocab), labels.reshape(-1),
                                    fused=fused)
    return weighted_mean(nll, None if weights is None else weights.reshape(-1))
