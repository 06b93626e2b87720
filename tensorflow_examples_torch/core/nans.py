"""``debug_nans``: finite checks that name where a NaN or an Inf first
appeared, the counterpart of the reference's ``jax_debug_nans``.

Inside :func:`finite_checks` (the trainer enters it when
``TrainConfig.debug_nans`` is set), :func:`check_finite` raises
``FloatingPointError`` naming its site when a tensor holds a NaN or an
Inf; outside it does nothing. Each check syncs with the device: a
debugging mode, never on inside a CUDA graph. The model checks its
embeddings, every block's output and its logits; the trainer checks the
loss and runs the backward under ``torch.autograd.detect_anomaly``.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


@contextlib.contextmanager
def finite_checks():
    before = getattr(_state, "on", False)
    _state.on = True
    try:
        yield
    finally:
        _state.on = before


def check_finite(x: torch.Tensor, where: str) -> None:
    if getattr(_state, "on", False) and not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"debug_nans: a NaN or Inf in the output of {where}")
