"""Derived accounting: model-FLOPs MFU and goodput. The port of
``tensorflow_examples_tpu/telemetry/accounting.py``.

* MFU: achieved model FLOPs/s over the card's peak, with model FLOPs by
  the ``6 * N * D`` estimate (N parameters, D processed tokens), so a
  fused kernel or remat does not change the numerator.
* goodput: productive steps over all stepped work (skipped bad steps
  and rollback replays are the loss).

The peak comes from a table keyed by ``torch.cuda.get_device_name()``;
an unknown name (the CPU) falls back to a labelled 1 TFLOP/s so the
pipeline stays exercised, and ``peak_is_estimate`` says so.
"""

from __future__ import annotations

from typing import Mapping

# Dense bf16 tensor-core peak FLOP/s by device-name substring (first match
# wins); the H100 SXM's from NVIDIA's data sheet.
PEAK_FLOPS_BY_DEVICE_NAME: tuple[tuple[str, float], ...] = (
    ("h100", 989.4e12),
)
DEFAULT_PEAK_FLOPS = 1e12


def peak_flops_per_device(device_name: str = "") -> tuple[float, bool]:
    """(peak bf16 FLOP/s of one device, whether the name is known)."""
    name = (device_name or "").lower()
    for sub, peak in PEAK_FLOPS_BY_DEVICE_NAME:
        if sub in name:
            return peak, True
    return DEFAULT_PEAK_FLOPS, False


def train_step_flops(n_params: int, examples_per_step: int, tokens_per_example: int = 1) -> float:
    """Model FLOPs of one optimizer step: 6 * N * examples * tokens."""
    return 6.0 * float(n_params) * float(examples_per_step) * float(max(tokens_per_example, 1))


def mfu(flops_per_step: float, steps_per_sec: float | None, peak_flops_total: float) -> float | None:
    """Achieved model FLOP/s over the peak; None when either is unknown."""
    if not steps_per_sec or peak_flops_total <= 0 or flops_per_step <= 0:
        return None
    return flops_per_step * steps_per_sec / peak_flops_total


def goodput(counters: Mapping[str, int]) -> float | None:
    """(total - bad - lost) / total over ``train/steps_total``,
    ``resilience/bad_steps`` and ``resilience/steps_lost``."""
    total = counters.get("train/steps_total", 0)
    if total <= 0:
        return None
    lost = counters.get("resilience/bad_steps", 0) + counters.get("resilience/steps_lost", 0)
    return max(total - lost, 0) / total
