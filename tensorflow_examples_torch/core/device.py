"""Device policy of the port: every entry point runs on CUDA unless the
caller asks for the CPU, and never falls back on its own."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for (explicitly
    or by default) and no GPU is visible; pass ``device="cpu"`` to run on
    the CPU, where every kernel wrapper takes its plain version."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; the port runs on the GPU unless the "
            "caller passes device='cpu'"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev} is neither cuda nor cpu")
    return dev
