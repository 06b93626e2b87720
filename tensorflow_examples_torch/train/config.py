"""The training config: the fields of the reference's ``TrainConfig``
(``tensorflow_examples_tpu/train/config.py``) that the port's step and
loop read, with the same names and defaults, except ``device``, which
names a PyTorch device (``cuda`` unless the caller asks for ``cpu``).

Meshes, checkpoints, prefetch, telemetry sinks and the watchdog are not
ported yet; their fields are absent rather than ignored.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainConfig:
    device: str = "cuda"  # cuda | cpu

    # Optimization
    global_batch_size: int = 128
    eval_batch_size: int = 0  # 0 -> global_batch_size
    train_steps: int = 1000
    warmup_steps: int = 0
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0  # 0 disables
    grad_accum_steps: int = 1
    precision: str = "bf16"  # f32 | bf16 | bf16_full
    remat: bool = False  # recompute each block in the backward

    # Loop cadence
    log_every: int = 100
    eval_every: int = 0  # 0 disables periodic eval
    seed: int = 42

    # IO
    data_dir: str = ""  # dataset location; "" -> synthetic data

    # Resilience: "skip" drops a step whose loss or grad norm is not
    # finite on the device (params and optimizer state keep their old
    # values, the step still advances); "off" applies every update.
    bad_step_policy: str = "skip"

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
