"""The training config: the fields of the reference's ``TrainConfig``
(``tensorflow_examples_tpu/train/config.py``) that the port's step and
loop read, with the same names and defaults, except ``device``, which
names a PyTorch device (``cuda`` unless the caller asks for ``cpu``).

Meshes, prefetch, profiler windows and the watchdog are not ported yet;
their fields are absent rather than ignored.
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
    checkpoint_every: int = 1000  # with a workdir; 0 saves only at the end
    seed: int = 42

    # IO
    workdir: str = ""  # checkpoints and telemetry; "" disables both files
    data_dir: str = ""  # dataset location; "" -> synthetic data
    resume: bool = True  # restore the latest checkpoint from workdir

    # Resilience (train/resilience.py)
    preempt_checkpoint: bool = True  # SIGTERM/SIGINT: checkpoint at the
    #   next step boundary, then exit cleanly (code 0)
    bad_step_policy: str = "skip"  # off | skip | rollback | abort. A step
    #   whose loss or grad norm is not finite is dropped on the device
    #   (the step still advances) unless "off"; "skip" aborts after
    #   bad_step_patience consecutive bad steps, "rollback" restores the
    #   latest checkpoint there, "abort" raises at the first
    bad_step_patience: int = 5  # consecutive bad steps before escalation
    loss_spike_factor: float = 0.0  # >0: a loss above factor * EMA(loss)
    #   also counts as bad (seen on the host, a few steps late)

    # Telemetry (telemetry/)
    telemetry_sinks: str = "jsonl,tensorboard,console"  # jsonl writes
    #   <workdir>/telemetry/metrics.jsonl; tensorboard is a null writer
    #   in the port (a one-time warning says so); console logs the window
    telemetry_trace: bool = True  # Chrome-trace JSON of the host spans
    #   at <workdir>/telemetry/trace.json on exit
    telemetry_flush_every: int = 1  # flush sinks every N lines
    telemetry_peak_tflops: float = 0.0  # peak TFLOP/s for MFU; 0: from
    #   the device name (an unknown name gives a labelled 1 TFLOP/s)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
