"""The training config: the fields of the reference's ``TrainConfig``
(``tensorflow_examples_tpu/train/config.py``) that the port's step and
loop read, with the same names and defaults, except ``device``, which
names a PyTorch device (``cuda`` unless the caller asks for ``cpu``).

The mesh fields shape the ``torch.distributed`` mesh (``core/mesh.py``)
over the ranks of the process group, one rank a device; ``mesh_pipe``
splits a workload's layers into pipeline stages (GPT-2's microbatch and
schedule fields are in ``workloads/gpt2.py``).
"""

from __future__ import annotations

import dataclasses

from tensorflow_examples_torch.core.mesh import MeshConfig


@dataclasses.dataclass
class TrainConfig:
    device: str = "cuda"  # cuda | cpu
    mesh_data: int = -1  # -1: all remaining ranks on the data axis
    mesh_fsdp: int = 1
    mesh_model: int = 1
    mesh_context: int = 1
    mesh_pipe: int = 1

    # Optimization
    global_batch_size: int = 128
    eval_batch_size: int = 0  # 0 -> global_batch_size
    train_steps: int = 1000
    warmup_steps: int = 0
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0  # 0 disables
    grad_accum_steps: int = 1
    steps_per_launch: int = 1  # K train steps per launch: on the card one CUDA
    #   graph of K steps (train/graphs.py), on the CPU a loop of K. Cadences
    #   (log/eval/checkpoint), the resume step and the step span must be
    #   multiples of K
    precision: str = "bf16"  # f32 | bf16 | bf16_full
    remat: bool = False  # recompute each block in the backward
    zero1: bool = False  # shard optimizer state over the batch axes even
    #   for replicated params (ZeRO-1 / weight-update sharding)
    sharding_config: str = ""  # path to a ShardingConfig JSON (sharding/):
    #   when set, it is the single source of truth for mesh shape, rules,
    #   batch axes and ZeRO-1 (the mesh_*/zero1 knobs are ignored).
    #   Training persists the active config to workdir/sharding.json

    # Loop cadence
    log_every: int = 100
    eval_every: int = 0  # 0 disables periodic eval
    checkpoint_every: int = 1000  # with a workdir; 0 saves only at the end
    seed: int = 42

    # IO
    workdir: str = ""  # checkpoints and telemetry; "" disables both files
    data_dir: str = ""  # dataset location; "" -> synthetic data
    resume: bool = True  # restore the latest checkpoint from workdir

    # Profiling and sanitizers
    profile: bool = False  # legacy: a profiler window over run-relative steps 10-20
    profile_start_step: int = 0  # first run-relative step of the torch.profiler
    #   window (telemetry/profiling.py; one-shot per fit)
    profile_num_steps: int = 0  # steps the window covers; 0 disables (unless profile)
    profile_dir: str = ""  # trace directory; "" -> <workdir>/profile. The final
    #   telemetry line links the window under "profile"
    debug_nans: bool = False  # fail fast at the module or op that made a NaN or
    #   Inf: finite checks on every block and the loss, autograd anomaly mode
    watchdog_secs: float = 600.0  # dump every thread's stack when no step
    #   completes for this long (0 disables; utils/diagnostics.py)

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
    watchdog_fatal_secs: float = 0.0  # >0: a step or input stall this long
    #   dumps diagnostics and exits with code 87 instead of hanging
    io_retries: int = 3  # bounded retries of flaky file reads (data/sources.py)
    io_backoff_secs: float = 0.25  # the first retry's backoff; doubles a retry
    max_skipped_batches: int = 0  # corrupt host batches the prefetch pipeline
    #   skips (and counts) before the run errors out; 0 fails fast

    # Input pipeline (data/prefetch.py)
    prefetch_depth: int = 2  # batches in flight to the device ahead of the step
    #   (the floor when the adaptive controller is armed)
    prefetch_depth_max: int = 0  # > prefetch_depth arms the depth controller,
    #   which deepens the queue while data_fetch p95 dominates device_step p95
    input_workers: int = 0  # decode and augment worker threads of the ImageNet
    #   TFRecord pipeline (data/workers.py); 0 decodes inline, the sequential
    #   stream the parallel one equals bit for bit
    input_readers: int = 2  # shard-reader threads of that pipeline; 1 reads
    #   the shards inline

    # Telemetry (telemetry/)
    telemetry_sinks: str = "jsonl,tensorboard,console"  # jsonl writes
    #   <workdir>/telemetry/metrics.jsonl; tensorboard is a null writer
    #   in the port (a one-time warning says so); console logs the window
    telemetry_trace: bool = True  # Chrome-trace JSON of the host spans
    #   at <workdir>/telemetry/trace.json on exit
    telemetry_flush_every: int = 1  # flush sinks every N lines
    telemetry_peak_tflops: float = 0.0  # peak TFLOP/s for MFU; 0: from
    #   the device name (an unknown name gives a labelled 1 TFLOP/s)
    metrics_port: int = 0  # > 0: serve /metrics, /health, /window and /fleet on
    #   this port while fit runs (telemetry/serve.MetricsServer); 0 disables
    straggler_skew_factor: float = 2.0  # fleet straggler threshold
    #   (telemetry/fleet.py): a rank whose step-time p95 exceeds this
    #   multiple of the others' median is named on the kind="fleet" line
    #   and in a WARNING (0 disables the warning, not the lines)
    compile_warmup: int = 1  # expected signatures per training step function
    #   (telemetry/compilation.py): a new one past this many is a recompile,
    #   logged and written as a kind="compile_warning" line

    def mesh_config(self) -> MeshConfig:
        return MeshConfig(data=self.mesh_data, fsdp=self.mesh_fsdp, model=self.mesh_model,
                          context=self.mesh_context, pipe=self.mesh_pipe)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
