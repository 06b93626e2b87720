#!/usr/bin/env python3
"""Two on-card probes of the PyTorch/CUDA port, beside ``chip_smoke.py``.

    python3 chip_probe.py steps [--root DIR] [--steps N]
    python3 chip_probe.py profiler [--train-config] [--windows N] [--lead-ms MS]

``steps`` times the eager training step of the port checked out in
``DIR`` (default: the checkout around this script) at chip_smoke.py's
two training configs: GPT-2 124M dense (bf16, dropout 0.1, batch
16 x 1024, fused CE) and its MoE config (8 experts, top-2 in every 2nd
block, batch 8 x 1024, dropout 0, router jitter on). Each runs ``N``
steps through ``Trainer.fit`` with ``log_every=1``; the line printed
holds each config's p50 of ``Trainer.history``'s ``step_time_s`` over
steps 1..N-1, the figure chip_smoke.py reports. Calls that alternate
two checkouts (parent, change, change, parent) compare two commits on
one card.

``profiler`` asks how often torch.profiler's count of
``paged_decode_kernel`` launches in a window of 8 decode steps differs
from the launches the engine's CUDA graph replays added to the kernel's
counter: chip_smoke.py's serving check for its ``paged_flash`` config,
repeated over ``N`` windows. With ``--train-config`` chip_smoke.py's
``train_config`` phase runs first, with its profiled k-step launches and
its profiler window. Every other window waits ``--lead-ms`` on the host
between the profiler's start and the first decode step; the line
printed counts, for each lead, the windows that differ and the launches
the profiler lost, beside the gap between the first paged kernel's
device timestamp and the first ``cudaGraphLaunch``'s host timestamp (a
kernel cannot start before its launch, so a negative gap is clock skew
between the two). Each window that differs prints a line of its own.

Needs one CUDA card; prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def steps(root: str, n: int) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, root)
    from tensorflow_examples_torch.data.memory import train_iterator
    from tensorflow_examples_torch.ops import _build
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import gpt2

    _build.build_all()
    common = dict(train_steps=n, warmup_steps=5, log_every=1, eval_every=0, checkpoint_every=0,
                  telemetry_sinks="")
    configs = {
        "dense": gpt2.Gpt2Config(**common),
        "moe": gpt2.Gpt2Config(global_batch_size=8, seq_len=1024, dropout=0.0, precision="bf16",
                               attention="flash", fused_ce=True, moe_experts=8, moe_top_k=2,
                               moe_every=2, moe_impl="grouped", **common),
    }
    out = {"root": root}
    for name, cfg in configs.items():
        ds, _ = gpt2.datasets(cfg)
        trainer = Trainer(gpt2.make_task(cfg), cfg)
        trainer.fit(lambda s: train_iterator(ds, cfg.global_batch_size, seed=cfg.seed,
                                             start_step=s), num_steps=n)
        times = [h["step_time_s"] * 1e3 for h in trainer.history[1:]]
        out[name] = {"step_ms_p50": float(np.median(times)), "step_ms_min": min(times),
                     "step_ms_max": max(times), "steps": len(times)}
        del trainer
        torch.cuda.empty_cache()
    return out


def profiler(windows: int, train_config: bool, lead_ms: float) -> dict:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, HERE)
    import chip_smoke
    from tensorflow_examples_torch.models import transformer
    from tensorflow_examples_torch.ops import _build, attention, cross_entropy, grouped_matmul
    from tensorflow_examples_torch.ops.paged_decode import paged_decode_attention
    from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
    from tensorflow_examples_torch.telemetry.registry import MetricsRegistry

    _build.build_all()
    if train_config:
        import tempfile

        counters = {"flash_fwd": attention.flash_fwd, "flash_bwd_dkv": attention.flash_bwd_dkv,
                    "flash_bwd_dq": attention.flash_bwd_dq, "ce_fwd": cross_entropy.ce_fwd,
                    "ce_bwd": cross_entropy.ce_bwd, "gmm": grouped_matmul.gmm,
                    "tgmm": grouped_matmul.tgmm, "group_row_sum": grouped_matmul.group_row_sum}
        with tempfile.TemporaryDirectory(prefix="chip_probe_") as tmp:
            chip_smoke.phase_train_config(torch, counters, "", tmp)
    model_cfg = transformer.gpt2_124m()
    model = transformer.GPT2(model_cfg, seed=0).to("cuda")
    engine = InferenceEngine(model_cfg, model, registry=MetricsRegistry(),
                             cfg=ServeConfig(max_slots=8, kv_block_size=16,
                                             attention="paged_flash"))
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, model_cfg.vocab_size, n)]
               for n in (5, 17, 40, 64, 100, 150, 230, 300)]
    entries = []

    def refill():
        """Fresh slots for the prompts: 16 windows of 8 steps stay within
        the 1024-token context."""
        for e in entries:
            engine.pool.free(e[0])
        entries[:] = [[slot, engine.prefill(slot, p)[0], 0, 0.0, 0]
                      for slot, p in zip([engine.pool.alloc() for _ in prompts], prompts)]

    def decode():
        got = engine.decode([tuple(e) for e in entries])
        for e in entries:
            e[1] = got[e[0]]

    runs = {0.0: [], lead_ms: []}
    for w in range(windows):
        if w % 16 == 0:
            refill()
            decode()  # the first call captures the rung's graph
        lead = lead_ms if w % 2 else 0.0
        torch.cuda.synchronize()
        counted = paged_decode_attention.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(lead / 1e3)
            for _ in range(8):
                decode()
            torch.cuda.synchronize()
        counted = paged_decode_attention.launches - counted
        seen = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "paged_decode_kernel" in e.key)
        events = prof.events()
        launches = sorted(e.time_range.start for e in events if "cudaGraphLaunch" in e.name)
        kernels = sorted(e.time_range.start for e in events
                         if e.device_type == DeviceType.CUDA and "paged_decode_kernel" in e.name)
        first_cpu = min((e.time_range.start for e in events
                         if e.device_type == DeviceType.CPU), default=None)
        row = {"window": w, "lead_ms": lead, "counted": counted, "profiled": seen,
               "graph_launches": len(launches),
               "first_launch_minus_first_host_event_us": (
                   launches[0] - first_cpu if launches and first_cpu is not None else None),
               # A kernel cannot start before its launch: a negative gap is
               # the skew between the device and host timestamps.
               "first_kernel_minus_first_launch_us": (kernels[0] - launches[0]
                                                      if kernels and launches else None)}
        runs[lead].append(row)
        if seen != counted:
            print(json.dumps({"differs": row}), flush=True)
    for e in entries:
        engine.pool.free(e[0])
    summary = {}
    for lead, rows in runs.items():
        gaps = [r["first_kernel_minus_first_launch_us"] for r in rows
                if r["first_kernel_minus_first_launch_us"] is not None]
        summary[f"lead_{lead:g}ms"] = {
            "windows": len(rows), "windows_differing": sum(r["profiled"] != r["counted"]
                                                           for r in rows),
            "launches_lost": sum(r["counted"] - r["profiled"] for r in rows),
            "first_kernel_minus_first_launch_us_min": min(gaps) if gaps else None,
            "first_kernel_minus_first_launch_us_median": float(np.median(gaps)) if gaps else None}
    return {"train_config_first": train_config, **summary}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="probe", required=True)
    s = sub.add_parser("steps")
    s.add_argument("--root", default=HERE)
    s.add_argument("--steps", type=int, default=30)
    p = sub.add_parser("profiler")
    p.add_argument("--train-config", action="store_true")
    p.add_argument("--windows", type=int, default=40)
    p.add_argument("--lead-ms", type=float, default=50.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_probe: needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    result = (steps(os.path.abspath(args.root), args.steps) if args.probe == "steps"
              else profiler(args.windows, args.train_config, args.lead_ms))
    result["wall_s"] = time.perf_counter() - t0
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
