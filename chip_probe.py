#!/usr/bin/env python3
"""Four on-card probes of the PyTorch/CUDA port, beside ``chip_smoke.py``.

    python3 chip_probe.py steps [--root DIR] [--steps N]
    python3 chip_probe.py profiler [--train-config] [--windows N] [--lead-ms MS]
    python3 chip_probe.py determinism [--runs N] [--steps N]
    python3 chip_probe.py psum [--iters N]

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
the profiler lost, beside the gap between the first paged kernel's device
timestamp and the first ``cudaGraphLaunch``'s host timestamp (a kernel
cannot start before its launch, so a negative gap is clock skew between
the two) and the smallest gap between the host's last synchronize
returning and the last paged kernel's device end (a kernel cannot end
after the synchronize that waits for it returns: a negative gap is the
skew the other way, at the window's end). Each window that differs
prints a line of its own, with the paged kernels of each decode step
(the kernels split at the 7 largest gaps between them), so a step that
lost one shows where in the window it was.

``determinism`` asks whether BERT-base GLUE training, the run
chip_smoke.py's ``bert resume`` check compares, is bitwise repeatable:
``--runs`` times ``--steps`` steps through ``Trainer.fit`` (bf16, dropout
0.1, flash attention, batch 32 x 128, the seeded init and stream), each
compared with the first; then one step under
``torch.use_deterministic_algorithms(True, warn_only=True)``, whose
warnings name every op of the step that PyTorch knows to be
nondeterministic on CUDA; then, from the state after ``--steps`` - 5
steps, the next step's gradients ``--reruns`` times, each held to the
first tensor by tensor: the parameters whose gradients differ name the
op that is not repeatable.

``psum`` asks what one ``model`` psum of a sharded engine's decode step
costs when two ranks share the card over gloo (``core/collectives``
stages a CUDA operand through pinned host memory): on a world of 2
ranks, the mean host ms of ``N`` calls of each of: the staging copies
alone ([8, 768] f32 to the host and back, the decode step's psum
operand) on rank 0 while rank 1 waits, and on both ranks at once; the
psum of a host tensor (gloo alone); the psum of the CUDA tensor; a
decode-sized product ([8, 768] x [768, 3072] and back) on both ranks;
and that product followed by the psum of its output, each call ending
in a synchronize.

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


def _step_sizes(starts) -> list[int]:
    """Kernels a decode step, splitting the sorted device starts at the 7
    largest gaps (8 steps a window)."""
    if len(starts) < 2:
        return [len(starts)]
    gaps = sorted(range(1, len(starts)), key=lambda i: starts[i] - starts[i - 1])[-7:]
    cuts = [0, *sorted(gaps), len(starts)]
    return [b - a for a, b in zip(cuts, cuts[1:])]


def determinism(runs: int, n_steps: int, reruns: int) -> dict:
    import warnings

    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from tensorflow_examples_torch.data.memory import train_iterator
    from tensorflow_examples_torch.ops import _build
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import bert_glue

    _build.build_all()
    base = bert_glue.BertGlueConfig(attention="flash", train_steps=n_steps, warmup_steps=2,
                                    log_every=1, eval_every=0, checkpoint_every=0,
                                    telemetry_sinks="")
    train_ds, _ = bert_glue.datasets(base)
    histories = []
    for _ in range(runs):
        trainer = Trainer(bert_glue.make_task(base), base)
        trainer.fit(train_iterator(train_ds, base.global_batch_size, seed=base.seed),
                    num_steps=n_steps)
        histories.append([h["loss"] for h in trainer.history])
        del trainer
        torch.cuda.empty_cache()
    first = histories[0]
    differ = []
    for i, h in enumerate(histories[1:], start=1):
        steps_off = [s for s, (a, b) in enumerate(zip(first, h), start=1) if a != b]
        if steps_off:
            differ.append({"run": i, "first_step_off": steps_off[0],
                           "worst_rel": max(abs(a - b) / abs(b) for a, b in zip(first, h))})
    trainer = Trainer(bert_glue.make_task(base), base)
    batch = trainer.put_batch(next(train_iterator(train_ds, base.global_batch_size,
                                                  seed=base.seed)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer.state, _ = trainer._train_step(trainer.state, batch)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split(" does not have a deterministic")[0]
                      for w in caught if "deterministic" in str(w.message)})
    del trainer
    torch.cuda.empty_cache()
    # One step's gradients from one state, again and again.
    from tensorflow_examples_torch.core import rng

    at = n_steps - 5
    trainer = Trainer(bert_glue.make_task(base), base)
    trainer.fit(train_iterator(train_ds, base.global_batch_size, seed=base.seed), num_steps=at)
    batch = trainer.policy.cast_compute(trainer.put_batch(next(train_iterator(
        train_ds, base.global_batch_size, seed=base.seed, start_step=at))))
    first, rerun_diffs = None, []
    for i in range(reruns):
        leaves = {k: p.detach().requires_grad_() for k, p in trainer.state.params.items()}
        loss, _, _ = trainer.task.loss_fn(
            trainer.policy.cast_compute(leaves), trainer.state.model_state, batch,
            rng=rng.StepNoise(trainer.step_key(at)), train=True)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        if first is None:
            first = (float(loss), grads)
            continue
        off = {k: float((g.float() - first[1][k].float()).abs().max())
               for k, g in grads.items() if not torch.equal(g, first[1][k])}
        if off or float(loss) != first[0]:
            rerun_diffs.append({"rerun": i, "loss_equal": float(loss) == first[0],
                                "params_differing": len(off),
                                "worst": sorted(off.items(), key=lambda kv: -kv[1])[:8]})
    return {"runs": runs, "steps": n_steps, "losses_run_0": histories[0],
            "runs_differing": differ, "nondeterministic_ops": flagged,
            "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG", ""),
            "reruns_of_step": at + 1, "reruns": reruns, "reruns_differing": rerun_diffs}


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
        kernel_ends = [e.time_range.end for e in events
                       if e.device_type == DeviceType.CUDA and "paged_decode_kernel" in e.name]
        syncs = [e.time_range.end for e in events if "cudaDeviceSynchronize" in e.name]
        row = {"window": w, "lead_ms": lead, "counted": counted, "profiled": seen,
               "graph_launches": len(launches),
               "first_launch_minus_first_host_event_us": (
                   launches[0] - first_cpu if launches and first_cpu is not None else None),
               # A kernel cannot start before its launch: a negative gap is
               # the skew between the device and host timestamps.
               "first_kernel_minus_first_launch_us": (kernels[0] - launches[0]
                                                      if kernels and launches else None),
               # The last synchronize returns after the last kernel ends.
               "last_sync_minus_last_kernel_end_us": (max(syncs) - max(kernel_ends)
                                                      if syncs and kernel_ends else None)}
        runs[lead].append(row)
        if seen != counted:
            print(json.dumps({"differs": {**row, "paged_kernels_a_step": _step_sizes(kernels)}}),
                  flush=True)
    for e in entries:
        engine.pool.free(e[0])
    summary = {}
    for lead, rows in runs.items():
        gaps = [r["first_kernel_minus_first_launch_us"] for r in rows
                if r["first_kernel_minus_first_launch_us"] is not None]
        tails = [r["last_sync_minus_last_kernel_end_us"] for r in rows
                 if r["last_sync_minus_last_kernel_end_us"] is not None]
        summary[f"lead_{lead:g}ms"] = {
            "windows": len(rows), "windows_differing": sum(r["profiled"] != r["counted"]
                                                           for r in rows),
            "launches_lost": sum(r["counted"] - r["profiled"] for r in rows),
            "first_kernel_minus_first_launch_us_min": min(gaps) if gaps else None,
            "first_kernel_minus_first_launch_us_median": float(np.median(gaps)) if gaps else None,
            "last_sync_minus_last_kernel_end_us_min": min(tails) if tails else None,
            "last_sync_minus_last_kernel_end_us_median": (float(np.median(tails)) if tails
                                                          else None)}
    return {"train_config_first": train_config, **summary}


def _psum_rank(rank: int, iters: int) -> dict:
    import torch

    from tensorflow_examples_torch.core import collectives as coll
    from tensorflow_examples_torch.core.mesh import MeshConfig, create_mesh

    dev = torch.device("cuda")
    mesh = create_mesh(MeshConfig(data=1, model=2), device=dev)
    gen = torch.Generator().manual_seed(rank)
    x = torch.randn(8, 768, generator=gen).to(dev)
    w = torch.randn(768, 3072, generator=gen).to(dev) * 0.02
    host = x.cpu()

    def timed(fn, *, alone: bool = False) -> float | None:
        torch.distributed.barrier()
        ms = None
        if not alone or rank == 0:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / iters
        torch.distributed.barrier()
        return ms

    psum = lambda t: coll.psum(t, "model", mesh=mesh)
    return {
        "staging_copies_ms_rank0_alone": timed(lambda: x.cpu().to(dev), alone=True),
        "staging_copies_ms_both": timed(lambda: x.cpu().to(dev)),
        "psum_host_tensor_ms": timed(lambda: psum(host)),
        "psum_cuda_tensor_ms": timed(lambda: psum(x)),
        "product_ms": timed(lambda: (x @ w) @ w.T),
        "product_then_psum_ms": timed(lambda: psum((x @ w) @ w.T)),
    }


def psum_probe(iters: int) -> dict:
    sys.path.insert(0, HERE)
    from tensorflow_examples_torch.core import distributed

    ranks = distributed.run_world(_psum_rank, 2, iters, device="cuda", timeout_s=300)
    return {"probe": "psum", "iters": iters, "per_rank": ranks}


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
    d = sub.add_parser("determinism")
    d.add_argument("--runs", type=int, default=4)
    d.add_argument("--steps", type=int, default=20)
    d.add_argument("--reruns", type=int, default=100)
    q = sub.add_parser("psum")
    q.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_probe: needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if args.probe == "steps":
        result = steps(os.path.abspath(args.root), args.steps)
    elif args.probe == "determinism":
        result = determinism(args.runs, args.steps, args.reruns)
    elif args.probe == "psum":
        result = psum_probe(args.iters)
    else:
        result = profiler(args.windows, args.train_config, args.lead_ms)
    result["wall_s"] = time.perf_counter() - t0
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
