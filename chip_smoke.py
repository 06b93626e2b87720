#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``tensorflow_examples_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the checkout around this file; exits non-zero
without a result line otherwise. Phases, each of which passes or exits
non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: both CUDA kernels from ``tensorflow_examples_torch/ops/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (flash-decode: B=1, H=12, D=64,
   q_len=length in {16, 100, 512, 1024}, f32 and bf16, plus a q_len=1 step into
   a longer cache; paged-decode: S=8, H=12, BS=16, nb=64 with ragged
   lengths, fp32 and int8), with kernel, plain and bound times, and
   ``scaled_dot_product_attention`` timed as a yardstick only;
4. serving: GPT-2 124M at full width, random weights from seed 0, f32,
   through ``ContinuousBatcher`` + ``ServingFrontend`` over real HTTP in
   three engine configurations (dense pool with ``attention="flash"``;
   paged pool, block 16, ``attention="paged_flash"``; the same with int8
   KV), 8 concurrent greedy requests each, every stream checked against
   the cacheless ``reference_generate`` on the card and the kernels'
   launch counters read around the served requests;
5. the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # f32 outside the tensor cores
NEAR_TIE = 1e-4                # top-2 logit gap below which a greedy flip is a tie
FLASH_SOURCE = "tensorflow_examples_torch/ops/csrc/decode.cu"
PAGED_SOURCE = "tensorflow_examples_torch/ops/csrc/paged_decode.cu"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 1


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi failed: {e}")
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}), "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    return smi


# ---------------------------------------------------------------- phase 2


def phase_build(build) -> None:
    t0 = time.perf_counter()
    try:
        build.build_all()
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    log(f"build: {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.3f} s "
        f"(one nvcc per source, in parallel)")
    for name, text in sorted(build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 3


def bound(t_bytes: float, t_ops: float) -> tuple[float, str]:
    """The least time for the work: the larger of its bytes over the
    memory rate and its operations over the peak rate."""
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_times(q_len, length, max_len, bh, d, dtype_name, itemsize):
    """(bytes_ms, ops_ms) for one flash-decode call: each input read
    once (K/V only up to the rows the loop reaches), the output written
    once; the causal score/value products this length needs."""
    reach = min(length, max_len)
    pairs = sum(max(0, min(length - q_len + r + 1, max_len)) for r in range(q_len))
    nbytes = (2 * q_len + 2 * reach) * bh * d * itemsize
    ops = 4 * d * pairs * bh
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype_name] * 1e3


def paged_times(lengths, block_size, h, d, kv_itemsize, quantized):
    """(bytes_ms, ops_ms) for one paged-decode call over these lengths."""
    s = len(lengths)
    total = int(sum(lengths))
    blocks = int(sum(-(-n // block_size) for n in lengths))
    nbytes = 2 * s * h * d * 4                 # q in, out
    nbytes += 2 * total * h * d * kv_itemsize  # populated K and V rows
    nbytes += 2 * total * h * 4 if quantized else 0  # their row scales
    nbytes += 4 * s + 4 * blocks               # lengths, table entries read
    ops = 4 * d * h * total
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S["float32"] * 1e3


def phase_kernels(torch, decode, paged, precision) -> dict:
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    rows = {}

    # Flash-decode at the engine's prefill shapes: q_len == length == cache.
    flash_err = 0.0
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        dname = str(dtype).replace("torch.", "")
        for n in (16, 100, 512, 1024):
            q, k, v = (randn(1, 12, n, 64, dtype=dtype) for _ in range(3))
            out = decode.flash_decode_attention(q, k, v, n)
            ref = decode.decode_attention_reference(q, k, v, n)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            if not torch.isfinite(out.float()).all() or err > atol:
                fail(f"flash_decode {dname} q_len=length={n}: max_abs_err {err:.3e} > {atol}")
            if dtype == torch.float32:
                flash_err = max(flash_err, err)
            ms = cuda_ms(torch, lambda: decode.flash_decode_attention(q, k, v, n))
            plain = cuda_ms(torch, lambda: decode.decode_attention_reference(q, k, v, n))
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
            t_bytes, t_ops = flash_times(n, n, n, 12, 64, dname, q.element_size())
            bound_ms, by = bound(t_bytes, t_ops)
            log(f"flash_decode {dname} B=1 H=12 q_len=length={n} D=64: max_abs_err {err:.3e} "
                f"(atol {atol}) kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms(sdpa) "
                f"{lib:.4f} bytes_ms {t_bytes:.5f} (at 3.35 TB/s) ops_ms {t_ops:.5f} "
                f"bound_ms {bound_ms:.5f} ({by})")
            if dtype == torch.float32 and n == 1024:
                rows["flash_decode"] = dict(
                    shape="B=1 H=12 q_len=length=1024 D=64 float32", ms=ms,
                    plain_ms=plain, bound_ms=bound_ms, bound_by=by, library_ms=lib,
                )
    # One new query into a longer cache whose tail past `length` is NaN:
    # the kernel must read nothing past the populated length.
    q = randn(1, 12, 1, 64)
    k, v = randn(1, 12, 1024, 64), randn(1, 12, 1024, 64)
    k[:, :, 300:] = float("nan")
    v[:, :, 300:] = float("nan")
    out = decode.flash_decode_attention(q, k, v, 300)
    ref = decode.decode_attention_reference(q, k[:, :, :300], v[:, :, :300], 300)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not torch.isfinite(out).all() or err > 2e-5:
        fail(f"flash_decode q_len=1 length=300 max_len=1024: max_abs_err {err:.3e}")
    flash_err = max(flash_err, err)
    log(f"flash_decode float32 q_len=1 length=300 max_len=1024 (NaN tail): max_abs_err {err:.3e}")
    rows["flash_decode"]["max_abs_err"] = flash_err

    # Paged decode: S=8, H=12, BS=16, nb=64; ragged lengths with an empty
    # slot, a length-1 slot, a full block, ragged last blocks, a full table.
    s, h, bs, nb, d = 8, 12, 16, 64, 64
    lengths_l = [0, 1, 16, 17, 77, 300, 511, 1024]
    num_blocks = s * nb + 1
    perm = torch.randperm(num_blocks - 1, generator=gen) + 1
    tables = torch.zeros(s, nb, dtype=torch.int32)
    used = 0
    for i, n in enumerate(lengths_l):
        need = -(-n // bs)
        tables[i, :need] = perm[used:used + need].int()
        used += need
    tables = tables.to(dev)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    q = randn(s, h, d)
    kb, vb = randn(num_blocks, h, bs, d), randn(num_blocks, h, bs, d)
    qk, ks = precision.quantize_int8_rows(kb)
    qv, vs = precision.quantize_int8_rows(vb)
    live = lengths > 0
    paged_err = 0.0
    for label, args, kw, itemsize in (
        ("fp32", (kb, vb), {}, 4),
        ("int8", (qk, qv), {"k_scale": ks, "v_scale": vs}, 1),
    ):
        out = paged.paged_decode_attention(q, *args, lengths, tables, **kw)
        ref = paged.paged_decode_reference(q, *args, lengths, tables, **kw)
        torch.cuda.synchronize()
        err = float((out[live] - ref[live]).abs().max())
        empty = float(out[~live].abs().max())
        if not torch.isfinite(out).all() or err > 2e-6 or empty > 1e-30:
            fail(f"paged_decode {label}: max_abs_err {err:.3e} (atol 2e-6), "
                 f"length-0 slot max {empty:.3e}")
        paged_err = max(paged_err, err)
        ms = cuda_ms(torch, lambda: paged.paged_decode_attention(q, *args, lengths, tables, **kw))
        plain = cuda_ms(torch, lambda: paged.paged_decode_reference(q, *args, lengths, tables, **kw))
        t_bytes, t_ops = paged_times(lengths_l, bs, h, d, itemsize, bool(kw))
        bound_ms, by = bound(t_bytes, t_ops)
        log(f"paged_decode {label} S={s} H={h} BS={bs} nb={nb} lengths={lengths_l}: max_abs_err "
            f"{err:.3e} (atol 2e-6), length-0 slot writes zeros; kernel_ms {ms:.4f} "
            f"plain_ms {plain:.4f} bytes_ms {t_bytes:.5f} (at 3.35 TB/s) ops_ms {t_ops:.5f} "
            f"bound_ms {bound_ms:.5f} ({by})")
        if label == "fp32":
            rows["paged_decode"] = dict(
                shape=f"S={s} H={h} BS={bs} nb={nb} D={d} fp32 lengths={lengths_l}",
                ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=by, library_ms=None,
            )
    rows["paged_decode"]["max_abs_err"] = paged_err
    return rows


# ---------------------------------------------------------------- phase 4


def post(url: str, body: dict, timeout: float = 300.0) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def stream_verdict(torch, engine, prompt, served, ref):
    """'exact', ('tie', i) for a first difference where the reference's
    top-2 logits are within NEAR_TIE, or ('mismatch', i, gap)."""
    for i, (a, b) in enumerate(zip(served, ref)):
        if a != b:
            top2 = torch.topk(engine.reference_logits(list(prompt) + ref[:i]).float(), 2).values
            gap = float(top2[0] - top2[1])
            return ("tie", i) if gap < NEAR_TIE else ("mismatch", i, gap)
    return "exact" if len(served) == len(ref) else ("mismatch", min(len(served), len(ref)), None)


def device_breakdown(torch, engine, requests, steps: int = 8) -> dict:
    """Where a step's time goes, from torch.profiler: one prefill of the
    longest prompt and ``steps`` decode steps over every request's slot.
    For each: host wall time, summed kernel time on the card (its share
    of the wall is the busy share; the rest is the card idle, waiting on
    the host), the port's own kernels' share, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # Shifted token ids: prompts the prefix cache has not seen, so the
    # profiled prefill is a full one, not a prefix hit.
    vocab = engine.model_cfg.vocab_size
    prompts = [[(t + 1) % vocab for t in body["prompt"]] for body in requests]
    slots = [engine.pool.alloc() for _ in requests]
    entries = []
    for slot, prompt in zip(slots[:-1], prompts[:-1]):
        entries.append([slot, engine.prefill(slot, prompt)[0], 0, 0.0, 0])

    def prefill_last():
        entries.append([slots[-1], engine.prefill(slots[-1], prompts[-1])[0], 0, 0.0, 0])

    def decode():
        out = engine.decode([tuple(e) for e in entries])
        for e in entries:
            e[1] = out[e[0]]

    result = {}
    for label, fn, n in (("prefill", prefill_last, 1), ("decode", decode, steps)):
        if label == "decode":
            decode()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        kernels = sorted(
            ((e.key, e.self_device_time_total / 1e3 / n, e.count // n)
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0),
            key=lambda r: -r[1],
        )
        busy = sum(ms for _, ms, _ in kernels)
        ours = sum(ms for name, ms, _ in kernels if "decode_kernel" in name)
        result[label] = {
            "wall_ms": wall_ms, "device_ms": busy,
            "busy_share": busy / wall_ms if wall_ms else None,
            "port_kernel_ms": ours,
            "launches": sum(c for _, _, c in kernels),
            "top": [[name[:70], ms, c] for name, ms, c in kernels[:6]],
        }
    for slot in slots:
        engine.pool.free(slot)
    return result


def phase_serving(torch, model, model_cfg, counters) -> list[dict]:
    from tensorflow_examples_torch.serving.batcher import ContinuousBatcher
    from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
    from tensorflow_examples_torch.serving.frontend import ServingFrontend

    rng = np.random.default_rng(0)
    prompt_lens = [5, 17, 40, 64, 100, 150, 230, 300]
    requests = [
        {"prompt": [int(t) for t in rng.integers(0, model_cfg.vocab_size, n)],
         "max_new_tokens": int(rng.integers(16, 33)), "seed": i}
        for i, n in enumerate(prompt_lens)
    ]
    configs = (
        ("dense_flash", ServeConfig(max_slots=8, attention="flash"), "flash_decode"),
        ("paged_flash", ServeConfig(max_slots=8, kv_block_size=16, attention="paged_flash"),
         "paged_decode"),
        ("paged_flash_int8", ServeConfig(max_slots=8, kv_block_size=16, attention="paged_flash",
                                         kv_dtype="int8"), "paged_decode"),
    )
    summaries = []
    for name, serve_cfg, kernel in configs:
        engine = InferenceEngine(model_cfg, model, cfg=serve_cfg)
        batcher = ContinuousBatcher(engine).start()
        frontend = ServingFrontend(batcher).start()
        try:
            post(frontend.url(), {"prompt": [1, 2, 3], "max_new_tokens": 2})  # first-call set-up
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
                replies = list(pool.map(lambda b: post(frontend.url(), b), requests))
            wall = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
        finally:
            frontend.close()
            batcher.close(drain=False)
        if launches[kernel] < 1:
            fail(f"serve[{name}]: the {kernel} kernel was launched no time while serving")
        exact = ties = 0
        for body, reply in zip(requests, replies):
            toks = reply["tokens"]
            if len(toks) != body["max_new_tokens"] or not all(
                    0 <= t < model_cfg.vocab_size for t in toks):
                fail(f"serve[{name}]: malformed stream {toks!r}")
            ref = engine.reference_generate(body["prompt"], max_new=body["max_new_tokens"],
                                            seed=body["seed"])
            if serve_cfg.kv_dtype == "int8":
                agree = sum(a == b for a, b in zip(toks, ref)) / len(ref)
                if toks[0] != ref[0] or agree < 0.75:
                    fail(f"serve[{name}] prompt_len={len(body['prompt'])}: int8 stream "
                         f"first token {toks[0]} vs {ref[0]}, agreement {agree:.3f} < 0.75")
                exact += toks == ref
                continue
            verdict = stream_verdict(torch, engine, body["prompt"], toks, ref)
            if verdict == "exact":
                exact += 1
            elif verdict[0] == "tie":
                ties += 1
            else:
                fail(f"serve[{name}] prompt_len={len(body['prompt'])}: stream differs from "
                     f"reference_generate at token {verdict[1]} (top-2 gap {verdict[2]})")
        ttft = [r["ttft_s"] for r in replies]
        tpot = [(r["total_s"] - r["ttft_s"]) / (len(r["tokens"]) - 1) for r in replies]
        generated = sum(len(r["tokens"]) for r in replies)
        summary = dict(
            config=name, requests=len(requests), generated_tokens=generated,
            wall_s=wall, tok_per_s=generated / wall, ttft_p50_s=float(np.median(ttft)),
            tpot_p50_s=float(np.median(tpot)), exact_streams=exact, near_tie_streams=ties,
            launches=launches,
        )
        log(f"serve[{name}]: {json.dumps(summary)}")
        log(f"profile[{name}] (per prefill / per decode step, ms): "
            f"{json.dumps(device_breakdown(torch, engine, requests))}")
        summaries.append(summary)
        del engine, batcher, frontend
        torch.cuda.empty_cache()
    return summaries


# ------------------------------------------------------------------ main


def main() -> int:
    import torch

    phase_device(torch)
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "tensorflow_examples_torch")):
        fail("run from a checkout: tensorflow_examples_torch/ is not beside this script")
    sys.path.insert(0, here)
    from tensorflow_examples_torch.core import precision
    from tensorflow_examples_torch.models import transformer
    from tensorflow_examples_torch.ops import _build, decode, paged_decode

    phase_build(_build)
    rows = phase_kernels(torch, decode, paged_decode, precision)

    counters = {"flash_decode": decode.flash_decode_attention,
                "paged_decode": paged_decode.paged_decode_attention}
    model_cfg = transformer.gpt2_124m()
    t0 = time.perf_counter()
    model = transformer.GPT2(model_cfg, seed=0).to("cuda")
    log(f"model: GPT-2 124M, {sum(p.numel() for p in model.parameters())} params, "
        f"random init seed 0, f32, built in {time.perf_counter() - t0:.3f} s")
    summaries = phase_serving(torch, model, model_cfg, counters)

    kernels = []
    for name, source, replaces in (
        ("flash_decode", FLASH_SOURCE, "tensorflow_examples_tpu/ops/decode.py:78"),
        ("paged_decode", PAGED_SOURCE, "tensorflow_examples_tpu/ops/paged_decode.py:61"),
    ):
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(s["launches"][name] for s in summaries),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
