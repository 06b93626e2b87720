#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``tensorflow_examples_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the checkout around this file; exits non-zero
without a result line otherwise. Phases, each of which passes or exits
non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA source in ``tensorflow_examples_torch/ops/csrc``
   (one ``nvcc`` each, all at once);
3. kernels: each kernel against its plain PyTorch version on the card at
   its path's shapes, with kernel, plain and bound times, and
   ``scaled_dot_product_attention`` timed as a yardstick only
   (flash-decode: B=1, H=12, D=64, q_len=length in {16, 100, 512, 1024},
   f32 and bf16, plus a q_len=1 step into a longer cache; paged-decode:
   S=8, H=12, BS=16, nb=64 with ragged lengths, fp32 and int8; the three
   training flash kernels at the GPT-2 step's shape, B=16, H=12, S=1024,
   D=64, causal, bf16 and f32, plus seq_q < seq_kv, a length that is not
   a tile multiple, a key bias with masked keys and a nonzero lse
   cotangent; the fused cross-entropy forward and backward at the
   step's logits, N=16384 x V=50257, bf16 and f32, plus V 4099 and 1000,
   N=1, labels -1 and V, a row of all -1e30 and a non-unit cotangent,
   with ``torch.nn.functional.cross_entropy`` timed as a yardstick only;
   every attention kernel (flash forward, dK/dV, dQ, flash-decode, paged
   decode) at head_dim 8, 16, 32 and 128 against its plain version at
   batch 2 with the head_dim-64 tolerances;
   the grouped-matmul kernels ``gmm``, ``gmm`` with ``transpose_rhs`` and
   ``tgmm`` at the MoE step's two expert products, [16384, 768] x
   [8, 768, 3072] and [16384, 3072] x [8, 3072, 768], with the skewed
   group sizes ``MOE_SIZES``, bf16 and f32, plus m=2, m=1554, k and n of
   100 and 36, every row in one group, one-row groups and empty groups
   first and last (``tgmm`` exact zeros, through ``lhs.T`` and a
   contiguous ``lhs_t``), with ``torch._grouped_mm`` (or, where it
   refuses, the per-group ``torch.matmul`` loop) timed as a yardstick
   only; the bf16 MoE shapes must take the tensor-core gmm and tgmm, f32
   and k, n of 100 and 36 the SIMT ones; bf16 ``tgmm`` is also timed at
   both MoE shapes with every expert at 2048 rows and with every row in
   one group, beside its rows-per-chunk neighbours (2048, 8192); and the
   MoE bias gathers' backward ``group_row_sum`` at [16384, 3072] and
   [16384, 768] with ``MOE_SIZES``, bf16 and f32, against its plain
   version, rerun bit-identical, with ``torch.segment_reduce`` timed as
   a yardstick only);
4. training: GPT-2 124M at full width on synthetic bigram data through
   ``Trainer.fit`` (bf16 compute, dropout 0.1, batch 16 x 1024, 20 steps,
   warmup cut to 5 steps so the loss can move, the fused cross-entropy
   kernels at ``fused_ce=True``, checkpoints every 10 steps into a
   temporary workdir), after the step's loss and every gradient at step
   0 with the flash kernels are held to the plain attention path and
   with the fused cross-entropy to the plain one (f32, dropout 0); step
   time, tokens/s, MFU, peak memory, the loss falling, launches per step
   (and twice the forward launches under remat at step 0), and one
   profiled step's device time split into flash kernels, matmuls, the
   rest and idle (cross-entropy and the optimizer update timed on their
   own);
4a. resume: a fresh ``Trainer`` restores the step-10 checkpoint and trains
   to 20; its losses at steps 11-20 against the uninterrupted run's, the
   checkpoint's bytes, the restore wall time and the training run's two
   saves (host copy and threaded write, from their spans);
4b. generate: the step-20 checkpoint restored through
   ``tensorflow_examples_torch.generate``, 32 greedy tokens from a
   64-token prompt in f32 with ``attention="flash"`` (flash-decode, 12
   launches a call) and ``"xla"``, the two streams held to each other;
4c. MoE training: ``bench.py``'s ``moe_bench_config()`` at its TPU widths
   (GPT-2 124M widths, 8 experts, top-2 MoE in every 2nd block, batch
   8 x 1024, bf16, dropout 0, flash, fused CE, ``moe_impl="grouped"``)
   through ``Trainer.fit`` for 20 steps (warmup cut to 5), checkpointing
   at the end, after step 0 (f32, router jitter on) with the grouped
   kernels is held to ``impl="scatter"`` at capacity factor 8 (nothing
   drops) and to the plain gmm/tgmm/group_row_sum (step 0 takes the
   SIMT tgmm, 12 launches, and 12 ``group_row_sum``); loss falling,
   ``moe_drop`` 0, ``moe_aux`` finite, exactly 24 gmm and 12 tgmm
   launches a step, all on the tensor cores, and 12 ``group_row_sum``,
   step time, tokens/s, peak memory and one profiled step, which must
   run no ``indexing_backward_kernel``;
4d. MoE generate: 32 greedy tokens from a step-0 checkpoint of the MoE
   model's initial parameters from seed 0 (the 20-step state decodes to
   one token repeated) through ``tensorflow_examples_torch.generate``
   (f32), the grouped kernels against the plain gmm, the stream needing
   at least 8 distinct tokens, the two streams held to each other, and
   the logits of the whole sequence held within 1e-4 of their max;
5. serving: GPT-2 124M at full width, random weights from seed 0, f32,
   through ``ContinuousBatcher`` + ``ServingFrontend`` over real HTTP in
   three engine configurations (dense pool with ``attention="flash"``;
   paged pool, block 16, ``attention="paged_flash"``; the same with int8
   KV), 8 concurrent greedy requests each, every stream checked against
   the cacheless ``reference_generate`` on the card and the kernels'
   launch counters read around the served requests;
6. the ``{"group_row_sum": {...}}`` line (not the port of a TPU kernel),
   the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # f32 outside the tensor cores
NEAR_TIE = 1e-4                # top-2 logit gap below which a greedy flip is a tie
FLASH_SOURCE = "tensorflow_examples_torch/ops/csrc/decode.cu"
PAGED_SOURCE = "tensorflow_examples_torch/ops/csrc/paged_decode.cu"
ATTN_SOURCE = "tensorflow_examples_torch/ops/csrc/flash_attention.cu"
CE_SOURCE = "tensorflow_examples_torch/ops/csrc/cross_entropy.cu"
GMM_SOURCE = "tensorflow_examples_torch/ops/csrc/grouped_matmul.cu"
GMM_REPLACES = "tensorflow_examples_tpu/parallel/moe.py:190 (megablox gmm.py:{})"
BF16_DENSE_PEAK = 989.4e12     # H100 SXM bf16 tensor cores, dense: the MFU denominator
TRAIN_STEPS = 20
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "ce_fwd", "ce_bwd")
PLAIN_CE_PEAK_GIB = 25.1       # the same 20-step run at fused_ce=False, as PERF.md records it
CE_SHAPE = (16384, 50257)      # the step's logits: batch 16 x 1024 tokens, GPT-2 vocab
# Cross-entropy edge cases (label, N, V), each with labels -1 and V, a row
# of all -1e30 and a non-unit cotangent where N allows.
CE_EDGES = (("V=4099", 64, 4099), ("V=1000", 64, 1000), ("N=1", 1, 50257))
TRAIN_ATTN = (16, 12, 1024)    # the GPT-2 step's attention: batch, heads, sequence
# Flash edge cases (label, seq_q, seq_kv, causal, key bias, nonzero dlse), at batch 2.
FLASH_EDGES = (
    ("seq_q<seq_kv", 300, 1000, True, None, False),
    ("uneven", 777, 777, True, None, False),
    ("key_bias -1e9", 256, 256, False, -1e9, False),
    ("key_bias NEG_INF", 200, 320, True, "NEG_INF", False),
    ("dlse", 512, 512, True, None, True),
)
# The MoE step's expert products (m, k, n): 8 x 1024 tokens, top-2, d 768, ff 3072.
MOE_SHAPES = ((16384, 768, 3072), (16384, 3072, 768))
MOE_SIZES = (5000, 3000, 2500, 2000, 1800, 1084, 1000, 0)  # skewed routing over 8 experts
# Grouped-matmul edge cases (label, m, k, n, group sizes).
GMM_EDGES = (
    ("m=2", 2, 768, 3072, (0, 1, 0, 0, 0, 0, 1, 0)),
    ("m=1554", 1554, 768, 3072, (300, 0, 254, 500, 0, 200, 300, 0)),
    ("k=100 n=36", 1554, 100, 36, (300, 0, 254, 500, 0, 200, 300, 0)),
    ("k=36 n=100", 1554, 36, 100, (300, 0, 254, 500, 0, 200, 300, 0)),
    ("one group", 16384, 768, 3072, (0, 0, 0, 16384, 0, 0, 0, 0)),
    ("one-row groups", 1025, 768, 3072, (1, 512, 0, 511, 1, 0, 0, 0)),
    ("empty first and last", 2048, 3072, 768, (0, 700, 600, 748, 0, 0, 0, 0)),
)
# tgmm's timed routings at both MoE shapes, beside MOE_SIZES: every
# expert at 2048 rows (no group split) and every row in one group.
TGMM_ROUTINGS = (("balanced", (2048,) * 8), ("one group", (0, 0, 0, 16384, 0, 0, 0, 0)))
TGMM_CHUNK_SWEEP = (2048, 4096, 8192)  # tgmm's rows per chunk, timed around the chosen one
ROW_SUM_WIDTHS = (3072, 768)           # the bias gradients: b_in [8, ff], b_out [8, d]
MOE_KERNELS = ("gmm", "tgmm", "group_row_sum")
SWEEP_HEAD_DIMS = (8, 16, 32, 128)  # head_dim 64 is the main path's, checked above
MIN_DISTINCT = 8                    # distinct tokens a compared 32-token stream needs
MOE_GENERATE_SEED = 0               # the MoE generate phase's init (the serving phase's seed)


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


def flash_train_times(seq_q, seq_kv, bh, d, causal, dtype_name, itemsize, kind):
    """(bytes_ms, ops_ms) of one training flash kernel: each input read
    once and each output written once; the products over the visible
    (query, key) pairs: 2 for the forward (q.k, p.v), 4 for dK/dV
    (q.k, dO.v, p.dO, ds.q), 3 for dQ (q.k, dO.v, ds.k), 2*D operations
    each."""
    off = seq_kv - seq_q
    pairs = sum(max(0, min(seq_kv, r + off + 1)) for r in range(seq_q)) if causal else seq_q * seq_kv
    pairs *= bh
    q_bytes, kv_bytes, rows = bh * seq_q * d * itemsize, bh * seq_kv * d * itemsize, bh * seq_q * 4
    if kind == "fwd":
        nbytes, products = 2 * q_bytes + 2 * kv_bytes + rows, 2  # q, k, v in; o, lse out
    elif kind == "dkv":
        nbytes, products = 2 * q_bytes + 4 * kv_bytes + 3 * rows, 4  # q, dO, k, v, lse, delta, dlse; dk, dv
    else:
        nbytes, products = 3 * q_bytes + 2 * kv_bytes + 3 * rows, 3  # q, dO, k, v, rows; dq
    ops = 2 * d * products * pairs
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype_name] * 1e3


def allclose_err(torch, a, b, atol, rtol):
    """(max |a - b|, whether |a - b| <= atol + rtol |b| everywhere)."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    ok = bool(torch.isfinite(a).all()) and bool((diff <= atol + rtol * b.abs()).all())
    return float(diff.max()), ok


def worst_of(*errs):
    """The largest error of several (error, ok) checks, ok only if all are."""
    return max(e for e, _ in errs), all(ok for _, ok in errs)


def phase_flash_kernels(torch, attention) -> dict:
    """The three training flash kernels against their plain versions."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    rows = {}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    def check(label, seq_q, seq_kv, causal, dtype, bias=None, with_dlse=False, timed=False):
        b, h, d = (TRAIN_ATTN[0], TRAIN_ATTN[1], 64) if timed else (2, TRAIN_ATTN[1], 64)
        dname = str(dtype).replace("torch.", "")
        q, do = randn(b * h, seq_q, d, dtype=dtype), randn(b * h, seq_q, d, dtype=dtype)
        k, v = randn(b * h, seq_kv, d, dtype=dtype), randn(b * h, seq_kv, d, dtype=dtype)
        kb = None
        if bias is not None:
            kb = torch.zeros(b, seq_kv, device=dev)
            kb[: b // 2, seq_kv // 3:] = bias  # half the batch rows mask 2/3 of their keys
        dlse = randn(b * h, seq_q) if with_dlse else torch.zeros(b * h, seq_q, device=dev)
        kw = dict(heads=h, causal=causal, sm_scale=d ** -0.5)
        o, lse = attention.flash_fwd(q, k, v, kb, **kw)
        o_ref, lse_ref = attention.flash_fwd_plain(q, k, v, kb, **kw)
        delta = (do.float() * o_ref.float()).sum(-1)
        args = (q, k, v, do, lse_ref, delta, dlse, kb)
        dk, dv = attention.flash_bwd_dkv(*args, **kw)
        dq = attention.flash_bwd_dq(*args, **kw)
        dk_ref, dv_ref = attention.flash_bwd_dkv_plain(*args, **kw)
        dq_ref = attention.flash_bwd_dq_plain(*args, **kw)
        torch.cuda.synchronize()
        fwd_tol = 2e-5 if dtype == torch.float32 else 2e-2
        errs = {"fwd": allclose_err(torch, o, o_ref, fwd_tol, fwd_tol)}
        lse_err = allclose_err(torch, lse, lse_ref, 1e-4, 1e-5)
        if dtype == torch.float32:  # the JAX suite's gradient tolerance
            errs["dkv"] = worst_of(allclose_err(torch, dk, dk_ref, 5e-4, 5e-4),
                                   allclose_err(torch, dv, dv_ref, 5e-4, 5e-4))
            errs["dq"] = allclose_err(torch, dq, dq_ref, 5e-4, 5e-4)
        else:  # bf16 outputs: within 2e-2 of the plain version's largest gradient
            for kind, pairs_ in (("dkv", ((dk, dk_ref), (dv, dv_ref))), ("dq", ((dq, dq_ref),))):
                worst = (0.0, True)
                for a, r in pairs_:
                    scale = float(r.float().abs().max())
                    e = allclose_err(torch, a, r, 2e-2 * scale, 0.0)
                    worst = (max(worst[0], e[0]), worst[1] and e[1])
                errs[kind] = worst
        bad = [k for k, (_, ok) in errs.items() if not ok] + ([] if lse_err[1] else ["lse"])
        log(f"flash[{label}] {dname} B={b} H={h} seq_q={seq_q} seq_kv={seq_kv} causal={causal} "
            f"bias={bias} dlse={with_dlse}: max_abs_err fwd {errs['fwd'][0]:.3e} lse "
            f"{lse_err[0]:.3e} dkv {errs['dkv'][0]:.3e} dq {errs['dq'][0]:.3e}")
        if bad:
            fail(f"flash[{label}] {dname}: {bad} outside tolerance (fwd {fwd_tol}, f32 grads "
                 f"5e-4, bf16 grads 2e-2 of max)")
        if not timed:
            return errs
        calls = {
            "fwd": (lambda: attention.flash_fwd(q, k, v, **kw),
                    lambda: attention.flash_fwd_plain(q, k, v, None, **kw)),
            "dkv": (lambda: attention.flash_bwd_dkv(*args, **kw),
                    lambda: attention.flash_bwd_dkv_plain(*args, **kw)),
            "dq": (lambda: attention.flash_bwd_dq(*args, **kw),
                   lambda: attention.flash_bwd_dq_plain(*args, **kw)),
        }
        q4, k4, v4 = (t.reshape(b, h, -1, d) for t in (q, k, v))
        sdpa_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                          is_causal=causal))
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
        do4 = do.reshape(b, h, -1, d)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            torch.autograd.grad(out, (qg, kg, vg), do4)

        sdpa_both = cuda_ms(torch, sdpa_fwd_bwd, iters=10)
        for kind, (kernel, plain) in calls.items():
            ms = cuda_ms(torch, kernel)
            plain_ms = cuda_ms(torch, plain, iters=5, warmup=1)
            t_bytes, t_ops = flash_train_times(seq_q, seq_kv, b * h, d, causal, dname,
                                               q.element_size(), kind)
            bound_ms, by = bound(t_bytes, t_ops)
            log(f"flash_{kind} {dname} B={b} H={h} S={seq_q} D={d} causal: kernel_ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} bytes_ms {t_bytes:.5f} ops_ms {t_ops:.5f} bound_ms "
                f"{bound_ms:.5f} ({by}); library sdpa fwd_ms {sdpa_fwd:.4f} fwd+bwd_ms "
                f"{sdpa_both:.4f}")
            rows.setdefault(f"{dname}/{kind}", dict(
                shape=f"B={b} H={h} S={seq_q} D={d} causal {dname}", ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by,
                library_ms=sdpa_fwd if kind == "fwd" else None, sdpa_fwd_bwd_ms=sdpa_both,
            ))
        return errs

    # Worst max |kernel - plain| per kernel and dtype over every case; the
    # timed row carries the bf16 training shape's own error.
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        train_errs = check("train", TRAIN_ATTN[2], TRAIN_ATTN[2], True, dtype, timed=True)
        edges = [check(label, sq, skv, causal, dtype, with_dlse=dlse,
                       bias=attention.NEG_INF if bias == "NEG_INF" else bias)
                 for label, sq, skv, causal, bias, dlse in FLASH_EDGES]
        for errs in (train_errs, *edges):
            for kind, (err, _) in errs.items():
                worst[f"{dname}/{kind}"] = max(worst.get(f"{dname}/{kind}", 0.0), err)
        for kind, (err, _) in train_errs.items():
            rows[f"{dname}/{kind}"]["max_abs_err"] = err
    out = {}
    for kind, name in (("fwd", "flash_fwd"), ("dkv", "flash_bwd_dkv"), ("dq", "flash_bwd_dq")):
        row = dict(rows[f"bfloat16/{kind}"])
        row["float32"] = rows[f"float32/{kind}"]
        row["worst_abs_err_all_cases"] = {"bfloat16": worst[f"bfloat16/{kind}"],
                                          "float32": worst[f"float32/{kind}"]}
        out[name] = row
    return out


def phase_head_dim_sweep(torch, attention, decode, paged, precision) -> dict:
    """Every attention kernel at the other head_dims it is built for,
    against its plain version at batch 2 with the head_dim-64 tolerances:
    the three training flash kernels (B=2, H=12, S=1024, causal, bf16 and
    f32; the bf16 forward on the tensor cores from D=16), flash-decode
    (B=2, H=12, q_len=length=300, f32 and bf16) and paged decode (S=2,
    H=12, fp32 and int8; block 16, and block 64 at D=128, where a block
    takes two staged chunks). Returns the worst error per kernel and D."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    worst = {}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    def note(kernel, d, err, ok, what):
        worst.setdefault(kernel, {})[d] = max(worst.get(kernel, {}).get(d, 0.0), err)
        if not ok:
            fail(f"head_dim sweep: {kernel} {what} D={d}: max_abs_err {err:.3e} outside tolerance")

    b, h, seq = 2, TRAIN_ATTN[1], TRAIN_ATTN[2]
    for d in SWEEP_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            q, k, v, do = (randn(b * h, seq, d, dtype=dtype) for _ in range(4))
            dlse = randn(b * h, seq)
            kw = dict(heads=h, causal=True, sm_scale=d ** -0.5)
            o, lse = attention.flash_fwd(q, k, v, None, **kw)
            o_ref, lse_ref = attention.flash_fwd_plain(q, k, v, None, **kw)
            delta = (do.float() * o_ref.float()).sum(-1)
            args = (q, k, v, do, lse_ref, delta, dlse, None)
            dk, dv = attention.flash_bwd_dkv(*args, **kw)
            dq = attention.flash_bwd_dq(*args, **kw)
            dk_ref, dv_ref = attention.flash_bwd_dkv_plain(*args, **kw)
            dq_ref = attention.flash_bwd_dq_plain(*args, **kw)
            torch.cuda.synchronize()
            fwd_tol = 2e-5 if dtype == torch.float32 else 2e-2

            def grad_err(a, r):  # f32: the JAX suite's; bf16: 2e-2 of the largest gradient
                if dtype == torch.float32:
                    return allclose_err(torch, a, r, 5e-4, 5e-4)
                return allclose_err(torch, a, r, 2e-2 * float(r.float().abs().max()), 0.0)

            errs = {("flash_fwd", "O"): allclose_err(torch, o, o_ref, fwd_tol, fwd_tol),
                    ("flash_fwd", "lse"): allclose_err(torch, lse, lse_ref, 1e-4, 1e-5),
                    ("flash_bwd_dkv", "dK dV"): worst_of(grad_err(dk, dk_ref),
                                                         grad_err(dv, dv_ref)),
                    ("flash_bwd_dq", "dQ"): grad_err(dq, dq_ref)}
            ms = cuda_ms(torch, lambda: attention.flash_fwd(q, k, v, None, **kw), iters=10)
            log(f"head_dim sweep flash {dname} B={b} H={h} S={seq} D={d} causal: max_abs_err "
                + " ".join(f"{what} {err:.3e}" for (_, what), (err, _) in errs.items())
                + f"; flash_fwd kernel_ms {ms:.4f}")
            for (kernel, what), (err, ok) in errs.items():
                note(kernel, d, err, ok, f"{dname} {what}")
            del q, k, v, do, o, o_ref, dk, dv, dq, dk_ref, dv_ref, dq_ref

            n = 300
            q, kc, vc = (randn(b, h, n, d, dtype=dtype) for _ in range(3))
            out = decode.flash_decode_attention(q, kc, vc, n)
            ref = decode.decode_attention_reference(q, kc, vc, n)
            torch.cuda.synchronize()
            err, ok = allclose_err(torch, out, ref, fwd_tol, 0.0)
            log(f"head_dim sweep flash_decode {dname} B={b} H={h} q_len=length={n} D={d}: "
                f"max_abs_err {err:.3e} (atol {fwd_tol})")
            note("flash_decode", d, err, ok, dname)

        for bs in ((16, 64) if d == 128 else (16,)):
            lengths_l = [77, 16 * bs - 3]
            nb = -(-max(lengths_l) // bs)
            num_blocks = 2 * nb + 1
            perm = (torch.randperm(num_blocks - 1, generator=gen) + 1).int()
            tables = torch.stack([perm[:nb], perm[nb:2 * nb]]).to(dev)
            lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
            q = randn(2, h, d)
            kb, vb = randn(num_blocks, h, bs, d), randn(num_blocks, h, bs, d)
            qk, ks = precision.quantize_int8_rows(kb)
            qv, vs = precision.quantize_int8_rows(vb)
            for label, kv, kw in (("fp32", (kb, vb), {}),
                                  ("int8", (qk, qv), {"k_scale": ks, "v_scale": vs})):
                out = paged.paged_decode_attention(q, *kv, lengths, tables, **kw)
                ref = paged.paged_decode_reference(q, *kv, lengths, tables, **kw)
                torch.cuda.synchronize()
                err, ok = allclose_err(torch, out, ref, 2e-6, 0.0)
                log(f"head_dim sweep paged_decode {label} S=2 H={h} BS={bs} D={d} "
                    f"lengths={lengths_l}: max_abs_err {err:.3e} (2e-6)")
                note("paged_decode", d, err, ok, f"{label} BS={bs}")
    return worst


def ce_times(n, vocab, itemsize, kind):
    """(bytes_ms, ops_ms) of one cross-entropy kernel: logits read once
    (int64 labels and the f32 row values too), the outputs written once;
    three f32 operations an element (forward: max, exp, add; backward:
    subtract, exp, multiply) outside the tensor cores."""
    rows = n * (8 + 4 + 4)  # labels in, and nll + lse out / lse + g in
    nbytes = n * vocab * itemsize * (1 if kind == "fwd" else 2) + rows
    return nbytes / HBM_BYTES_PER_S * 1e3, 3 * n * vocab / PEAK_OPS_PER_S["float32"] * 1e3


def phase_ce_kernels(torch, ce) -> dict:
    """The fused cross-entropy kernels against their plain versions."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    rows, worst = {}, {}

    def check(label, n, vocab, dtype, timed=False):
        dname = str(dtype).replace("torch.", "")
        logits = (torch.randn(n, vocab, generator=gen) * 3).to(dev, dtype)
        labels = torch.randint(0, vocab, (n,), generator=gen).to(dev)
        labels[0] = -1
        if n > 2:
            labels[1] = vocab
            logits[2] = -1e30
        g = (torch.rand(n, generator=gen) + 0.5).to(dev)  # a non-unit cotangent
        nll, lse = ce.ce_fwd(logits, labels)
        nll_ref, lse_ref = ce.ce_fwd_plain(logits, labels)
        d = ce.ce_bwd(logits, labels, lse_ref, g)
        d_ref = ce.ce_bwd_plain(logits, labels, lse_ref, g)
        torch.cuda.synchronize()
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        errs = {"fwd": worst_of(allclose_err(torch, nll, nll_ref, tol, 1e-5),
                                allclose_err(torch, lse, lse_ref, tol, 1e-5))}
        if dtype == torch.float32:  # the JAX suite's gradient tolerance
            errs["bwd"] = allclose_err(torch, d, d_ref, 1e-6, 1e-5)
        else:  # bf16 dlogits: both round one f32 value, so within one bf16 ulp of each
            errs["bwd"] = allclose_err(torch, d, d_ref, 1e-7, 8e-3)
        log(f"ce[{label}] {dname} N={n} V={vocab} labels -1/V, -1e30 row, non-unit g: "
            f"max_abs_err nll/lse {errs['fwd'][0]:.3e} dlogits {errs['bwd'][0]:.3e}")
        bad = [k for k, (_, ok) in errs.items() if not ok]
        if bad:
            fail(f"ce[{label}] {dname}: {bad} outside tolerance (nll/lse {tol}, dlogits f32 "
                 f"1e-6 + 1e-5 rel, bf16 1e-7 + 8e-3 rel)")
        for kind, (err, _) in errs.items():
            worst[f"{dname}/{kind}"] = max(worst.get(f"{dname}/{kind}", 0.0), err)
        if not timed:
            return
        del d, d_ref, nll_ref
        torch.cuda.empty_cache()
        lib_fwd = cuda_ms(torch, lambda: F.cross_entropy(logits, labels.clamp(0, vocab - 1),
                                                         reduction="none"), iters=5)
        xg = logits.detach().clone().requires_grad_()
        safe = labels.clamp(0, vocab - 1)

        def lib_both():
            torch.autograd.grad(F.cross_entropy(xg, safe, reduction="none"), (xg,), g)

        lib_fwd_bwd = cuda_ms(torch, lib_both, iters=5)
        del xg
        for kind, kernel, plain in (
            ("fwd", lambda: ce.ce_fwd(logits, labels), lambda: ce.ce_fwd_plain(logits, labels)),
            ("bwd", lambda: ce.ce_bwd(logits, labels, lse_ref, g),
             lambda: ce.ce_bwd_plain(logits, labels, lse_ref, g)),
        ):
            ms = cuda_ms(torch, kernel)
            plain_ms = cuda_ms(torch, plain, iters=3, warmup=1)
            torch.cuda.empty_cache()
            t_bytes, t_ops = ce_times(n, vocab, logits.element_size(), kind)
            bound_ms, by = bound(t_bytes, t_ops)
            log(f"ce_{kind} {dname} N={n} V={vocab}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
                f"bytes_ms {t_bytes:.5f} ops_ms {t_ops:.5f} bound_ms {bound_ms:.5f} ({by}); "
                f"library F.cross_entropy fwd_ms {lib_fwd:.4f} fwd+bwd_ms {lib_fwd_bwd:.4f}")
            rows[f"{dname}/{kind}"] = dict(
                shape=f"N={n} V={vocab} {dname}", ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=lib_fwd if kind == "fwd" else None,
                library_fwd_bwd_ms=lib_fwd_bwd, max_abs_err=errs[kind][0])
        del logits
        torch.cuda.empty_cache()

    for dtype in (torch.bfloat16, torch.float32):
        check("train", *CE_SHAPE, dtype, timed=True)
        for label, n, vocab in CE_EDGES:
            check(label, n, vocab, dtype)
    out = {}
    for kind, name in (("fwd", "ce_fwd"), ("bwd", "ce_bwd")):
        row = dict(rows[f"bfloat16/{kind}"])
        row["float32"] = rows[f"float32/{kind}"]
        row["worst_abs_err_all_cases"] = {"bfloat16": worst[f"bfloat16/{kind}"],
                                          "float32": worst[f"float32/{kind}"]}
        out[name] = row
    return out


def gmm_times(m, k, n, g, itemsize, dtype_name, kind):
    """(bytes_ms, ops_ms) of one grouped-matmul call on these shapes: each
    input read once, the output written once; 2 m k n operations (every
    row lies in a group)."""
    if kind == "tgmm":  # lhs_t [k, m], rhs [m, n] -> [g, k, n]
        nbytes = (k * m + m * n + g * k * n) * itemsize
    else:  # lhs [m, k], rhs [g, k, n] -> [m, n]
        nbytes = (m * k + g * k * n + m * n) * itemsize
    nbytes += 4 * g  # group sizes
    ops = 2 * m * k * n
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype_name] * 1e3


def gmm_err(torch, out, ref, dtype):
    """(max |out - ref|, ok). f32: every element within 1e-4 of max |ref|.
    bf16 allows one bf16 rounding of each element on top (8e-3 |ref|):
    the two sides sum in f32 in different orders and each rounds its own
    sum, so a per-element bound alone fails where sums cancel to near 0."""
    a, b = out.float(), ref.float()
    diff = (a - b).abs()
    limit = 1e-4 * float(b.abs().max()) + (8e-3 * b.abs() if dtype == torch.bfloat16 else 0.0)
    ok = bool(torch.isfinite(a).all()) and bool((diff <= limit).all())
    return float(diff.max()), ok


def library_grouped(torch, lhs, rhs, grad, sizes, kind):
    """(name, a callable computing the kind's product with one PyTorch
    call, ``torch._grouped_mm``) where this torch has it and takes these
    operands; else the per-group ``torch.matmul`` loop. Timed as a
    yardstick only: the port never calls either."""
    ends = np.cumsum(sizes)
    starts = ends - np.asarray(sizes)
    offs = torch.tensor(ends, dtype=torch.int32, device=lhs.device)
    if kind == "tgmm":
        call = lambda: torch._grouped_mm(lhs.T, grad, offs=offs)
        plain = lambda: torch.stack([lhs[s:e].T @ grad[s:e] for s, e in zip(starts, ends)])
    elif kind == "gmm_t":
        call = lambda: torch._grouped_mm(grad, rhs.transpose(1, 2), offs=offs)
        plain = lambda: torch.cat([grad[s:e] @ rhs[i].T
                                   for i, (s, e) in enumerate(zip(starts, ends))])
    else:
        call = lambda: torch._grouped_mm(lhs, rhs, offs=offs)
        plain = lambda: torch.cat([lhs[s:e] @ rhs[i]
                                   for i, (s, e) in enumerate(zip(starts, ends))])
    if hasattr(torch, "_grouped_mm"):
        try:
            call()
            torch.cuda.synchronize()
            return "torch._grouped_mm", call
        except (RuntimeError, TypeError, ValueError) as e:
            log(f"  torch._grouped_mm refused {kind} {lhs.dtype}: {str(e).splitlines()[0][:120]}")
    return "per-group torch.matmul loop", plain


def row_sum_times(m, n, g, itemsize):
    """(bytes_ms, ops_ms) of one group_row_sum call: x [m, n] read once,
    [g, n] written once, the sizes read; m n additions in f32."""
    nbytes = (m * n + g * n) * itemsize + 4 * g
    return nbytes / HBM_BYTES_PER_S * 1e3, m * n / PEAK_OPS_PER_S["float32"] * 1e3


def library_row_sum(torch, x, sizes):
    """(name, callable): ``torch.segment_reduce`` over the sorted rows,
    timed as a yardstick only (its length check may sync with the host,
    so the port never calls it); None where it refuses these inputs."""
    lengths = sizes.long()
    call = lambda: torch.segment_reduce(x, "sum", lengths=lengths, unsafe=True)
    try:
        call()
        torch.cuda.synchronize()
        return "torch.segment_reduce", call
    except (RuntimeError, TypeError, ValueError) as e:
        log(f"  torch.segment_reduce refused {x.dtype}: {str(e).splitlines()[0][:120]}")
        return None, None


def phase_moe_kernels(torch, gm) -> dict:
    """The grouped-matmul kernels and the bias gathers' segmented sum
    against their plain versions."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    rows, worst = {}, {}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    def counts():
        return (gm.gmm.tensor_core_launches, gm.gmm.simt_launches,
                gm.tgmm.tensor_core_launches, gm.tgmm.simt_launches)

    def check(label, m, k, n, sizes, dtype, timed=()):
        """Every kind against its plain version (tgmm through ``lhs.T``
        and a contiguous ``lhs_t``), the variant each took, and the times
        of the kinds in ``timed``."""
        dname = str(dtype).replace("torch.", "")
        g = len(sizes)
        lhs, rhs = randn(m, k, dtype=dtype), randn(g, k, n, dtype=dtype)
        grad = randn(m, n, dtype=dtype)
        sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
        calls = {
            "gmm": (lambda: gm.gmm(lhs, rhs, sz), lambda: gm.gmm_plain(lhs, rhs, sz)),
            "gmm_t": (lambda: gm.gmm(grad, rhs, sz, transpose_rhs=True),
                      lambda: gm.gmm_plain(grad, rhs, sz, transpose_rhs=True)),
            "tgmm": (lambda: gm.tgmm(lhs.T, grad, sz), lambda: gm.tgmm_plain(lhs.T, grad, sz)),
        }
        errs = {}
        tensor_cores = dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
        want = {"gmm": (1, 0, 0, 0), "gmm_t": (1, 0, 0, 0), "tgmm": (0, 0, 1, 0)}
        if not tensor_cores:
            want = {"gmm": (0, 1, 0, 0), "gmm_t": (0, 1, 0, 0), "tgmm": (0, 0, 0, 1)}
        for kind, (kernel, plain) in calls.items():
            before = counts()
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            errs[kind] = gmm_err(torch, out, ref, dtype)
            took = tuple(a - b for a, b in zip(counts(), before))
            if took != want[kind]:
                fail(f"gmm[{label}] {dname} {kind}: launched (gmm tensor-core, gmm SIMT, tgmm "
                     f"tensor-core, tgmm SIMT) {took}, expected {want[kind]}")
            if kind == "tgmm":
                contiguous = gm.tgmm(lhs.T.contiguous(), grad, sz)
                torch.cuda.synchronize()
                errs["tgmm_contiguous"] = gmm_err(torch, contiguous, ref, dtype)
                empty = [i for i, size in enumerate(sizes) if size == 0]
                nonzero = [i for i in empty if bool(out[i].any()) or bool(contiguous[i].any())]
                if nonzero:
                    fail(f"tgmm[{label}] {dname}: empty groups {nonzero} are not exact zeros")
                del contiguous
            del out, ref
        variant = "tensor-core" if tensor_cores else "SIMT"
        log(f"gmm[{label}] {dname} m={m} k={k} n={n} sizes={list(sizes)}: max_abs_err "
            + " ".join(f"{kind} {err:.3e}" for kind, (err, _) in errs.items())
            + f"; gmm and tgmm kernels {variant}; tgmm empty groups exact zeros")
        bad = [kind for kind, (_, ok) in errs.items() if not ok]
        if bad:
            fail(f"gmm[{label}] {dname}: {bad} outside tolerance (1e-4 of max |ref|, plus "
                 f"8e-3 |ref| per element in bf16)")
        for kind, (err, _) in errs.items():
            kind = kind.split("_contiguous")[0]
            worst[f"{dname}/{kind}"] = max(worst.get(f"{dname}/{kind}", 0.0), err)
        for kind in timed:
            kernel, plain = calls[kind]
            ms = cuda_ms(torch, kernel)
            plain_ms = cuda_ms(torch, plain, iters=5, warmup=1)
            lib_name, lib = library_grouped(torch, lhs, rhs, grad, sizes, kind)
            lib_ms = cuda_ms(torch, lib, iters=5, warmup=1)
            kk, nn = (n, k) if kind == "gmm_t" else (k, n)
            t_bytes, t_ops = gmm_times(m, kk, nn, g, lhs.element_size(), dname,
                                       "tgmm" if kind == "tgmm" else "gmm")
            bound_ms, by = bound(t_bytes, t_ops)
            extra = ""
            row = {}
            if kind == "tgmm" and tensor_cores:  # the chunk size R, against its neighbours
                sweep = {}
                for chunk in TGMM_CHUNK_SWEEP:
                    saved, gm.TGMM_CHUNK_ROWS = gm.TGMM_CHUNK_ROWS, chunk
                    try:
                        sweep[chunk] = cuda_ms(torch, kernel)
                    finally:
                        gm.TGMM_CHUNK_ROWS = saved
                row["chunk_rows_ms"] = sweep
                extra = "; chunk rows " + " ".join(f"{c}: {t:.4f}" for c, t in sweep.items())
            log(f"{kind} {dname} [{label}] m={m} k={kk} n={nn} g={g}: kernel_ms {ms:.4f} plain_ms "
                f"{plain_ms:.4f} bytes_ms {t_bytes:.5f} ops_ms {t_ops:.5f} bound_ms "
                f"{bound_ms:.5f} ({by}); library {lib_name} ms {lib_ms:.4f}{extra}")
            rows[f"{dname}/{label}/{kind}"] = dict(
                shape=f"m={m} k={kk} n={nn} g={g} {dname} sizes={list(sizes)}", ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, library_ms=lib_ms,
                library=lib_name, max_abs_err=errs[kind][0], kernel=variant, **row)
        del lhs, rhs, grad
        torch.cuda.empty_cache()

    for dtype in (torch.bfloat16, torch.float32):
        for m, k, n in MOE_SHAPES:
            check(f"k={k}", m, k, n, MOE_SIZES, dtype, timed=("gmm", "gmm_t", "tgmm"))
            if dtype == torch.bfloat16:
                for label, sizes in TGMM_ROUTINGS:
                    check(f"k={k} {label}", m, k, n, sizes, dtype, timed=("tgmm",))
        for label, m, k, n, sizes in GMM_EDGES:
            check(label, m, k, n, sizes, dtype)
    # The rows carry the first expert product (x [16384, 768] x w_in) for
    # gmm and its weight gradient for tgmm; the other timings ride along.
    first = f"k={MOE_SHAPES[0][1]}"
    out = {}
    for name, kinds in (("gmm", ("gmm", "gmm_t")), ("tgmm", ("tgmm",))):
        row = dict(rows[f"bfloat16/{first}/{name}"])
        row["float32"] = rows[f"float32/{first}/{name}"]
        row["all_shapes"] = {key: {f: r[f] for f in ("shape", "ms", "plain_ms", "bound_ms",
                                                     "library_ms", "library", "kernel")}
                             for key, r in rows.items() if key.split("/")[-1] in kinds}
        row["worst_abs_err_all_cases"] = {
            d: max(worst[f"{d}/{kind}"] for kind in kinds) for d in ("bfloat16", "float32")}
        out[name] = row
    out["tgmm"]["design"] = (f"tensor cores (mma.sync bf16), groups split at "
                             f"{gm.TGMM_CHUNK_ROWS} rows; f32 SIMT")
    out["group_row_sum"] = phase_row_sum(torch, gm, randn)
    return out


def phase_row_sum(torch, gm, randn) -> dict:
    """The MoE bias gathers' backward, ``group_row_sum``, against its
    plain version at the step's two bias gradients, with its byte bound
    and ``torch.segment_reduce`` as the yardstick."""
    sz = torch.tensor(MOE_SIZES, dtype=torch.int32, device="cuda")
    m, g = sum(MOE_SIZES), len(MOE_SIZES)
    result = {}
    for n in ROW_SUM_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            x = randn(m, n, dtype=dtype)
            before = gm.group_row_sum.launches
            out, ref = gm.group_row_sum(x, sz), gm.group_row_sum_plain(x, sz)
            torch.cuda.synchronize()
            if gm.group_row_sum.launches != before + 1:
                fail(f"group_row_sum [{m}, {n}] {dname}: the kernel did not launch")
            err, ok = gmm_err(torch, out, ref, dtype)
            rerun = gm.group_row_sum(x, sz)
            if not ok or not torch.equal(out, rerun) or bool(out[MOE_SIZES.index(0)].any()):
                fail(f"group_row_sum [{m}, {n}] {dname}: max_abs_err {err:.3e} (limit 1e-4 of "
                     "max |ref|, plus 8e-3 |ref| in bf16), a rerun not bit-identical, or the "
                     "empty group not zero")
            ms = cuda_ms(torch, lambda: gm.group_row_sum(x, sz))
            plain_ms = cuda_ms(torch, lambda: gm.group_row_sum_plain(x, sz), iters=5, warmup=1)
            lib_name, lib = library_row_sum(torch, x, sz)
            lib_ms = cuda_ms(torch, lib, iters=5, warmup=1) if lib else None
            t_bytes, t_ops = row_sum_times(m, n, g, x.element_size())
            bound_ms, by = bound(t_bytes, t_ops)
            result[f"{dname}/n={n}"] = dict(
                shape=f"[{m}, {n}] {dname} sizes={list(MOE_SIZES)}", ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library=lib_name, library_ms=lib_ms,
                max_abs_err=err)
            log(f"group_row_sum {dname} [{m}, {n}] g={g}: kernel_ms {ms:.4f} plain_ms "
                f"{plain_ms:.4f} bytes_ms {t_bytes:.5f} ops_ms {t_ops:.5f} bound_ms "
                f"{bound_ms:.5f} ({by}); library {lib_name} ms "
                f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'}; max_abs_err {err:.3e}, "
                "rerun bit-identical")
            del x, out, ref, rerun
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------- phase 4


def device_split(torch, fn) -> dict:
    """torch.profiler around ``fn`` (which ends synchronized): host wall,
    summed kernel time, and kernel time by kind (the port's flash
    kernels, its grouped-matmul and row-sum kernels, matmuls, everything
    else); idle = wall - kernel time. ``indexing_backward_ms`` is PyTorch's
    scatter-add backward of a row gather, which the MoE step must not run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    split = {"flash": 0.0, "gmm": 0.0, "tgmm": 0.0, "group_row_sum": 0.0, "matmul": 0.0,
             "other": 0.0}
    launches = 0
    indexing_backward = 0.0
    top = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        # "gmm_tc_kernel" is a substring of "tgmm_tc_kernel": tgmm is matched first.
        kind = ("flash" if "flash_" in name else
                "tgmm" if "tgmm" in name else
                "gmm" if "gmm_kernel" in name or "gmm_tc_kernel" in name else
                "group_row_sum" if "group_row_sum" in name else
                "matmul" if any(t in name for t in ("gemm", "cutlass", "xmma", "cublas", "sm90_"))
                else "other")
        split[kind] += ms
        launches += e.count
        if "indexing_backward" in name:
            indexing_backward += ms
        top[e.key[:70]] = ms
    busy = sum(split.values())
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_ms": wall_ms - busy,
            "busy_share": busy / wall_ms, **{f"{k}_ms": v for k, v in split.items()},
            "indexing_backward_ms": indexing_backward, "kernel_launches": launches,
            "top": sorted(top.items(), key=lambda kv: -kv[1])[:8]}


def phase_training(torch, counters, smi: str, workdir: str) -> dict:
    from tensorflow_examples_torch.core import rng
    from tensorflow_examples_torch.data.memory import train_iterator
    from tensorflow_examples_torch.ops import cross_entropy as ce
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import gpt2

    base = gpt2.Gpt2Config(train_steps=TRAIN_STEPS, warmup_steps=5, log_every=1, eval_every=0,
                           telemetry_sinks="jsonl")
    if not base.fused_ce:
        fail("Gpt2Config().fused_ce is not True: the slice trains at the JAX default")
    t0 = time.perf_counter()
    train_ds, _ = gpt2.datasets(base)
    log(f"train data: {train_ds.size} synthetic bigram windows of {base.seq_len + 1} tokens "
        f"in {time.perf_counter() - t0:.3f} s")
    batch0 = next(train_iterator(train_ds, base.global_batch_size, seed=base.seed))

    # Step 0 with the flash kernels against the plain attention path, and
    # with the fused cross-entropy against the plain one: the same weights
    # (init seed) and batch, f32, dropout 0; and the flash step under
    # remat, which must launch the forward kernel twice a layer.
    step0 = {}
    for label, impl, remat, fused in (("flash", "flash", False, True), ("xla", "xla", False, True),
                                      ("flash+remat", "flash", True, True),
                                      ("plain_ce", "flash", False, False)):
        cfg = base.replace(precision="f32", dropout=0.0, attention=impl, remat=remat,
                           fused_ce=fused)
        trainer = Trainer(gpt2.make_task(cfg), cfg)
        leaves = {k: p.detach().requires_grad_() for k, p in trainer.state.params.items()}
        for c in counters.values():
            c.launches = 0
        loss, _, _ = trainer.task.loss_fn(
            trainer.policy.cast_compute(leaves), {}, trainer.put_batch(batch0),
            rng=rng.step_rng(rng.PRNGKey(cfg.seed + 1), 0), train=True)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        step0[label] = (float(loss.detach()), dict(zip(leaves, grads)),
                        {k: counters[k].launches for k in TRAIN_KERNELS})
        del trainer, leaves, loss, grads
        torch.cuda.empty_cache()

    def compare(a, b):
        (loss_a, g_a, _), (loss_b, g_b, _) = step0[a], step0[b]
        rel = abs(loss_a - loss_b) / abs(loss_b)
        name, worst = max(
            ((k, float((g_a[k] - g_b[k]).abs().max()) / max(float(g_b[k].abs().max()), 1e-30))
             for k in g_b), key=lambda kv: kv[1])
        log(f"train step 0, f32, dropout 0: loss {a} {loss_a:.7f} {b} {loss_b:.7f} (rel "
            f"{rel:.2e}, limit 1e-5); worst grad {name}: max|diff| / max|grad| {worst:.2e} "
            f"(limit 1e-3) over {len(g_b)} tensors; launches {a}: {step0[a][2]}")
        if not (np.isfinite(loss_a) and rel <= 1e-5 and worst <= 1e-3):
            fail(f"train step 0: the {a} step disagrees with the {b} step")

    compare("flash", "xla")
    compare("flash+remat", "flash")
    compare("flash", "plain_ce")
    layers = base.num_layers
    want = {"flash_fwd": layers, "flash_bwd_dkv": layers, "flash_bwd_dq": layers,
            "ce_fwd": 1, "ce_bwd": 1}
    if step0["flash"][2] != want:
        fail(f"train step 0: launches {step0['flash'][2]}, expected {want}")
    if step0["flash+remat"][2]["flash_fwd"] != 2 * layers:
        fail(f"train step 0 under remat: flash launches {step0['flash+remat'][2]}, "
             f"expected {2 * layers} forward")
    if step0["plain_ce"][2]["ce_fwd"] or step0["plain_ce"][2]["ce_bwd"]:
        fail(f"train step 0 with fused_ce=False launched the CE kernels: {step0['plain_ce'][2]}")
    del step0
    torch.cuda.empty_cache()

    # The slice: GPT-2 124M at the JAX defaults (bf16, dropout 0.1, batch
    # 16 x 1024, fused_ce=True) through fit, checkpointing every 10 steps.
    cfg = base.replace(workdir=workdir, checkpoint_every=10)
    trainer = Trainer(gpt2.make_task(cfg), cfg)
    data = lambda start: train_iterator(train_ds, cfg.global_batch_size, seed=cfg.seed,
                                        start_step=start)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    trainer.fit(data, num_steps=TRAIN_STEPS)
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train: losses not finite and falling over {len(hist)} steps: {losses}")
    if any(h["bad_step"] for h in hist):
        fail("train: the bad-step guard skipped a step")
    for name in TRAIN_KERNELS:
        per_step = base.num_layers if name.startswith("flash") else 1
        if launches[name] != per_step * TRAIN_STEPS:
            fail(f"train: {name} launched {launches[name]} times in {TRAIN_STEPS} steps, "
                 f"expected {per_step} per step")
    step_s = float(np.median([h["step_time_s"] for h in hist[1:]]))
    tokens = base.global_batch_size * base.seq_len
    flops = 6 * trainer.n_params * tokens
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    summary = dict(
        steps=TRAIN_STEPS, wall_s=wall, step_ms_p50=step_s * 1e3,
        first_step_ms=hist[0]["step_time_s"] * 1e3, tokens_per_s=tokens / step_s,
        mfu_6nd=flops / step_s / BF16_DENSE_PEAK, card=smi, loss_first=losses[0],
        loss_last=losses[-1], losses=losses,
        launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
        peak_mem_gib=peak_gib, peak_mem_gib_plain_ce_recorded=PLAIN_CE_PEAK_GIB, launches=launches,
    )
    log(f"train: {json.dumps(summary)}")
    log(f"train: peak memory {peak_gib:.2f} GiB with the fused cross-entropy against the "
        f"{PLAIN_CE_PEAK_GIB} GiB recorded with the plain one")
    lines = [json.loads(x) for x in open(os.path.join(workdir, "telemetry", "metrics.jsonl"))]
    kinds = [x["kind"] for x in lines]
    if kinds.count("window") != TRAIN_STEPS or kinds[-1] != "final" or \
            lines[-1]["exit_reason"] != "complete":
        fail(f"train: telemetry lines {kinds}")
    log(f"train: telemetry {len(lines)} lines ({kinds.count('window')} window, memory, final); "
        f"last window derived {json.dumps(lines[-2]['derived'])}")

    it = data(TRAIN_STEPS)
    batch = trainer.put_batch(next(it))

    def one_step():
        trainer.state, _ = trainer._train_step(trainer.state, batch)

    one_step()
    prof = device_split(torch, one_step)
    logits = torch.randn(tokens, base.vocab_size, device="cuda").to(torch.bfloat16).requires_grad_()
    labels = torch.randint(0, base.vocab_size, (tokens,), device="cuda")

    def ce_step(fused):
        def run():
            loss = ce.cross_entropy_per_example(logits, labels, fused=fused).mean()
            torch.autograd.grad(loss, (logits,))
        return run

    grads = {k: torch.full_like(p, 1e-3) for k, p in trainer.state.params.items()}
    prof["cross_entropy_fwd_bwd_ms"] = cuda_ms(torch, ce_step(True), iters=5)
    prof["cross_entropy_plain_fwd_bwd_ms"] = cuda_ms(torch, ce_step(False), iters=5)
    prof["optimizer_update_ms"] = cuda_ms(torch, lambda: trainer.state.apply_gradients(grads),
                                          iters=5)
    log(f"profile[train step] (ms; the fused and the plain cross-entropy and the optimizer "
        f"update timed on their own at the step's shapes): {json.dumps(prof)}")
    summary["profile"] = prof
    del trainer, logits, grads
    torch.cuda.empty_cache()
    return summary


def phase_resume(torch, smi: str, workdir: str, training: dict) -> None:
    """A fresh Trainer restores the step-10 checkpoint of the training
    run (copied into a workdir of its own) and trains to step 20. The
    save times are the training run's own saves: the host copy the step
    waits for (span ``checkpoint_save``) and the write on the thread
    (span ``checkpoint_write``)."""
    import shutil

    from tensorflow_examples_torch.data.memory import train_iterator
    from tensorflow_examples_torch.telemetry.spans import default_tracer
    from tensorflow_examples_torch.train.checkpoint import STATE_NAME, CheckpointManager
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import gpt2

    src = CheckpointManager(workdir)
    if src.all_steps() != [10, 20]:
        fail(f"resume: checkpoints {src.all_steps()} under the training workdir, expected [10, 20]")
    spans = {}
    for ev in default_tracer().chrome_trace()["traceEvents"]:
        if ev["name"] in ("checkpoint_save", "checkpoint_write"):
            spans.setdefault(ev["name"], {})[ev["args"]["step"]] = ev["dur"] / 1e6
    if any(sorted(spans.get(k, {})) != [10, 20] for k in ("checkpoint_save", "checkpoint_write")):
        fail(f"resume: checkpoint spans {spans}, expected a save and a write at steps 10 and 20")
    copy_s = [spans["checkpoint_save"][k] for k in (10, 20)]
    write_s = [spans["checkpoint_write"][k] for k in (10, 20)]
    ckpt_bytes = os.path.getsize(os.path.join(src.step_dir(10), STATE_NAME))
    resumed_dir = workdir + "-resumed"
    shutil.copytree(src.step_dir(10), os.path.join(resumed_dir, "checkpoints", "10"))
    cfg = gpt2.Gpt2Config(train_steps=TRAIN_STEPS, warmup_steps=5, log_every=1, eval_every=0,
                          telemetry_sinks="", workdir=resumed_dir, checkpoint_every=10)
    train_ds, _ = gpt2.datasets(cfg)
    trainer = Trainer(gpt2.make_task(cfg), cfg)
    t0 = time.perf_counter()
    restored = CheckpointManager(resumed_dir).restore_latest(trainer.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if restored is None or restored[1] != 10:
        fail(f"resume: restored {restored and restored[1]}, expected step 10")
    del restored
    trainer.fit(lambda start: train_iterator(train_ds, cfg.global_batch_size, seed=cfg.seed,
                                             start_step=start), num_steps=TRAIN_STEPS)
    ours = [h["loss"] for h in trainer.history]
    theirs = training["losses"][10:]
    if [h["step"] for h in trainer.history] != list(range(11, TRAIN_STEPS + 1)):
        fail(f"resume: stepped {[h['step'] for h in trainer.history]}, expected 11..20")
    rel = [abs(a - b) / abs(b) for a, b in zip(ours, theirs)]
    summary = dict(resumed_from=10, steps=len(ours), worst_rel_loss_diff=max(rel),
                   identical_steps=sum(a == b for a, b in zip(ours, theirs)),
                   checkpoint_bytes=ckpt_bytes, save_host_copy_s=copy_s, save_write_s=write_s,
                   restore_s=restore_s, card=smi)
    log(f"resume: {json.dumps(summary)}")
    if not max(rel) <= 1e-3:
        fail(f"resume: losses at steps 11-20 differ from the uninterrupted run's by "
             f"{max(rel):.3e} relative (limit 1e-3): {ours} vs {theirs}")
    del trainer
    torch.cuda.empty_cache()
    training["resume"] = summary


def phase_generate(torch, counters, workdir: str) -> dict:
    """Greedy decoding from the step-20 checkpoint, flash against xla."""
    from tensorflow_examples_torch import generate
    from tensorflow_examples_torch.models import transformer
    from tensorflow_examples_torch.workloads import gpt2

    cfg = gpt2.Gpt2Config(workdir=workdir, precision="f32", dropout=0.0)
    prompt = [int(t) for t in np.random.default_rng(3).integers(0, cfg.vocab_size, 64)]
    streams, launches, walls = {}, {}, {}
    for impl in ("flash", "xla"):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        toks, step = generate.generate_from_workdir(cfg.replace(attention=impl), prompt,
                                                    num_tokens=32, temperature=0.0, top_k=0)
        walls[impl] = time.perf_counter() - t0
        launches[impl] = counters["flash_decode"].launches
        if step != TRAIN_STEPS or toks[:64] != prompt or len(toks) != 96 or not all(
                0 <= t < cfg.vocab_size for t in toks):
            fail(f"generate[{impl}]: step {step}, malformed stream {toks}")
        streams[impl] = toks[64:]
    if launches["flash"] != 12 * 32 or launches["xla"]:
        fail(f"generate: flash-decode launches {launches}, expected 384 under flash, 0 under xla")
    verdict = "exact"
    for i, (a, b) in enumerate(zip(streams["flash"], streams["xla"])):
        if a != b:
            model, _ = generate.restore_model(gpt2.model_config(cfg), workdir)
            ids = torch.tensor([prompt + streams["xla"][:i]], device="cuda")
            logits = transformer.forward(gpt2.model_config(cfg.replace(attention="xla")), model,
                                         ids)[0, -1]
            top2 = torch.topk(logits.float(), 2).values
            gap = float(top2[0] - top2[1])
            verdict = ("tie", i, gap) if gap < NEAR_TIE else ("mismatch", i, gap)
            break
    summary = dict(checkpoint_step=TRAIN_STEPS, prompt_len=64, new_tokens=32, verdict=verdict,
                   flash_decode_launches=launches["flash"], wall_s=walls,
                   stream=streams["flash"][:8])
    log(f"generate: {json.dumps(summary)}")
    if verdict != "exact" and verdict[0] != "tie":
        fail(f"generate: the flash stream differs from the xla stream at token {verdict[1]} "
             f"(top-2 gap {verdict[2]})")
    return summary


def moe_config(gpt2, **kw):
    """``bench.py``'s ``moe_bench_config()`` at its TPU widths (GPT-2 124M
    widths, 8 experts, top-2 MoE in every 2nd block, batch 8 x 1024, bf16,
    dropout 0, flash attention, fused CE, the grouped dispatch), cut to
    ``TRAIN_STEPS`` steps with warmup 5 so the loss moves."""
    base = dict(global_batch_size=8, seq_len=1024, dropout=0.0, precision="bf16",
                attention="flash", fused_ce=True, moe_experts=8, moe_top_k=2, moe_every=2,
                moe_impl="grouped", train_steps=TRAIN_STEPS, warmup_steps=5, log_every=1,
                eval_every=0, checkpoint_every=0, telemetry_sinks="")
    base.update(kw)
    return gpt2.Gpt2Config(**base)


class plain_grouped_matmul:
    """Within the block, the grouped-matmul Function and the MoE bias
    gathers' backward run the plain versions (the kernels' comparison,
    never the main path)."""

    def __init__(self, gm):
        self.gm = gm

    def __enter__(self):
        self.saved = self.gm.gmm, self.gm.tgmm, self.gm.group_row_sum
        self.gm.gmm, self.gm.tgmm, self.gm.group_row_sum = (
            self.gm.gmm_plain, self.gm.tgmm_plain, self.gm.group_row_sum_plain)

    def __exit__(self, *exc):
        self.gm.gmm, self.gm.tgmm, self.gm.group_row_sum = self.saved


class pinned_routing:
    """Within the block, ``parallel/moe.py``'s router runs as usual and
    keeps each call's experts (``recorded`` None), or routes call i to
    the experts ``recorded[i]`` holds, with this run's own probabilities
    as the gates. Routing is discontinuous: two runs whose activations
    differ by f32 rounding (a kernel against a plain version) can pick
    different experts where two probabilities nearly tie, and that token
    then computes another function. Replaying one run's routing in the
    other compares the arithmetic alone; ``flips`` counts the decisions
    this run's router would have made otherwise and ``worst_gap`` is the
    largest probability gap among them, which must be a near-tie."""

    def __init__(self, moe, recorded=None):
        self.moe, self.recorded = moe, recorded
        self.calls, self.flips, self.worst_gap = [], 0, 0.0

    def __enter__(self):
        self.real = self.moe._router
        self.moe._router = self.route
        return self

    def __exit__(self, *exc):
        self.moe._router = self.real

    def route(self, tokens, gate_w, *, top_k, rng, jitter):
        import torch
        import torch.nn.functional as F

        gates, experts, moh0, mpr = self.real(tokens, gate_w, top_k=top_k, rng=rng,
                                              jitter=jitter)
        if self.recorded is None:
            self.calls.append(experts)
            return gates, experts, moh0, mpr
        want = self.recorded[len(self.calls)]
        self.calls.append(want)
        differ = torch.stack([a != b for a, b in zip(experts, want)]).any(dim=0)
        if not bool(differ.any()):
            return gates, experts, moh0, mpr
        probs = self.moe._router_probs(tokens, gate_w, rng=rng, jitter=jitter)
        own = torch.stack([probs.gather(-1, e[:, None])[:, 0] for e in experts])
        forced = torch.stack([probs.gather(-1, e[:, None])[:, 0] for e in want])
        self.flips += int(differ.sum())
        self.worst_gap = max(self.worst_gap, float((own - forced).abs()[:, differ].max()))
        gates = [probs.gather(-1, e[:, None])[:, 0] for e in want]
        if top_k > 1:
            denom = torch.clamp(sum(gates), min=1e-9)
            gates = [g / denom for g in gates]
        return gates, want, F.one_hot(want[0], gate_w.shape[-1]).float().mean(dim=0), mpr


def phase_moe_training(torch, counters, gm, smi: str, workdir: str) -> dict:
    from tensorflow_examples_torch.core import rng
    from tensorflow_examples_torch.data.memory import train_iterator
    from tensorflow_examples_torch.parallel import moe as moe_mod
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import gpt2

    base = moe_config(gpt2)
    train_ds, _ = gpt2.datasets(base)
    batch0 = next(train_iterator(train_ds, base.global_batch_size, seed=base.seed))
    n_moe = sum(i % base.moe_every == base.moe_every - 1 for i in range(base.num_layers))

    # Step 0 in f32 with the router jitter on (train=True, the step key):
    # the grouped kernels against the scatter formulation at capacity 8
    # (nothing drops, so both compute one function) and against the plain
    # gmm/tgmm/group_row_sum, each replaying the kernel run's routing
    # (pinned_routing). f32 takes the SIMT tgmm.
    step0, recorded = {}, None
    runs = (("grouped", "grouped", {}, False),
            ("scatter", "scatter", {"moe_capacity_factor": 8.0}, False),
            ("grouped_plain", "grouped", {}, True))
    for label, impl, overrides, plain in runs:
        cfg = base.replace(precision="f32", moe_impl=impl)
        trainer = Trainer(gpt2.make_task(cfg, **overrides), cfg)
        leaves = {k: p.detach().requires_grad_() for k, p in trainer.state.params.items()}
        for c in counters.values():
            c.launches = 0
        gm.tgmm.tensor_core_launches = gm.tgmm.simt_launches = 0
        with pinned_routing(moe_mod, recorded) as routing, \
                plain_grouped_matmul(gm) if plain else contextlib.nullcontext():
            loss, metrics, _ = trainer.task.loss_fn(
                trainer.policy.cast_compute(leaves), {}, trainer.put_batch(batch0),
                rng=rng.step_rng(rng.PRNGKey(cfg.seed + 1), 0), train=True)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        recorded = recorded or routing.calls
        step0[label] = (float(loss.detach()), dict(zip(leaves, grads)),
                        {**{k: counters[k].launches for k in MOE_KERNELS},
                         "tgmm_tensor_core": gm.tgmm.tensor_core_launches,
                         "tgmm_simt": gm.tgmm.simt_launches},
                        {k: float(v.detach()) for k, v in metrics.items()},
                        (routing.flips, routing.worst_gap))
        del trainer, leaves, loss, grads, metrics
        torch.cuda.empty_cache()

    def compare(a, b):
        (loss_a, g_a, launches_a, m_a, _), (loss_b, g_b, _, m_b, (flips, gap)) = step0[a], step0[b]
        rel = abs(loss_a - loss_b) / abs(loss_b)
        name, worst = max(
            ((k, float((g_a[k] - g_b[k]).abs().max()) / max(float(g_b[k].abs().max()), 1e-30))
             for k in g_b), key=lambda kv: kv[1])
        log(f"moe step 0, f32, router jitter on: loss {a} {loss_a:.7f} {b} {loss_b:.7f} (rel "
            f"{rel:.2e}, limit 1e-5); moe_aux {m_a['moe_aux']:.6f} / {m_b['moe_aux']:.6f}, "
            f"moe_drop {m_a['moe_drop']} / {m_b['moe_drop']}; worst grad {name}: max|diff| / "
            f"max|grad| {worst:.2e} (limit 1e-3) over {len(g_b)} tensors; {b} replayed {a}'s "
            f"routing: its own router differed in {flips} (token, rank) decisions, largest "
            f"probability gap {gap:.2e} (near-tie limit {NEAR_TIE}); launches {a}: {launches_a}")
        if not (np.isfinite(loss_a) and rel <= 1e-5 and worst <= 1e-3 and gap < NEAR_TIE):
            fail(f"moe step 0: the {a} step disagrees with the {b} step")
        return dict(loss=[loss_a, loss_b], rel=rel, worst_grad=name, worst_grad_rel=worst,
                    routing_flips=flips, flip_gap=gap)

    checks = {"grouped_vs_scatter": compare("grouped", "scatter"),
              "grouped_vs_plain": compare("grouped", "grouped_plain")}
    want = {"gmm": 4 * n_moe, "tgmm": 2 * n_moe, "group_row_sum": 2 * n_moe,
            "tgmm_tensor_core": 0, "tgmm_simt": 2 * n_moe}
    if step0["grouped"][2] != want:
        fail(f"moe step 0: launches {step0['grouped'][2]}, expected {want}")
    if any(step0[k][2][n] for k in ("scatter", "grouped_plain") for n in MOE_KERNELS):
        fail(f"moe step 0: scatter / plain runs launched the kernels: "
             f"{step0['scatter'][2]} {step0['grouped_plain'][2]}")
    if step0["scatter"][3]["moe_drop"] != 0.0 or step0["grouped"][3]["moe_drop"] != 0.0:
        fail("moe step 0: tokens dropped at capacity factor 8")
    del step0
    torch.cuda.empty_cache()

    # The slice: moe_bench_config() through fit, saving the final state.
    cfg = base.replace(workdir=workdir)
    trainer = Trainer(gpt2.make_task(cfg), cfg)
    data = lambda start: train_iterator(train_ds, cfg.global_batch_size, seed=cfg.seed,
                                        start_step=start)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    gm.gmm.tensor_core_launches = gm.gmm.simt_launches = 0
    gm.tgmm.tensor_core_launches = gm.tgmm.simt_launches = 0
    t0 = time.perf_counter()
    trainer.fit(data, num_steps=TRAIN_STEPS)
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    launches["gmm_tensor_core"] = gm.gmm.tensor_core_launches
    launches["gmm_simt"] = gm.gmm.simt_launches
    launches["tgmm_tensor_core"] = gm.tgmm.tensor_core_launches
    launches["tgmm_simt"] = gm.tgmm.simt_launches
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"moe train: losses not finite and falling over {len(hist)} steps: {losses}")
    if any(h["moe_drop"] != 0.0 or not np.isfinite(h["moe_aux"]) or h["bad_step"] for h in hist):
        fail(f"moe train: moe_drop / moe_aux / bad_step per step: "
             f"{[(h['moe_drop'], h['moe_aux'], h['bad_step']) for h in hist]}")
    for name, per_step in (("gmm", 4 * n_moe), ("gmm_tensor_core", 4 * n_moe), ("gmm_simt", 0),
                           ("tgmm", 2 * n_moe), ("tgmm_tensor_core", 2 * n_moe), ("tgmm_simt", 0),
                           ("group_row_sum", 2 * n_moe), ("flash_fwd", base.num_layers),
                           ("ce_fwd", 1), ("ce_bwd", 1)):
        if launches[name] != per_step * TRAIN_STEPS:
            fail(f"moe train: {name} launched {launches[name]} times in {TRAIN_STEPS} steps, "
                 f"expected {per_step} per step")
    step_s = float(np.median([h["step_time_s"] for h in hist[1:]]))
    tokens = base.global_batch_size * base.seq_len
    summary = dict(
        steps=TRAIN_STEPS, wall_s=wall, step_ms_p50=step_s * 1e3,
        first_step_ms=hist[0]["step_time_s"] * 1e3, tokens_per_s=tokens / step_s, card=smi,
        n_params=trainer.n_params, moe_layers=n_moe, loss_first=losses[0], loss_last=losses[-1],
        losses=losses, moe_aux=[h["moe_aux"] for h in hist],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()}, launches=launches,
        step0=checks,
    )
    log(f"moe train: {json.dumps(summary)}")
    batch = trainer.put_batch(next(data(TRAIN_STEPS)))

    def one_step():
        trainer.state, _ = trainer._train_step(trainer.state, batch)

    one_step()
    prof = device_split(torch, one_step)
    log(f"profile[moe train step] (ms): {json.dumps(prof)}")
    if prof["indexing_backward_ms"] > 0:
        fail(f"moe train: the profiled step ran indexing_backward_kernel for "
             f"{prof['indexing_backward_ms']:.3f} ms: a row gather's backward left the "
             "segmented sum")
    summary["profile"] = prof
    del trainer
    torch.cuda.empty_cache()
    return summary


def phase_moe_generate(torch, counters, gm, workdir: str) -> dict:
    """Greedy decoding of the MoE model through a checkpoint of its
    initial parameters from seed MOE_GENERATE_SEED (saved under
    ``workdir`` as step 0), the grouped kernels against the plain gmm.
    The state is chosen for the stream's diversity: the 20-step state and
    the init from the training run's seed 42 decode to one or two tokens
    repeated, fixed points that would make "streams identical" say
    little. The stream must hold at least MIN_DISTINCT distinct tokens
    in 32."""
    import types

    from tensorflow_examples_torch import generate
    from tensorflow_examples_torch.models import transformer
    from tensorflow_examples_torch.parallel import moe as moe_mod
    from tensorflow_examples_torch.train.checkpoint import CheckpointManager
    from tensorflow_examples_torch.workloads import gpt2

    cfg = moe_config(gpt2, workdir=workdir, precision="f32")
    init = transformer.GPT2(gpt2.model_config(cfg), seed=MOE_GENERATE_SEED)
    state = types.SimpleNamespace(step=0, params=dict(init.named_parameters()), opt_state={},
                                  model_state={})
    with CheckpointManager(workdir) as ckpt:
        ckpt.save(0, state)
    del init, state
    n_moe = sum(i % cfg.moe_every == cfg.moe_every - 1 for i in range(cfg.num_layers))
    prompt = [int(t) for t in np.random.default_rng(5).integers(0, cfg.vocab_size, 64)]
    streams, launches, recorded = {}, {}, None
    for label in ("kernels", "plain"):
        for c in counters.values():
            c.launches = 0
        # The plain run replays the kernel run's routing (see pinned_routing).
        with pinned_routing(moe_mod, recorded) as routing, \
                plain_grouped_matmul(gm) if label == "plain" else contextlib.nullcontext():
            toks, step = generate.generate_from_workdir(cfg, prompt, num_tokens=32,
                                                        temperature=0.0, top_k=0)
        recorded = recorded or routing.calls
        launches[label] = {k: counters[k].launches for k in MOE_KERNELS}
        if step != 0 or toks[:64] != prompt or len(toks) != 96 or not all(
                0 <= t < cfg.vocab_size for t in toks):
            fail(f"moe generate[{label}]: step {step}, malformed stream {toks}")
        streams[label] = toks[64:]
    if launches["kernels"] != {"gmm": 2 * n_moe * 32, "tgmm": 0, "group_row_sum": 0} or any(
            launches["plain"].values()):
        fail(f"moe generate: launches {launches}, expected {2 * n_moe * 32} gmm with the kernels, "
             "none with the plain versions")
    verdict = "exact"
    for i, (a, b) in enumerate(zip(streams["kernels"], streams["plain"])):
        if a != b:
            model, _ = generate.restore_model(gpt2.model_config(cfg), workdir)
            ids = torch.tensor([prompt + streams["plain"][:i]], device="cuda")
            with plain_grouped_matmul(gm), torch.no_grad():
                logits = transformer.forward(gpt2.model_config(cfg), model, ids)[0, -1]
            top2 = torch.topk(logits.float(), 2).values
            gap = float(top2[0] - top2[1])
            verdict = ("tie", i, gap) if gap < NEAR_TIE else ("mismatch", i, gap)
            break
    # Also hold the logits of the whole 96-token sequence, kernels against
    # plain (routing pinned), to the f32 kernel criterion.
    model, _ = generate.restore_model(gpt2.model_config(cfg), workdir)
    ids = torch.tensor([prompt + streams["kernels"]], device="cuda")
    logits, recorded = {}, None
    for label in ("kernels", "plain"):
        with pinned_routing(moe_mod, recorded) as seq_routing, torch.no_grad(), \
                plain_grouped_matmul(gm) if label == "plain" else contextlib.nullcontext():
            logits[label] = transformer.forward(gpt2.model_config(cfg), model, ids)[0]
        recorded = recorded or seq_routing.calls
    logit_err = float((logits["kernels"] - logits["plain"]).abs().max())
    logit_max = float(logits["plain"].abs().max())
    del model, logits
    torch.cuda.empty_cache()
    distinct = len(set(streams["kernels"]))
    summary = dict(checkpoint_step=0, prompt_len=64, new_tokens=32, verdict=verdict,
                   distinct_tokens=distinct, launches=launches, stream=streams["kernels"],
                   plain_routing_flips=routing.flips + seq_routing.flips,
                   flip_gap=max(routing.worst_gap, seq_routing.worst_gap),
                   sequence_logits_max_abs_err=logit_err, sequence_logits_max=logit_max)
    log(f"moe generate: {json.dumps(summary)}")
    if distinct < MIN_DISTINCT:
        fail(f"moe generate: the stream holds {distinct} distinct tokens in 32, under "
             f"{MIN_DISTINCT}: comparing it proves little")
    if summary["flip_gap"] >= NEAR_TIE:
        fail(f"moe generate: a routing decision of the plain run differed at a probability gap "
             f"of {summary['flip_gap']:.2e}, not a near-tie")
    if not logit_err <= 1e-4 * logit_max:
        fail(f"moe generate: sequence logits differ by {logit_err:.3e}, over 1e-4 of their "
             f"max {logit_max:.3e}")
    if verdict != "exact" and verdict[0] != "tie":
        fail(f"moe generate: the kernels' stream differs from the plain one at token "
             f"{verdict[1]} (top-2 gap {verdict[2]})")
    return summary


# ---------------------------------------------------------------- phase 5


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

    smi = phase_device(torch)
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "tensorflow_examples_torch")):
        fail("run from a checkout: tensorflow_examples_torch/ is not beside this script")
    sys.path.insert(0, here)
    from tensorflow_examples_torch.core import precision
    from tensorflow_examples_torch.models import transformer
    from tensorflow_examples_torch.ops import (
        _build, attention, cross_entropy, decode, grouped_matmul, paged_decode)

    phase_build(_build)
    rows = phase_kernels(torch, decode, paged_decode, precision)
    rows.update(phase_flash_kernels(torch, attention))
    rows.update(phase_ce_kernels(torch, cross_entropy))
    rows.update(phase_moe_kernels(torch, grouped_matmul))
    for name, errs in phase_head_dim_sweep(torch, attention, decode, paged_decode,
                                           precision).items():
        rows[name]["head_dim_sweep_max_abs_err"] = errs

    counters = {"flash_decode": decode.flash_decode_attention,
                "paged_decode": paged_decode.paged_decode_attention,
                "flash_fwd": attention.flash_fwd,
                "flash_bwd_dkv": attention.flash_bwd_dkv,
                "flash_bwd_dq": attention.flash_bwd_dq,
                "ce_fwd": cross_entropy.ce_fwd,
                "ce_bwd": cross_entropy.ce_bwd,
                "gmm": grouped_matmul.gmm,
                "tgmm": grouped_matmul.tgmm,
                "group_row_sum": grouped_matmul.group_row_sum}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        workdir = os.path.join(tmp, "run")
        training = phase_training(torch, counters, smi, workdir)
        phase_resume(torch, smi, workdir, training)
        phase_generate(torch, counters, workdir)
        moe = phase_moe_training(torch, counters, grouped_matmul, smi, os.path.join(tmp, "moe"))
        phase_moe_generate(torch, counters, grouped_matmul, os.path.join(tmp, "moe-init"))

    model_cfg = transformer.gpt2_124m()
    t0 = time.perf_counter()
    model = transformer.GPT2(model_cfg, seed=0).to("cuda")
    log(f"model: GPT-2 124M, {sum(p.numel() for p in model.parameters())} params, "
        f"random init seed 0, f32, built in {time.perf_counter() - t0:.3f} s")
    summaries = phase_serving(torch, model, model_cfg, counters)

    rows["gmm"]["tensor_core_launches"] = moe["launches"]["gmm_tensor_core"]
    rows["tgmm"]["tensor_core_launches"] = moe["launches"]["tgmm_tensor_core"]
    # Not the port of a TPU kernel (the MoE bias gathers' backward): its own line.
    log(json.dumps({"group_row_sum": {
        "route": "cuda", "source": GMM_SOURCE,
        "replaces": "PyTorch's indexing backward of b_in[srt_eid] / b_out[srt_eid] "
                    "(tensorflow_examples_torch/parallel/moe.py, the port of "
                    "tensorflow_examples_tpu/parallel/moe.py:374-377 jnp.take)",
        "launches": moe["launches"]["group_row_sum"], **rows.pop("group_row_sum")}}))
    kernels = []
    for name, source, replaces, launches in (
        ("flash_decode", FLASH_SOURCE, "tensorflow_examples_tpu/ops/decode.py:78",
         sum(s["launches"]["flash_decode"] for s in summaries)),
        ("paged_decode", PAGED_SOURCE, "tensorflow_examples_tpu/ops/paged_decode.py:61",
         sum(s["launches"]["paged_decode"] for s in summaries)),
        ("flash_fwd", ATTN_SOURCE, "tensorflow_examples_tpu/ops/attention.py:82",
         training["launches"]["flash_fwd"]),
        ("flash_bwd_dkv", ATTN_SOURCE, "tensorflow_examples_tpu/ops/attention.py:199",
         training["launches"]["flash_bwd_dkv"]),
        ("flash_bwd_dq", ATTN_SOURCE, "tensorflow_examples_tpu/ops/attention.py:269",
         training["launches"]["flash_bwd_dq"]),
        ("ce_fwd", CE_SOURCE, "tensorflow_examples_tpu/ops/cross_entropy.py:49",
         training["launches"]["ce_fwd"]),
        ("ce_bwd", CE_SOURCE, "tensorflow_examples_tpu/ops/cross_entropy.py:83",
         training["launches"]["ce_bwd"]),
        ("gmm", GMM_SOURCE, GMM_REPLACES.format(526), moe["launches"]["gmm"]),
        ("tgmm", GMM_SOURCE, GMM_REPLACES.format(763), moe["launches"]["tgmm"]),
    ):
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **{k: row[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
            **{k: row[k] for k in ("float32", "sdpa_fwd_bwd_ms", "library_fwd_bwd_ms", "library",
                                   "all_shapes", "worst_abs_err_all_cases", "design",
                                   "head_dim_sweep_max_abs_err", "tensor_core_launches")
               if k in row},
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
