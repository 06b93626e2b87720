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
   (flash-decode: B=1, H=12, D=64, q_len=length in {16, 128, 512, 1024}
   timed and 100 unaligned, plus generate's q_len=1 step over 300 rows
   of a 1024-row cache whose tail is NaN, f32 and bf16, each launch's
   route and split read from its counters and held to ``decode_plan``,
   each case rerun on the same inputs for the same bits; paged decode:
   S=8, H=12, BS=16, nb=64 with ragged lengths and with every slot at
   1024 rows, fp32 and int8, the rows past each length NaN, 8 splits,
   rerun bit-identical; the three
   training flash kernels at the GPT-2 step's shape, B=16, H=12, S=1024,
   D=64, causal, bf16 and f32, plus seq_q < seq_kv, a length that is not
   a tile multiple, a key bias with masked keys and a nonzero lse
   cotangent, each launch's variant read from its counters (bf16 on the
   tensor cores, f32 SIMT) and each tensor-core kernel rerun on the same
   inputs for the same bits; the fused cross-entropy forward and backward at the
   step's logits, N=16384 x V=50257, bf16 and f32, plus V 4099 and 1000,
   N=1, labels -1 and V, a row of all -1e30 and a non-unit cotangent,
   with ``torch.nn.functional.cross_entropy`` timed as a yardstick only;
   every attention kernel (flash forward, dK/dV, dQ, flash-decode, paged
   decode) at head_dim 8, 16, 32 and 128 against its plain version at
   batch 2 with the head_dim-64 tolerances, the flash and flash-decode
   kernels' variants held to the rule (tensor cores in bf16 from head_dim
   16), both decode kernels on their split routes;
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
   a yardstick only); and the three training flash kernels again at
   BERT-base GLUE's attention, B=32, H=12, S=128, D=64, non-causal, with
   an f32 key bias from padding lengths drawn in [8, 128] and with no
   padding, bf16 on the tensor cores and f32 SIMT, each held to its plain
   version at the flash tolerances and rerun for the same bits, timed on
   the ragged batch beside SDPA given the same additive mask;
4. training: GPT-2 124M at full width on synthetic bigram data through
   ``Trainer.fit`` (bf16 compute, dropout 0.1, batch 16 x 1024, 20 steps,
   warmup cut to 5 steps so the loss can move, the fused cross-entropy
   kernels at ``fused_ce=True``, checkpoints every 10 steps into a
   temporary workdir), after the step's loss and every gradient at step
   0 with the flash kernels are held to the plain attention path and
   with the fused cross-entropy to the plain one (f32, dropout 0); step
   time, tokens/s, MFU, peak memory, the loss falling, launches per step
   (every flash launch of the bf16 steps on the tensor cores, step 0's
   f32 ones SIMT, and twice the forward launches under remat at step 0),
   and one profiled step's device time split into flash kernels (forward,
   dK/dV, dQ), matmuls, the rest and idle (cross-entropy and the
   optimizer update timed on their own);
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
   launches a step, all on the tensor cores, 12 of each flash kernel, all
   on the tensor cores (12 SIMT each at the f32 step 0), and 12
   ``group_row_sum``,
   step time, tokens/s, peak memory and one profiled step, which must
   run no ``indexing_backward_kernel``;
4d. MoE generate: 32 greedy tokens from a step-0 checkpoint of the MoE
   model's initial parameters from seed 0 (the 20-step state decodes to
   one token repeated) through ``tensorflow_examples_torch.generate``
   (f32), the grouped kernels against the plain gmm, the stream needing
   at least 8 distinct tokens, the two streams held to each other, and
   the logits of the whole sequence held within 1e-4 of their max;
5. serving: GPT-2 124M at full width, random weights from seed 0, f32,
   through ``ContinuousBatcher`` + ``ServingFrontend`` over real HTTP, 8
   concurrent greedy requests each, in seven engine configurations: dense
   pool with ``attention="flash"``; paged pool, block 16,
   ``attention="paged_flash"``; the same with int8 KV; and, each warmed
   before traffic (every rung run once, each decode and verify rung
   captured as a CUDA graph) and serving prompts that repeat a motif, 32
   new tokens each: paged_flash with int8 KV, ``spec_decode_k=4`` and
   ``prefill_chunk_tokens=64``; dense flash with ``spec_decode_k=4``;
   int8 weights; fp8 weights with fp8 KV (paged, block 16), the last two
   under ``attention="xla"``. Every stream is checked against the
   engine's own cacheless ``reference_generate`` on the card (quantized
   weights: the same dequantized weights; a quantized KV cache: first
   token exact, >= 75% agreement), the kernels' launch counters read
   around the served requests (a replayed graph adds its capture's
   tally), ``post_warmup_recompiles()`` 0 and drafts accepted where
   speculation is on; the warmed configurations are served again by an
   eager engine of the same config (``cuda_graphs=False``) for tokens/s
   and host wall per decode step with graphs and without; each
   configuration's profiled decode steps hold the paged kernel's
   replay-counted launches to the profiler's count;
5a. train_config: the rest of the training config at the full
   ``Gpt2Config`` widths and defaults (bf16, batch 16 x 1024, fused CE,
   dropout 0.1 unless a check says 0), cut to ``TRAIN_CONFIG_LAYERS``
   layers: (a) 8 steps as 2 launches of
   ``steps_per_launch=4`` (one CUDA graph of 4 steps) against 8 eager
   steps at dropout 0 in f32, final params within 1e-5 relative (and
   whether bitwise), the flash and CE kernels counted from the eager
   warm-up and the replays' tally; (b) at dropout 0.1 the graph's window
   losses against the eager steps' (so the 4 steps of a launch drew the
   eager masks), the graph's generators staged for the 4 steps of a
   launch drawing 4 different uniforms, the first the eager step's, and
   a resume at a bundle boundary against the uninterrupted run, within
   1e-5 relative; (c) the host
   wall per step over 8-step fit windows and one profiled launch's idle
   share, k = 1 and k = 4 alternated, 3 windows each (measurements, no
   claim); (d) ``remat_policy`` none / dots / dots_no_batch against no
   remat, step-0 loss and every gradient within 1e-5 (f32), the
   dispatcher ops each policy saved in a forward, and each variant's
   peak memory over a bf16 step; (e) ``pretrained=`` from a
   directory the phase writes (the seed-0 params under HF names,
   ``model.safetensors`` + ``config.json``), step-0 loss equal to the
   seed params'; (f) ``badbatch@3`` with ``max_skipped_batches=1`` skips
   and counts one batch; (g) a 2-step profiler window's trace names
   ``flash_fwd_mma_kernel`` and the CE kernels; (h) ``debug_nans`` with
   ``nan@2`` raises ``FloatingPointError``;
5b. replica: the serving replica process, GPT-2 124M at full width and
   depth (seed 0, f32), three warmed stacks (engine, batcher, frontend)
   on loopback ports, ``mixed``, ``prefill`` and ``decode``, paged with
   block 16 and the prefix cache, driven over HTTP only, in three rounds
   with the stacks rebuilt: f32 and int8 KV under ``attention=
   "paged_flash"``, fp8 KV under ``"flash"`` (its decode on the gather
   path). Prompts of 17, 100 and 700 tokens, greedy and sampled
   (``temperature=0.8, top_k=40``): ``/prefill`` on the prefill stack,
   its ``pages`` and ``first_token`` to ``/resume`` on the decode stack,
   tokens equal to ``/generate`` on the mixed stack; each cold prefill
   launched flash-decode once a layer, and each decode step on imported
   pages the paged kernel once a layer (f32, int8). Also: f32 pages into
   an int8 or fp8 stack and into a block-32 stack answer 400 with the
   geometry message; the delta hand-off (two prompts sharing 256 tokens,
   the second's prefill skipping what the decode stack's ``/health``
   digest covers: 16 blocks off the wire, tokens still equal); SLO
   classes (8 batch requests fill the mixed stack, 4 interactive ones
   preempt, every batch stream equals its solo run); brownout (a burst on
   a ``brownout=True``, ``brownout_queue_hi=4`` stack raises the level,
   batch gets 503 ``shed`` while interactive gets 200, the level clears);
   ``post_warmup_recompiles`` 0 on every stack; and the serving CLI as a
   process (2 layers at full width, ``--stats_every 0.5``): SIGTERM with
   two requests in flight, both 200, exit 0, schema-14 lines in
   ``serving.jsonl``. Timing lines, not claims: the 700-token prompt's
   export + encode and decode + import ms, payload bytes a prompt token
   for f32, int8 and fp8, and the hand-off's TTFT against the mixed
   stack's;
5c. bert_glue: BERT-base at the ``BertGlueConfig`` defaults with
   ``attention="flash"`` (bf16, dropout 0.1, batch 32 x 128, synthetic
   SST-2, warmup cut to 2): step 0 at f32 and dropout 0.1 with the flash
   kernels (12 SIMT launches of each) held to the plain attention, loss
   within 1e-5 relative and every gradient within 1e-3 of its largest;
   20 steps through ``train.cli`` checkpointing at 10 and 20 (12 launches
   of each flash kernel a step and 12 forward an eval batch, all on the
   tensor cores), ``train.eval`` on its workdir giving the run's final
   eval; a fresh ``Trainer`` resumed from the step-10 checkpoint, losses
   11-20 within 1e-3 relative; one profiled step; CoLA (MCC) and STS-B
   (Pearson, the regression head) 4 steps and eval each;
5d. cifar10: ResNet-20 at the ``Cifar10Config`` defaults (bf16, batch 128,
   augment) on CIFAR-10 python-pickle batches of seeded uint8 pixels at
   the real size, which the phase writes, so ``load_cifar10`` keeps uint8
   and the native library crops, flips and normalizes: 20 steps through
   ``train.cli``, ``train.eval`` on its workdir, every running statistic
   moved off its init; 4 steps as one launch of ``steps_per_launch=4``
   (one CUDA graph) against 4 eager steps with cuDNN deterministic,
   params and ``batch_stats`` within 1e-5 relative; one profiled step;
5e. mnist: the MLP at the ``MnistConfig`` defaults, 20 steps through
   ``train.cli``, ``train.eval``, one profiled step. Each of 5c-5e prints
   p50 step ms, examples/s and peak memory beside the card's name and
   power limit;
5g. imagenet: ResNet-50 at the ``ImagenetConfig`` defaults (224 px, 1000
   classes, bf16, SGD with Nesterov momentum under warmup-cosine, label
   smoothing 0.1) cut to batch 256 (``bench.py:762``'s batch a chip), 10
   steps with warmup 5 and 2 synthetic eval batches, on the synthetic
   stream: (a) 10 steps through ``train.cli``, finite losses, every
   running statistic moved, no port kernel launched, p50 step ms,
   examples/s, peak memory, one profiled step, and the step p50 of a fit
   over one host batch repeated (the input off the critical path);
   (c) the run's final eval and ``train.eval`` from its checkpoint give
   the same accuracy, top-5 and loss, the eval weight every row;
   (d) 4 steps with ``--optimizer lars``, finite loss, parameters moved;
   (e) the ``kind="memory"`` line's params, optimizer and model-state
   bytes equal ``tree_bytes`` of the state, the final line's peak within
   5% of ``torch.cuda.max_memory_allocated``, and one fitted step in a
   process of its own at batch 1024 (its peak, or its OOM and report:
   printed) and at 4096, which must end in ``torch.OutOfMemoryError``
   with the OOM report (live tensors, breakdown, allocator) in its log
   before the traceback; (f) during (a), ``--metrics_port``'s
   ``/metrics`` parses as Prometheus text and carries
   ``memory_peak_live_bytes``, ``/health`` answers 200; then the
   TFRecord path, the port's JPEG decoder (``data/csrc/jpeg.cpp``, built
   here with g++, no libjpeg) over shards of the 64 fixture JPEGs
   repeated to a shard of 320 records by ``data/sources.write_tfrecord``,
   copied to 4 train shards (5 batches of 256 an epoch) and a validation
   shard: (b) the stage's images/s on one thread, two epochs through 8
   decode workers equal to the inline decode bit for bit, the pipeline's
   images/s at 1 and 8 workers after its first batch, and inline; 10
   steps through ``train.cli`` fed by 8
   workers (cuDNN deterministic), checkpointing at 7, two steps profiled:
   step p50, ``data_fetch``, ``data_wait`` and ``data_work`` p50 from the
   run's trace, the card's idle share over the profiled window; a fresh
   run resumed from the step-7 checkpoint gives steps 8-10's losses and
   the final params bitwise; (c') its final eval and ``train.eval`` over
   the padded validation shard agree, the pad rows under mask 0, the
   eval weight 320; (g) the recipe's batch 1024 as ``grad_accum_steps``
   4 at 256 for 2 applied updates: finite losses, every running
   statistic moved, peak memory and micro-step p50 beside (e)'s
   one-step probe at 1024;
5f. fleet: the fleet's control plane over GPT-2 124M at full width and
   depth (seed 0, f32, ``paged_flash``, block 16, 8 slots, warmed), only
   through the port's router: (a) two mixed stacks behind
   ``RouterFrontend``, prompts of 17, 100 and 700 tokens greedy and
   sampled, two sharing a 256-token prefix, 8 batch and 4 interactive
   requests together, 32 new tokens each: every routed stream equals the
   same request sent straight to a replica, the repeated prefix lands on
   the replica holding it (an affinity hit, prefix hits on its
   ``/health``), and the kernels' launches over the routed requests are
   counted; (b) a prefill and a decode stack behind another router: each
   ``/generate`` becomes ``/prefill`` -> ``/resume``, the repeated prefix
   travels as a delta, the tokens equal the mixed stack's, and the
   hand-off TTFT through the router is printed beside the mixed one;
   (c) every kept trace of both routers, read back by ``read_traces``, is
   one tree over the router's and the replicas' spans, and each router's
   serving line passes ``validate_line`` with the v12-v14 keys; (d) a
   ``ChaosFleet`` of two stacks: ``crash@1:6`` kills a replica
   mid-stream, every request completes with its direct tokens, and the
   supervisor restarts the replica in this process (its rungs captured
   as CUDA graphs) while the other runs decode steps for live traffic,
   then readmits it on a green ``/health``; (e) a ``RouterPair`` over them:
   ``killrouter@3`` kills the primary mid-stream, the standby promotes
   from the journal, clients retrying with their ``request_id`` get the
   same tokens, a duplicate is deduplicated, ``resume_from`` returns the
   tail, and ``takeover_latency_s`` is printed; (f) a canary prober and a
   strict SLO config: ``slowrep@1:0.05`` on replica 1, replica 0 drained
   for a burst of 12 requests, makes the e2e burn-rate rule fire, the alert is read back by ``read_alerts`` and the router's line
   carries ``alerts_firing``, ``error_budget_remaining`` and
   ``probe_success_rate``, and ``python -m
   tensorflow_examples_torch.slo_watch URL --once`` exits 1 while the
   alert fires and 0 after it clears (the alert engine's clock moved
   past its windows and ``resolve_after_s``); (g) ``python -m
   tensorflow_examples_torch.serve_fleet`` spawning two supervised
   ``python -m tensorflow_examples_torch.serve`` processes (2 layers):
   one is ``kill -9``'d, restarted and readmitted, the tokens unchanged,
   and SIGTERM drains the CLI to exit 0;
5i. sharded serving: GPT-2 124M at full width and depth (seed 0, f32,
   TF32 off) served on ``{model: 2}`` by two ranks sharing the card
   (``run_world(device="cuda")``: gloo, the psums staged through pinned
   host memory, so every rung eager), each rank holding 6 of the 12 heads
   of qkv, proj and the KV pool and half of the MLP, rank 0 leading
   through ``serving/mesh_driver.py`` and rank 1 replaying its calls, in
   ``dense_flash``, ``paged_flash`` and ``paged_flash_int8`` (8 slots,
   block 16): 8 greedy requests through the batcher, every stream equal to
   the one-rank eager engine's on the same weights (a near-tie allowed),
   one 100-token prefill's logits within 1e-4 of one rank's, the ranks'
   pool host state equal, 6 heads a rank, no recompile after warmup, each
   rank's launches of rows 6 and 7 counted (12 flash-decode a prefill, 12
   paged a decode step), the decode step's host wall, device time and psum
   share a rank against the one-rank engine's; rows 6 and 7 at a rank's
   shape (H 6: flash-decode at q_len 512, paged decode S 8 ragged and
   full, fp32 and int8) against their plain versions; ``paged_flash``
   again on ``{fsdp: 2}`` (12 heads a rank, every fsdp-cut weight
   gathered through the host at each use), held to one rank the same way,
   unwarmed (each step gathers every weight), with the decode step's
   gather share; the KV-page hand-off each way
   between ``{model: 2}`` and one rank in ``paged_flash`` f32 and int8
   (a sharded prefill engine exports the 8 requests, its heads gathered
   over ``model``, and a one-rank decode engine imports and decodes them;
   a one-rank prefill engine's pages go to a sharded decode engine, each
   rank sent its heads): the sharded pages within 1e-4 of one rank's
   (int8 within one level), every stream held to the one-rank mixed
   engine's, 12 flash-decode launches a prefill and 12 paged a decode
   step on each rank, and the export and import host ms (rank 0 against
   one rank) and payload MB printed; and the serve CLI
   under ``torchrun --nproc_per_node 2`` on a ``{model: 2}`` workdir (2
   layers): ``/health`` carries the mesh and the digest, a ``/generate``
   equals a one-rank engine's tokens, SIGTERM drains rank 0 and both
   ranks exit 0;
5h. mesh, the last phase: GPT-2 at 124M widths cut to 2 layers (batch 16 x 1024) on
   worlds of ranks sharing the one card (``torch.distributed`` over gloo,
   every collective staged through pinned host memory): a world of 2
   runs ``{data: 2}``, ``{data: 2}`` with ZeRO-1, ``{fsdp: 2}``,
   ``{model: 2}`` with ``tp_vocab``, ``{context: 2}`` over the zigzag
   ring and over Ulysses: each layout's 4-step f32 trajectory (dropout 0) within rtol 3e-3 of
   the one-rank run of the same config, ZeRO-1 within 1e-6 of ``{data:
   2}`` with fewer optimizer bytes a rank, the ranks' losses equal, the
   second of 2 bf16 steps timed per rank, and the launches of flash forward, dK/dV, dQ and
   the CE forward and backward counted on every rank (each launched on
   every rank); ``train.cli`` under torchrun on ``{data: 2}``, its
   checkpoint restored on ``{model: 2}`` and gathered back bit for bit,
   and a torchrun resume on ``{model: 2}`` from that step. Pipeline and
   expert parallelism: the world of 2 also runs ``{pipe: 2}`` under 1F1B
   and under GPipe, and at 4 layers plain 1F1B and interleaved 1F1B
   (``pipe_interleave`` 2, held to plain 1F1B at rtol 1e-5); the world of
   4 runs ``{data: 2, pipe: 2}``, ``{model: 2, pipe: 2}`` (flash, heads
   split inside the stages) and ``{data: 2, model: 2}`` with 8 experts
   (expert parallelism, capacity factor 4: no token drops), the last
   against the one-rank MoE run with its routing replayed on each rank's
   tokens (``pinned_routing``, the router without jitter in both runs, a
   flipped decision allowed only at a near-tie); the flash and CE
   launches of each pipeline layout are held to its schedule's count
   rank by rank; ``train.cli`` under torchrun on ``{data: 1, pipe: 2}``
   for 4 steps, resumed to 6 on ``{pipe: 2}`` with
   ``--pipe_interleave 1``. The other workloads, in the world of 2:
   ResNet-50 at 224 px and 1000 classes on ``{data: 2}`` (each
   BatchNorm's moments summed over the ranks, forward and backward; 4
   f32 steps at 2 x 32, cuDNN deterministic, against one rank at 64: the
   losses within rtol 3e-3, the ranks' running statistics bitwise equal
   and each element within rtol 3e-3, atol 1e-5 of one rank's;
   2 bf16 steps at 2 x 128, the second timed, with the peak memory a
   rank, beside phase_imagenet's one rank at 256) and BERT-base GLUE
   with the flash kernels on ``{model: 2}`` (6 heads a rank, the key
   bias; 4 f32 steps at 32 x 128 against one rank, 12 launches of each
   flash kernel a step on every rank; 2 bf16 steps, the second timed,
   against one rank's);
6. the ``{"group_row_sum": {...}}`` line (not the port of a TPU kernel),
   the ``{"phase_seconds": {...}}`` line (each phase also prints
   ``phase <name>: S s`` as it ends), the ``{"kernels": [...]}`` line,
   then the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # f32 outside the tensor cores
NEAR_TIE = 1e-4                # top-2 logit gap below which a greedy flip is a tie
LEAD_CYCLES = 40_000_000       # cuda_ms's device sleep: ~20 ms at the H100's 1.98 GHz boost
FLASH_SOURCE = "tensorflow_examples_torch/ops/csrc/decode.cu"
PAGED_SOURCE = "tensorflow_examples_torch/ops/csrc/paged_decode.cu"
ATTN_SOURCE = "tensorflow_examples_torch/ops/csrc/flash_attention.cu"
CE_SOURCE = "tensorflow_examples_torch/ops/csrc/cross_entropy.cu"
GMM_SOURCE = "tensorflow_examples_torch/ops/csrc/grouped_matmul.cu"
GMM_REPLACES = "tensorflow_examples_tpu/parallel/moe.py:190 (megablox gmm.py:{})"
BF16_DENSE_PEAK = 989.4e12     # H100 SXM bf16 tensor cores, dense: the MFU denominator
TRAIN_STEPS = 20
TRAIN_CONFIG_LAYERS = 4  # train_config's depth cut (12 by default): its checks hold at any depth
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
TRAIN_KERNELS = (*FLASH_KERNELS, "ce_fwd", "ce_bwd")
# torch.profiler drops device activity timestamped before its trace
# starts, and the card's kernel timestamps can read up to ~3 ms earlier
# than the host's launch timestamps (chip_probe.py profiler): a profiled
# window waits this long after the profiler starts, so the first step's
# kernels land inside the trace.
PROFILER_LEAD_S = 0.05
PLAIN_CE_PEAK_GIB = 25.1       # the same 20-step run at fused_ce=False, as PERF.md records it
CE_SHAPE = (16384, 50257)      # the step's logits: batch 16 x 1024 tokens, GPT-2 vocab
# Cross-entropy edge cases (label, N, V), each with labels -1 and V, a row
# of all -1e30 and a non-unit cotangent where N allows.
CE_EDGES = (("V=4099", 64, 4099), ("V=1000", 64, 1000), ("N=1", 1, 50257))
TRAIN_ATTN = (16, 12, 1024)    # the GPT-2 step's attention: batch, heads, sequence
BERT_ATTN = (32, 12, 128)      # BERT-base GLUE's attention: batch, heads, sequence (D 64)
# Flash edge cases (label, seq_q, seq_kv, causal, key bias, nonzero dlse), at batch 2;
# the ring's hops at GPT-2's seq 1024 over 2 context ranks take a nonzero
# lse cotangent from the merge: the contiguous ring's 512 x 512 causal
# diagonal and non-causal hop, zigzag's 256 x 256 causal diagonals, both
# chunks' 512 queries over one 256 chunk and the late chunk over 512 keys.
FLASH_EDGES = (
    ("seq_q<seq_kv", 300, 1000, True, None, False),
    ("uneven", 777, 777, True, None, False),
    ("key_bias -1e9", 256, 256, False, -1e9, False),
    ("key_bias NEG_INF", 200, 320, True, "NEG_INF", False),
    ("dlse", 512, 512, True, None, True),
    ("ring hop dlse", 512, 512, False, None, True),
    ("zigzag diagonal dlse", 256, 256, True, None, True),
    ("zigzag earlier dlse", 512, 256, False, None, True),
    ("zigzag later dlse", 256, 512, False, None, True),
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
# Flash-decode cases (q_len, length, max_len, timed): the engine's prefill
# buckets (q_len == length), an unaligned length, generate's decode step.
FLASH_DECODE_CASES = ((16, 16, 16, True), (128, 128, 128, True), (512, 512, 512, True),
                      (1024, 1024, 1024, True), (100, 100, 100, False), (1, 300, 1024, True))
# Paged-decode shapes at S=8: ragged lengths, and every slot full.
PAGED_SHAPES = (("ragged", [0, 1, 16, 17, 77, 300, 511, 1024]), ("full", [1024] * 8))
MIN_DISTINCT = 8                    # distinct tokens a compared 32-token stream needs
MOE_GENERATE_SEED = 0               # the MoE generate phase's init (the serving phase's seed)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


T_START = time.perf_counter()
PHASE_SECONDS: dict = {}


def timed(name: str, fn, *args):
    """One phase, its seconds printed and kept for the summary line."""
    t0 = time.perf_counter()
    result = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    log(f"phase {name}: {PHASE_SECONDS[name]:.1f} s")
    return result


def reset_counts(counters) -> None:
    """Every launch counter to 0, and the tensor-core, SIMT and split
    counters beside it where a kernel has them."""
    for c in counters.values():
        c.launches = 0
        if hasattr(c, "tensor_core_launches"):
            c.tensor_core_launches = c.simt_launches = 0
        if hasattr(c, "split_launches"):
            c.split_launches = 0


def flash_variants(counters) -> dict:
    """The three training flash kernels' launches by variant, as
    ``{"flash_fwd_tensor_core": n, "flash_fwd_simt": n, ...}``."""
    return {f"{n}_{v}": getattr(counters[n], f"{v}_launches")
            for n in FLASH_KERNELS for v in ("tensor_core", "simt")}


def flash_want(n: int, variant: str) -> dict:
    """The flash kernels' counters after ``n`` launches of each, all on
    ``variant`` ("tensor_core" or "simt"), keyed as :func:`flash_variants`
    and by kernel name."""
    return {**{k: n for k in FLASH_KERNELS},
            **{f"{k}_{v}": n if v == variant else 0
               for k in FLASH_KERNELS for v in ("tensor_core", "simt")}}


def ran(kernel, call):
    """``call()``'s result and the variant ("tensor_core" or "simt") that
    its one launch of ``kernel`` took, read from the kernel's counters."""
    tc, simt = kernel.tensor_core_launches, kernel.simt_launches
    out = call()
    took = ("tensor_core" if (kernel.tensor_core_launches, kernel.simt_launches) == (tc + 1, simt)
            else "simt" if (kernel.tensor_core_launches, kernel.simt_launches) == (tc, simt + 1)
            else None)
    return out, took


def flash_variant(dtype_name: str, d: int) -> str:
    """The flash kernels' variant by the rule they are held to: the tensor
    cores in bf16 from head_dim 16 (the mma's k16 depth), SIMT otherwise."""
    return "tensor_core" if dtype_name == "bfloat16" and d >= 16 else "simt"


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back calls.
    The calls are enqueued behind a device sleep of ~20 ms, so that a call
    whose host side (autograd, Python) is slower than its kernels is still
    timed on the device and not at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(LEAD_CYCLES)
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


def kernel_of(mangled: str) -> str:
    """``name<template args>`` of a mangled kernel name, from its
    ``<length><name>I<args>E`` part (the length may follow hash digits);
    else the name cut to 60 characters."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):
            n, at = int(mangled[i:m.end()]), m.end()
            name = mangled[at:at + n]
            if n and name.endswith("_kernel") and mangled.startswith("I", at + n):
                args = re.match(r"I(\w*?)EE?v", mangled[at + n:])
                return f"{name}<{args.group(1) if args else ''}>"
    return mangled[:60]


def phase_build(build) -> None:
    t0 = time.perf_counter()
    try:
        build.build_all()
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    log(f"build: {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.3f} s "
        f"(one nvcc per source, in parallel)")
    for name, text in sorted(build.build_logs.items()):
        kernel = "?"
        for line in text.splitlines():
            entry = re.search(r"entry function '([^']+)'", line)
            if entry:
                kernel = kernel_of(entry.group(1))
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name} {kernel}: {line.strip()}")


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


def decode_ran(decode, call):
    """``call()``'s result and (variant, split) of its one flash-decode
    launch, read from the wrapper's counters."""
    fn = decode.flash_decode_attention
    split = fn.split_launches
    out, took = ran(fn, call)
    return out, (took, fn.split_launches == split + 1)


def paged_tables(torch, gen, lengths_l, bs, nb):
    """Block tables [S, nb] int32 for these lengths: each slot's blocks drawn
    from a shuffled pool of S * nb blocks numbered from 1, padded with the
    unused block 0."""
    s = len(lengths_l)
    perm = torch.randperm(s * nb, generator=gen) + 1
    tables = torch.zeros(s, nb, dtype=torch.int32)
    used = 0
    for i, n in enumerate(lengths_l):
        need = -(-n // bs)
        tables[i, :need] = perm[used:used + need].int()
        used += need
    return tables


def poison_tails(torch, pools, tables, lengths_l, bs):
    """Copies of the pools with NaN in every row the kernel must not read:
    rows at or past a slot's length in its last block, and block 0 (the
    tables' padding). ``pools`` holds f32 tensors [NB, H, BS, D] (blocks)
    or [NB, H, BS] (int8 row scales)."""
    out = []
    for pool in pools:
        p = pool.clone()
        p[0] = float("nan")
        for i, n in enumerate(lengths_l):
            if n % bs:
                p[int(tables[i, n // bs]), :, n % bs:] = float("nan")
        out.append(p)
    return out


def phase_kernels(torch, decode, paged, precision) -> dict:
    """Both decode kernels at their main paths' shapes against their plain
    versions, with kernel, plain, library and bound times, the variant
    counters held to the plan, and every case rerun for the same bits."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    rows = {}

    # Flash-decode at the engine's prefill shapes (q_len == length == cache,
    # 100 an unaligned correctness case) and generate's decode step (one
    # query over 300 rows of a 1024-row cache whose tail is NaN: the kernel
    # must read nothing past the populated length).
    flash_err, shapes = 0.0, []
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        dname = str(dtype).replace("torch.", "")
        want_route = "tensor_core" if dtype == torch.bfloat16 else "simt"
        for q_len, length, max_len, timed in FLASH_DECODE_CASES:
            q = randn(1, 12, q_len, 64, dtype=dtype)
            k, v = randn(1, 12, max_len, 64, dtype=dtype), randn(1, 12, max_len, 64, dtype=dtype)
            kp, vp = k[:, :, :length], v[:, :, :length]  # the populated rows
            if max_len > length:
                k[:, :, length:] = float("nan")
                v[:, :, length:] = float("nan")
            plan = decode.decode_plan(dtype, q_len, length, max_len, 12, 64)
            label = f"{dname} B=1 H=12 q_len={q_len} length={length} max_len={max_len} D=64"
            out, took = decode_ran(decode, lambda: decode.flash_decode_attention(q, k, v, length))
            if took != (want_route, plan.splits > 1) or plan.route != want_route:
                fail(f"flash_decode {label}: took {took}, plan {plan}; expected {want_route}")
            ref = decode.decode_attention_reference(q, kp, vp, length)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            if not torch.isfinite(out.float()).all() or err > atol:
                fail(f"flash_decode {label}: max_abs_err {err:.3e} > {atol}")
            for _ in range(2):
                if not torch.equal(out, decode.flash_decode_attention(q, k, v, length)):
                    fail(f"flash_decode {label}: a rerun on the same inputs changed the bits")
            if dtype == torch.float32:
                flash_err = max(flash_err, err)
            line = (f"flash_decode {label}: max_abs_err {err:.3e} (atol {atol}), route "
                    f"{plan.route}, block_q {plan.block_q}, splits {plan.splits}, rerun "
                    f"bit-identical")
            if not timed:
                log(line)
                continue
            ms = cuda_ms(torch, lambda: decode.flash_decode_attention(q, k, v, length))
            plain = cuda_ms(torch, lambda: decode.decode_attention_reference(q, kp, vp, length))
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, kp, vp, is_causal=q_len > 1))
            t_bytes, t_ops = flash_times(q_len, length, max_len, 12, 64, dname, q.element_size())
            bound_ms, by = bound(t_bytes, t_ops)
            log(f"{line}; kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms(sdpa) {lib:.4f} "
                f"bytes_ms {t_bytes:.5f} (at 3.35 TB/s) ops_ms {t_ops:.5f} bound_ms "
                f"{bound_ms:.5f} ({by})")
            shape = dict(shape=label, route=plan.route, block_q=plan.block_q,
                         splits=plan.splits, max_abs_err=err, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=bound_ms, bound_by=by)
            shapes.append(shape)
            if dtype == torch.float32 and q_len == length == 1024:
                rows["flash_decode"] = {k: shape[k] for k in (
                    "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    rows["flash_decode"].update(max_abs_err=flash_err, all_shapes=shapes)

    # Paged decode: S=8, H=12, BS=16, nb=64; ragged lengths (an empty slot,
    # a length-1 slot, a full block, ragged last blocks, a full table) and
    # every slot full, where bytes should set the time. The rows past each
    # slot's length and the unused block are NaN in the kernel's pools.
    s, h, bs, nb, d = 8, 12, 16, 64, 64
    per, splits = paged.paged_plan(bs, nb)
    paged_err, shapes = 0.0, []
    fn = paged.paged_decode_attention
    for shape_label, lengths_l in PAGED_SHAPES:
        tables = paged_tables(torch, gen, lengths_l, bs, nb)
        lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
        q = randn(s, h, d)
        kb, vb = randn(s * nb + 1, h, bs, d), randn(s * nb + 1, h, bs, d)
        qk, ks = precision.quantize_int8_rows(kb)
        qv, vs = precision.quantize_int8_rows(vb)
        kb_nan, vb_nan, ks_nan, vs_nan = poison_tails(torch, (kb, vb, ks, vs), tables,
                                                      lengths_l, bs)
        tables = tables.to(dev)
        live = lengths > 0
        for label, clean, poisoned, itemsize in (
            ("fp32", ((kb, vb), {}), ((kb_nan, vb_nan), {}), 4),
            ("int8", ((qk, qv), {"k_scale": ks, "v_scale": vs}),
             ((qk, qv), {"k_scale": ks_nan, "v_scale": vs_nan}), 1),
        ):
            args, kw = poisoned
            before = (fn.launches, fn.split_launches)
            out = fn(q, *args, lengths, tables, **kw)
            took = (fn.launches - before[0], fn.split_launches - before[1])
            if took != (1, int(splits > 1)):
                fail(f"paged_decode {label} {shape_label}: (launches, split launches) {took}, "
                     f"plan {splits} splits")
            ref = paged.paged_decode_reference(q, *clean[0], lengths, tables, **clean[1])
            torch.cuda.synchronize()
            err = float((out[live] - ref[live]).abs().max())
            empty = float(out[~live].abs().max()) if bool((~live).any()) else 0.0
            if not torch.isfinite(out).all() or err > 2e-6 or empty != 0.0:
                fail(f"paged_decode {label} {shape_label}: max_abs_err {err:.3e} (atol 2e-6), "
                     f"length-0 slot max {empty:.3e}")
            for _ in range(2):
                if not torch.equal(out, fn(q, *args, lengths, tables, **kw)):
                    fail(f"paged_decode {label} {shape_label}: a rerun changed the bits")
            paged_err = max(paged_err, err)
            ms = cuda_ms(torch, lambda: fn(q, *args, lengths, tables, **kw))
            plain = cuda_ms(torch, lambda: paged.paged_decode_reference(
                q, *clean[0], lengths, tables, **clean[1]))
            t_bytes, t_ops = paged_times(lengths_l, bs, h, d, itemsize, bool(kw))
            bound_ms, by = bound(t_bytes, t_ops)
            shape = f"S={s} H={h} BS={bs} nb={nb} D={d} {label} lengths={lengths_l}"
            log(f"paged_decode {label} {shape_label} {shape}: max_abs_err {err:.3e} (atol 2e-6), "
                f"length-0 slot exact zeros, NaN tails unread, {splits} splits of {per} blocks, "
                f"rerun bit-identical; kernel_ms {ms:.4f} plain_ms {plain:.4f} bytes_ms "
                f"{t_bytes:.5f} (at 3.35 TB/s) ops_ms {t_ops:.5f} bound_ms {bound_ms:.5f} ({by}), "
                f"{bound_ms / ms:.1%} of bound")
            shapes.append(dict(shape=shape, splits=splits, max_abs_err=err, ms=ms,
                               plain_ms=plain, bound_ms=bound_ms, bound_by=by))
            if label == "fp32" and shape_label == "ragged":
                rows["paged_decode"] = dict(shape=shape, ms=ms, plain_ms=plain,
                                            bound_ms=bound_ms, bound_by=by, library_ms=None)
    rows["paged_decode"].update(max_abs_err=paged_err, all_shapes=shapes)
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
        (o, lse), v_fwd = ran(attention.flash_fwd, lambda: attention.flash_fwd(q, k, v, kb, **kw))
        o_ref, lse_ref = attention.flash_fwd_plain(q, k, v, kb, **kw)
        delta = (do.float() * o_ref.float()).sum(-1)
        args = (q, k, v, do, lse_ref, delta, dlse, kb)
        (dk, dv), v_dkv = ran(attention.flash_bwd_dkv, lambda: attention.flash_bwd_dkv(*args, **kw))
        dq, v_dq = ran(attention.flash_bwd_dq, lambda: attention.flash_bwd_dq(*args, **kw))
        dk_ref, dv_ref = attention.flash_bwd_dkv_plain(*args, **kw)
        dq_ref = attention.flash_bwd_dq_plain(*args, **kw)
        torch.cuda.synchronize()
        variants = {"fwd": v_fwd, "dkv": v_dkv, "dq": v_dq}
        want = flash_variant(dname, d)
        if any(took != want for took in variants.values()):
            fail(f"flash[{label}] {dname} D={d}: variants {variants}, expected {want} for "
                 "all three")
        rerun = "not a tensor-core case"
        if want == "tensor_core":  # one writer per element, no atomics: the same bits again
            same = {"fwd": all(map(torch.equal, (o, lse), attention.flash_fwd(q, k, v, kb, **kw))),
                    "dkv": all(map(torch.equal, (dk, dv), attention.flash_bwd_dkv(*args, **kw))),
                    "dq": torch.equal(dq, attention.flash_bwd_dq(*args, **kw))}
            if not all(same.values()):
                fail(f"flash[{label}] {dname}: a rerun on the same inputs changed bits: {same}")
            rerun = "bit-identical"
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
            f"{lse_err[0]:.3e} dkv {errs['dkv'][0]:.3e} dq {errs['dq'][0]:.3e}; variants "
            f"{variants}; rerun {rerun}")
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
        out4 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        sdpa_bwd = cuda_ms(torch, lambda: torch.autograd.grad(out4, (qg, kg, vg), do4,
                                                              retain_graph=True), iters=10)
        for kind, (kernel, plain) in calls.items():
            ms = cuda_ms(torch, kernel)
            plain_ms = cuda_ms(torch, plain, iters=5, warmup=1)
            t_bytes, t_ops = flash_train_times(seq_q, seq_kv, b * h, d, causal, dname,
                                               q.element_size(), kind)
            bound_ms, by = bound(t_bytes, t_ops)
            log(f"flash_{kind} {dname} B={b} H={h} S={seq_q} D={d} causal: kernel_ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} bytes_ms {t_bytes:.5f} ops_ms {t_ops:.5f} bound_ms "
                f"{bound_ms:.5f} ({by}); library sdpa fwd_ms {sdpa_fwd:.4f} fwd+bwd_ms "
                f"{sdpa_both:.4f} bwd_ms {sdpa_bwd:.4f}")
            rows.setdefault(f"{dname}/{kind}", dict(
                shape=f"B={b} H={h} S={seq_q} D={d} causal {dname}", ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by,
                library_ms=sdpa_fwd if kind == "fwd" else None, sdpa_fwd_bwd_ms=sdpa_both,
                variant=variants[kind],
                **({} if kind == "fwd" else {"sdpa_bwd_ms": sdpa_bwd}),
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
    f32; in bf16 all three on the tensor cores from D=16), flash-decode
    (B=2, H=12, q_len=length=300 and q_len=1 over 300 rows of a 1024-row
    cache, f32 and bf16, both split, its route held to the same rule) and
    paged decode (S=2, H=12, fp32 and int8; block 16, and block 64 at
    D=128; both split). Returns the worst error per kernel and D."""
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
            (o, lse), v_fwd = ran(attention.flash_fwd,
                                  lambda: attention.flash_fwd(q, k, v, None, **kw))
            o_ref, lse_ref = attention.flash_fwd_plain(q, k, v, None, **kw)
            delta = (do.float() * o_ref.float()).sum(-1)
            args = (q, k, v, do, lse_ref, delta, dlse, None)
            (dk, dv), v_dkv = ran(attention.flash_bwd_dkv,
                                  lambda: attention.flash_bwd_dkv(*args, **kw))
            dq, v_dq = ran(attention.flash_bwd_dq, lambda: attention.flash_bwd_dq(*args, **kw))
            variants = {"flash_fwd": v_fwd, "flash_bwd_dkv": v_dkv, "flash_bwd_dq": v_dq}
            if any(took != flash_variant(dname, d) for took in variants.values()):
                fail(f"head_dim sweep: {dname} D={d} variants {variants}, expected "
                     f"{flash_variant(dname, d)} for all three")
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
                + f"; flash_fwd kernel_ms {ms:.4f}; variants {variants}")
            for (kernel, what), (err, ok) in errs.items():
                note(kernel, d, err, ok, f"{dname} {what}")
            del q, k, v, do, o, o_ref, dk, dv, dq, dk_ref, dv_ref, dq_ref

            for q_len, n, max_len in ((300, 300, 300), (1, 300, 1024)):
                q = randn(b, h, q_len, d, dtype=dtype)
                kc, vc = (randn(b, h, max_len, d, dtype=dtype) for _ in range(2))
                plan = decode.decode_plan(dtype, q_len, n, max_len, b * h, d)
                out, took = decode_ran(decode, lambda: decode.flash_decode_attention(q, kc, vc, n))
                if took != (flash_variant(dname, d), plan.splits > 1):
                    fail(f"head_dim sweep: flash_decode {dname} D={d} q_len={q_len} took {took}, "
                         f"plan {plan}")
                ref = decode.decode_attention_reference(q, kc, vc, n)
                torch.cuda.synchronize()
                err, ok = allclose_err(torch, out, ref, fwd_tol, 0.0)
                log(f"head_dim sweep flash_decode {dname} B={b} H={h} q_len={q_len} length={n} "
                    f"max_len={max_len} D={d}: max_abs_err {err:.3e} (atol {fwd_tol}); route "
                    f"{took[0]}, block_q {plan.block_q}, splits {plan.splits}")
                note("flash_decode", d, err, ok, f"{dname} q_len={q_len}")

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
                    f"lengths={lengths_l}: max_abs_err {err:.3e} (2e-6); "
                    f"{paged.paged_plan(bs, nb)[1]} splits")
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


def device_split(torch, fn, top: int = 8) -> dict:
    """torch.profiler around ``fn`` (which ends synchronized): host wall,
    summed kernel time, and kernel time by kind (the port's flash
    kernels, its grouped-matmul and row-sum kernels, matmuls, everything
    else); idle = wall - kernel time. ``indexing_backward_ms`` is PyTorch's
    scatter-add backward of a row gather, which the MoE step must not run.
    ``top``: the kernels with the most time, by name (0: every one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_LEAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    split = {"flash": 0.0, "gmm": 0.0, "tgmm": 0.0, "group_row_sum": 0.0, "matmul": 0.0,
             "other": 0.0}
    flash = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}  # the flash bucket by kernel
    launches = 0
    indexing_backward = 0.0
    kernels = {}
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
                "matmul" if any(t in name for t in ("gemm", "cutlass", "xmma", "cublas", "sm90_",
                                                    "nvjet"))
                else "other")
        split[kind] += ms
        if kind == "flash":
            flash["dkv" if "flash_bwd_dkv" in name else "dq" if "flash_bwd_dq" in name
                  else "fwd"] += ms
        launches += e.count
        if "indexing_backward" in name:
            indexing_backward += ms
        kernels[e.key[:70]] = kernels.get(e.key[:70], 0.0) + ms  # names cut to 70 collide
    busy = sum(split.values())
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_ms": wall_ms - busy,
            "busy_share": busy / wall_ms, **{f"{k}_ms": v for k, v in split.items()},
            **{f"flash_{k}_ms": v for k, v in flash.items()},
            "indexing_backward_ms": indexing_backward, "kernel_launches": launches,
            "top": sorted(kernels.items(), key=lambda kv: -kv[1])[:top or None]}


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
        reset_counts(counters)
        loss, _, _ = trainer.task.loss_fn(
            trainer.policy.cast_compute(leaves), {}, trainer.put_batch(batch0),
            rng=rng.StepNoise(trainer.step_key(0)), train=True)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        step0[label] = (float(loss.detach()), dict(zip(leaves, grads)),
                        {**{k: counters[k].launches for k in TRAIN_KERNELS},
                         **flash_variants(counters)})
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
    # f32 takes the SIMT flash kernels: the tensor-core ones' oracle path.
    want = {**flash_want(layers, "simt"), "ce_fwd": 1, "ce_bwd": 1}
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
    reset_counts(counters)
    t0 = time.perf_counter()
    trainer.fit(data, num_steps=TRAIN_STEPS)
    wall = time.perf_counter() - t0
    launches = {**{k: c.launches for k, c in counters.items()}, **flash_variants(counters)}
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train: losses not finite and falling over {len(hist)} steps: {losses}")
    if any(h["bad_step"] for h in hist):
        fail("train: the bad-step guard skipped a step")
    # bf16: every flash launch on the tensor cores, none SIMT.
    for name, per_step in {**flash_want(base.num_layers, "tensor_core"), "ce_fwd": 1,
                           "ce_bwd": 1}.items():
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
        reset_counts(counters)
        t0 = time.perf_counter()
        toks, step = generate.generate_from_workdir(cfg.replace(attention=impl), prompt,
                                                    num_tokens=32, temperature=0.0, top_k=0)
        walls[impl] = time.perf_counter() - t0
        launches[impl] = counters["flash_decode"].launches
        if impl == "flash":
            flash_splits = counters["flash_decode"].split_launches
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
                   flash_decode_launches=launches["flash"],
                   flash_decode_split_launches=flash_splits, wall_s=walls,
                   stream=streams["flash"][:8])
    log(f"generate: {json.dumps(summary)}")
    if verdict != "exact" and verdict[0] != "tie":
        fail(f"generate: the flash stream differs from the xla stream at token {verdict[1]} "
             f"(top-2 gap {verdict[2]})")
    return summary


def phase_train_config(torch, counters, smi: str, tmp: str) -> dict:
    """The rest of the training config at the ``Gpt2Config`` widths and
    defaults (bf16, batch 16 x 1024, fused CE; dropout 0.1 unless a check
    says 0), cut to ``TRAIN_CONFIG_LAYERS`` layers, checks (a)-(h) of the
    module docstring."""
    import collections
    import functools
    import gc
    import shutil

    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    from tensorflow_examples_torch.core import rng as rng_mod
    from tensorflow_examples_torch.data.memory import train_iterator
    from tensorflow_examples_torch.data.prefetch import bundle_batches, put_batch
    from tensorflow_examples_torch.models import convert, hf_import, transformer
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.train.task import Task
    from tensorflow_examples_torch.utils import faults
    from tensorflow_examples_torch.workloads import gpt2

    base = gpt2.Gpt2Config(warmup_steps=2, log_every=4, eval_every=0, checkpoint_every=0,
                           telemetry_sinks="", train_steps=8, num_layers=TRAIN_CONFIG_LAYERS)
    ds, _ = gpt2.datasets(base)
    data = lambda start: train_iterator(ds, base.global_batch_size, seed=base.seed,
                                        start_step=start)
    out: dict = {"card": smi}

    def free():
        """Drop the deleted trainers (a trainer and its k-step graph hold
        each other) and their graphs' private pools."""
        gc.collect()
        torch.cuda.empty_cache()

    def fit(cfg, steps, task=None, stream=None):
        trainer = Trainer(task or gpt2.make_task(cfg), cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(stream or data, num_steps=steps)
        torch.cuda.synchronize()
        return trainer, time.perf_counter() - t0

    def f32_params(trainer):
        return torch.cat([p.float().reshape(-1) for p in trainer.state.params.values()])

    # (a) 8 steps as 2 launches of 4 against 8 eager steps, dropout 0, f32.
    cfg = base.replace(dropout=0.0, precision="f32")
    eager, _ = fit(cfg, 8)
    reset_counts(counters)
    graph, _ = fit(cfg.replace(steps_per_launch=4), 8)
    launches = {k: counters[k].launches for k in TRAIN_KERNELS}
    tally = graph.bundled_step(4).tallies()
    a, b = f32_params(eager), f32_params(graph)
    rel = float((a - b).abs().max() / a.abs().max())
    out["a"] = dict(max_rel_param_diff=rel, bitwise=bool(torch.equal(a, b)), launches=launches,
                    replay_tally=tally, graphs=graph.bundled_step(4).captured,
                    losses_eager=[h["loss"] for h in eager.history],
                    losses_graph=[h["loss"] for h in graph.history])
    log(f"train_config (a): {json.dumps(out['a'])}")
    # Launches: the eager warm-up's 4 steps, then 2 replays of 4 steps
    # (the capture's own are taken back out).
    per_step = {k: base.num_layers if k.startswith("flash") else 1 for k in TRAIN_KERNELS}
    want = {k: 12 * n for k, n in per_step.items()}
    want_tally = [{f"{k}.launches": 4 * n for k, n in per_step.items()}]
    got_tally = [{k: v for k, v in t.items() if k.endswith(".launches")} for t in tally]
    if rel > 1e-5 or launches != want or got_tally != want_tally:
        fail(f"train_config (a): graph vs eager params rel {rel:.2e} (limit 1e-5); launches "
             f"{launches}, expected {want}; a replay's tally {got_tally}, expected {want_tally}")
    del eager, graph, a, b
    free()

    # (b) dropout 0.1: the 4 steps of a launch draw the eager steps' masks
    # (their window losses agree), the graph's generators staged for the
    # steps of one launch draw 4 different uniforms (the first equal to
    # the eager step's), and a resume at a bundle boundary reproduces the
    # uninterrupted losses.
    wd = os.path.join(tmp, "train_config_b")
    cfg = base.replace(steps_per_launch=4, log_every=4, checkpoint_every=4)
    eager, _ = fit(base.replace(log_every=4), 8)
    whole, _ = fit(cfg, 8)
    first, _ = fit(cfg.replace(workdir=wd), 4)
    resumed, _ = fit(cfg.replace(workdir=wd), 8)
    windows = lambda t: [(h["step"], h["loss"]) for h in t.history]
    rel_eager = max(abs(x[1] - y[1]) / abs(y[1]) for x, y in zip(windows(whole), windows(eager)))
    rel_resume = abs(windows(resumed)[-1][1] - windows(whole)[-1][1]) / abs(windows(whole)[-1][1])
    draws = [noise.stage(whole.step_key(i)).dropout_uniform(1, (16,), whole.device)
             for i, noise in enumerate(whole.bundled_step(4)._noises)]
    eager_draw = rng_mod.StepNoise(whole.step_key(0)).dropout_uniform(1, (16,), whole.device)
    distinct = len({d.cpu().numpy().tobytes() for d in draws})
    out["b"] = dict(distinct_staged_draws_of_4_steps=distinct,
                    first_equals_eager=bool(torch.equal(draws[0], eager_draw)),
                    graph=windows(whole), eager=windows(eager), resumed=windows(resumed),
                    rel_vs_eager=rel_eager, rel_resumed=rel_resume)
    log(f"train_config (b): {json.dumps(out['b'])}")
    if distinct != 4 or not out["b"]["first_equals_eager"] or rel_eager > 1e-5 or \
            rel_resume > 1e-5 or [s for s, _ in windows(resumed)] != [8]:
        fail(f"train_config (b): {out['b']}")
    shutil.rmtree(wd, ignore_errors=True)
    del eager, whole, first, resumed
    free()

    # (c) host wall per step and profiled idle share, k = 1 and k = 4,
    # alternated, 3 windows each (8 steps a window after a warm fit).
    walls = {1: [], 4: []}
    idle = {1: [], 4: []}
    trainers = {k: Trainer(gpt2.make_task(base), base.replace(steps_per_launch=k, log_every=8))
                for k in (1, 4)}
    for k, tr in trainers.items():
        tr.fit(data, num_steps=8)  # build, warm-up, capture
    for w in range(3):
        for k in ((1, 4) if w % 2 == 0 else (4, 1)):
            tr = trainers[k]
            start = tr.state.step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.fit(data, num_steps=start + 8)
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t0) / 8 * 1e3)
            stream = data(tr.state.step)
            batch = put_batch(next(stream if k == 1 else bundle_batches(stream, k)), tr.device)
            fn = (lambda s, b: tr._step_fn(tr, s, b)) if k == 1 else tr.bundled_step(k)

            def launch():
                tr.state, _ = fn(tr.state, batch)
            prof = device_split(torch, launch)
            idle[k].append(prof["idle_ms"] / prof["wall_ms"])
    out["c"] = dict(host_ms_per_step=walls, profiled_idle_share=idle,
                    note="fit wall over 8 steps a window, log_every 8; one profiled launch")
    log(f"train_config (c): {json.dumps(out['c'])}")
    del trainers
    free()

    # (d) remat policies against no remat: step-0 loss and gradients (f32,
    # dropout 0.1), each variant compared as it runs so that no variant's
    # gradients stay alive; the dispatcher ops each policy's checkpoint
    # saved in one more forward (a policy function that records them, on
    # REMAT_SAVES); then each variant's peak memory over a bf16 step with
    # nothing else of this check alive.
    batch0 = next(data(0))
    variants = (("no remat", False, "none"), ("none", True, "none"), ("dots", True, "dots"),
                ("dots_no_batch", True, "dots_no_batch"))
    ref, worst, saved, peaks = None, {}, {}, {}
    for label, remat, policy in variants:
        cfg = base.replace(precision="f32", remat=remat, remat_policy=policy)
        tr = Trainer(gpt2.make_task(cfg), cfg)
        leaves = {k: p.detach().requires_grad_() for k, p in tr.state.params.items()}
        step0 = lambda: tr.task.loss_fn(tr.policy.cast_compute(leaves), {}, tr.put_batch(batch0),
                                        rng=rng_mod.StepNoise(tr.step_key(0)), train=True)[0]
        loss = step0()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        loss = float(loss.detach())
        if ref is None:
            ref = (loss, grads)
        else:
            worst[label] = max([abs(loss - ref[0]) / abs(ref[0])] + [
                float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
                for a, b in zip(grads, ref[1])])
        del loss, grads
        saves = transformer.REMAT_SAVES[policy]
        if remat and saves:
            counts = collections.Counter()

            def record(ctx, op, *args, **kwargs):
                if op not in saves:
                    return CheckpointPolicy.PREFER_RECOMPUTE
                if not ctx.is_recompute:
                    counts[str(op)] += 1
                return CheckpointPolicy.MUST_SAVE

            real = transformer.remat_context
            transformer.remat_context = lambda _: functools.partial(
                create_selective_checkpoint_contexts, record)
            try:
                step0()
            finally:
                transformer.remat_context = real
            saved[label] = dict(counts)
        del tr, leaves
    del ref
    free()
    for label, remat, policy in variants:
        cfg = base.replace(remat=remat, remat_policy=policy)
        tr = Trainer(gpt2.make_task(cfg), cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr.train_step(batch0)
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated() / 2**30
        del tr
        free()
    out["d"] = dict(worst_rel_diff_vs_no_remat=worst, ops_saved_per_forward=saved,
                    peak_mem_gib_bf16_step=peaks)
    log(f"train_config (d): {json.dumps(out['d'])}")
    if max(worst.values()) > 1e-5:
        fail(f"train_config (d): a remat policy differs from no remat: {worst}")

    # (e) pretrained= from a directory of the seed-0 params under HF names.
    cfg = base.replace(precision="f32", dropout=0.0)
    seed_tr = Trainer(gpt2.make_task(cfg), cfg)
    hf_dir = os.path.join(tmp, "hf_gpt2")
    hf_import.export_gpt2(convert.to_param_tree(seed_tr.state.params), gpt2.model_config(cfg),
                          hf_dir)
    pre_tr = Trainer(gpt2.make_task(cfg.replace(pretrained=hf_dir)), cfg.replace(pretrained=hf_dir))
    losses = [float(t._train_step(t.state, t.put_batch(batch0))[1]["loss"])
              for t in (seed_tr, pre_tr)]
    out["e"] = dict(seed_loss=losses[0], pretrained_loss=losses[1],
                    files=sorted(os.listdir(hf_dir)))
    log(f"train_config (e): {json.dumps(out['e'])}")
    if losses[0] != losses[1]:
        fail(f"train_config (e): pretrained step-0 loss {losses[1]} != seed {losses[0]}")
    del seed_tr, pre_tr
    free()
    shutil.rmtree(hf_dir, ignore_errors=True)

    # (f) badbatch@3 with max_skipped_batches=1: one batch skipped, counted.
    from tensorflow_examples_torch.telemetry.registry import default_registry
    before = default_registry().counter_values().get("data/batches_skipped", 0)
    faults.install("badbatch@3")
    try:
        tr, _ = fit(base.replace(max_skipped_batches=1, log_every=6), 6)
    finally:
        faults.clear()
    skipped = default_registry().counter_values().get("data/batches_skipped", 0) - before
    out["f"] = dict(skipped=skipped, steps=tr.state.step)
    log(f"train_config (f): {json.dumps(out['f'])}")
    if skipped != 1 or tr.state.step != 6:
        fail(f"train_config (f): {out['f']}")
    del tr

    # (g) a 2-step profiler window at k = 1 names the flash and CE kernels.
    prof_dir = os.path.join(tmp, "profile")
    tr, _ = fit(base.replace(profile_start_step=1, profile_num_steps=2, profile_dir=prof_dir,
                             log_every=4), 4)
    with open(os.path.join(prof_dir, f"trace_{os.getpid()}.json")) as f:
        names = {ev.get("name", "") for ev in json.load(f).get("traceEvents", [])}
    found = {w: any(w in n for n in names)
             for w in ("flash_fwd_mma_kernel", "ce_fwd_kernel", "ce_bwd_kernel")}
    out["g"] = dict(events=len(names), found=found)
    log(f"train_config (g): {json.dumps(out['g'])}")
    if not all(found.values()):
        fail(f"train_config (g): the profiler trace lacks kernels: {found}")
    del tr

    # (h) debug_nans with nan@2 raises FloatingPointError.
    task = gpt2.make_task(base)

    def scaled(params, model_state, batch, *, rng, train):
        batch = dict(batch)
        scale = batch.pop("scale")
        loss, metrics, ms = task.loss_fn(params, model_state, batch, rng=rng, train=train)
        return loss * scale.mean(), metrics, ms

    scaled_task = Task("scaled", task.init_fn, scaled, task.make_optimizer)
    stream = lambda start: ({**b, "scale": np.ones(base.global_batch_size, np.float32)}
                            for b in data(start))
    faults.install("nan@2")
    try:
        fit(base.replace(debug_nans=True), 4, task=scaled_task, stream=stream)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    finally:
        faults.clear()
    out["h"] = dict(raised=raised)
    log(f"train_config (h): {json.dumps(out['h'])}")
    if raised is None or "step 2" not in raised:
        fail(f"train_config (h): debug_nans with nan@2 raised {raised!r}")
    free()
    return out


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
        reset_counts(counters)
        with pinned_routing(moe_mod, recorded) as routing, \
                plain_grouped_matmul(gm) if plain else contextlib.nullcontext():
            loss, metrics, _ = trainer.task.loss_fn(
                trainer.policy.cast_compute(leaves), {}, trainer.put_batch(batch0),
                rng=rng.StepNoise(trainer.step_key(0)), train=True)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        recorded = recorded or routing.calls
        step0[label] = (float(loss.detach()), dict(zip(leaves, grads)),
                        {**{k: counters[k].launches for k in (*MOE_KERNELS, *FLASH_KERNELS)},
                         "tgmm_tensor_core": gm.tgmm.tensor_core_launches,
                         "tgmm_simt": gm.tgmm.simt_launches, **flash_variants(counters)},
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
            "tgmm_tensor_core": 0, "tgmm_simt": 2 * n_moe, **flash_want(base.num_layers, "simt")}
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
    reset_counts(counters)
    t0 = time.perf_counter()
    trainer.fit(data, num_steps=TRAIN_STEPS)
    wall = time.perf_counter() - t0
    launches = {**{k: c.launches for k, c in counters.items()}, **flash_variants(counters)}
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
                           ("group_row_sum", 2 * n_moe),
                           *flash_want(base.num_layers, "tensor_core").items(),
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
        reset_counts(counters)
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
    longest prompt and ``steps`` decode steps over every request's slot
    (replays of the rung's CUDA graph). For each: host wall time, summed
    kernel time on the card (its share of the wall is the busy share; the
    rest is the card idle, waiting on the host), the port's own kernels'
    share, and the top kernels. For the decode steps also the paged
    kernel's launches as the profiler saw them and as its counter, added
    up from the graph replays' tallies, says."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tensorflow_examples_torch.ops.paged_decode import paged_decode_attention

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
        counted = paged_decode_attention.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_LEAD_S)
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        counted = paged_decode_attention.launches - counted
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        kernels = sorted(((e.key, e.self_device_time_total / 1e3 / n, e.count // n)
                          for e in events), key=lambda r: -r[1])
        busy = sum(ms for _, ms, _ in kernels)
        ours = sum(ms for name, ms, _ in kernels if any(
            k in name for k in ("flash_decode_", "paged_decode_kernel", "merge_splits_kernel")))
        result[label] = {
            "wall_ms": wall_ms, "device_ms": busy,
            "busy_share": busy / wall_ms if wall_ms else None,
            "port_kernel_ms": ours,
            "launches": sum(c for _, _, c in kernels),
            "paged_kernel_launches_profiled": sum(
                e.count for e in events if "paged_decode_kernel" in e.key),
            "paged_kernel_launches_counted": counted,
            "top": [[name[:70], ms, c] for name, ms, c in kernels[:6]],
        }
    for slot in slots:
        engine.pool.free(slot)
    return result


def decode_wall(torch, engine, prompts, steps: int = 16) -> float:
    """Host wall milliseconds a plain decode step over every prompt's slot
    (each step ends in its device -> host sync), after two warm steps."""
    slots = [engine.pool.alloc() for _ in prompts]
    entries = [[slot, engine.prefill(slot, p)[0], 0, 0.0, 0] for slot, p in zip(slots, prompts)]
    for i in range(steps + 2):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = engine.decode([tuple(e) for e in entries])
        for e in entries:
            e[1] = out[e[0]]
    wall = (time.perf_counter() - t0) * 1e3 / steps
    for slot in slots:
        engine.pool.free(slot)
    return wall


def serve_http(engine, requests, counters):
    """The requests, all at once, over HTTP through ContinuousBatcher and
    ServingFrontend: (replies, wall seconds, launch counters read around
    them, the batcher's serving line)."""
    from tensorflow_examples_torch.serving.batcher import ContinuousBatcher
    from tensorflow_examples_torch.serving.frontend import ServingFrontend

    batcher = ContinuousBatcher(engine).start()
    frontend = ServingFrontend(batcher).start()
    try:
        if not engine.warmed:
            post(frontend.url(), {"prompt": [1, 2, 3], "max_new_tokens": 2})  # first-call set-up
        reset_counts(counters)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
            replies = list(pool.map(lambda b: post(frontend.url(), b), requests))
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        launches.update({f"{k}_{v}": getattr(counters[k], f"{v}_launches")
                         for k in ("flash_decode", "paged_decode")
                         for v in ("tensor_core", "simt", "split")
                         if hasattr(counters[k], f"{v}_launches")})
        health = json.loads(urllib.request.urlopen(frontend.url("/health"), timeout=60).read())
        line = batcher.stats_line()
    finally:
        frontend.close()
        batcher.close(drain=False)
    if health["post_warmup_recompiles"] != engine.post_warmup_recompiles():
        fail(f"/health post_warmup_recompiles {health['post_warmup_recompiles']} != the engine's")
    return replies, wall, launches, line


def check_streams(torch, name, engine, requests, replies, vocab) -> tuple[int, int]:
    """Every stream against the engine's own cacheless reference_generate
    on the card (quantized weights: the same dequantized weights): exact,
    or first differing at a near-tie; with a quantized KV cache (which the
    cacheless reference does not have), first token exact and >= 75%
    agreement. Returns (exact, near-tie) counts."""
    exact = ties = 0
    for body, reply in zip(requests, replies):
        toks = reply["tokens"]
        if len(toks) != body["max_new_tokens"] or not all(0 <= t < vocab for t in toks):
            fail(f"serve[{name}]: malformed stream {toks!r}")
        ref = engine.reference_generate(body["prompt"], max_new=body["max_new_tokens"],
                                        seed=body["seed"])
        if getattr(engine.pool, "quantized", False):
            agree = sum(a == b for a, b in zip(toks, ref)) / len(ref)
            if toks[0] != ref[0] or agree < 0.75:
                fail(f"serve[{name}] prompt_len={len(body['prompt'])}: quantized-KV stream "
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
    return exact, ties


def phase_serving(torch, model, model_cfg, counters, smi: str) -> list[dict]:
    from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
    from tensorflow_examples_torch.telemetry.registry import MetricsRegistry

    rng = np.random.default_rng(0)
    prompt_lens = [5, 17, 40, 64, 100, 150, 230, 300]
    requests = [
        {"prompt": [int(t) for t in rng.integers(0, model_cfg.vocab_size, n)],
         "max_new_tokens": int(rng.integers(16, 33)), "seed": i}
        for i, n in enumerate(prompt_lens)
    ]
    # Prompts that repeat a motif (3-8 tokens), so the n-gram drafter's
    # drafts are accepted; 32 new tokens each.
    motif_requests = []
    for i, n in enumerate(prompt_lens):
        motif = [int(t) for t in rng.integers(0, model_cfg.vocab_size, 3 + i % 6)]
        motif_requests.append({"prompt": (motif * (n // len(motif) + 1))[:n],
                               "max_new_tokens": 32, "seed": i})
    configs = (  # name, config, kernel launched while serving, warmed before traffic
        ("dense_flash", ServeConfig(max_slots=8, attention="flash"), "flash_decode", False),
        ("paged_flash", ServeConfig(max_slots=8, kv_block_size=16, attention="paged_flash"),
         "paged_decode", False),
        ("paged_flash_int8", ServeConfig(max_slots=8, kv_block_size=16, attention="paged_flash",
                                         kv_dtype="int8"), "paged_decode", False),
        ("paged_flash_int8_spec_chunked", ServeConfig(
            max_slots=8, kv_block_size=16, attention="paged_flash", kv_dtype="int8",
            spec_decode_k=4, prefill_chunk_tokens=64), "paged_decode", True),
        ("dense_flash_spec", ServeConfig(max_slots=8, attention="flash", spec_decode_k=4),
         "flash_decode", True),
        ("weights_int8", ServeConfig(max_slots=8, weight_dtype="int8"), None, True),
        ("weights_fp8_kv_fp8", ServeConfig(max_slots=8, kv_block_size=16, weight_dtype="fp8",
                                           kv_dtype="fp8"), None, True),
    )
    summaries = []
    for name, serve_cfg, kernel, warmed in configs:
        reqs = motif_requests if warmed else requests
        engine = InferenceEngine(model_cfg, model, cfg=serve_cfg, registry=MetricsRegistry())
        summary = dict(config=name)
        if warmed:
            t0 = time.perf_counter()
            counts = engine.warmup()
            if sum(counts.values()) != engine.expected_compiles():
                fail(f"serve[{name}]: warmup ran {counts}, expected {engine.expected_compiles()}")
            summary.update(warmup_s=time.perf_counter() - t0, rungs=sum(counts.values()),
                           graphs_captured=sum(len(t) for t in engine.graph_tallies().values()))
        replies, wall, launches, line = serve_http(engine, reqs, counters)
        if kernel is not None and launches[kernel] < 1:
            fail(f"serve[{name}]: the {kernel} kernel was launched no time while serving")
        if kernel == "flash_decode" and (launches["flash_decode_simt"], launches[
                "flash_decode_tensor_core"]) != (launches["flash_decode"], 0):
            fail(f"serve[{name}]: f32 flash-decode launches off the SIMT route: {launches}")
        exact, ties = check_streams(torch, name, engine, reqs, replies, model_cfg.vocab_size)
        generated = sum(len(r["tokens"]) for r in replies)
        ttft = [r["ttft_s"] for r in replies]
        tpot = [(r["total_s"] - r["ttft_s"]) / (len(r["tokens"]) - 1) for r in replies]
        counters_now = engine.registry.counter_values()
        summary.update(
            requests=len(reqs), generated_tokens=generated, wall_s=wall,
            tok_per_s=generated / wall, ttft_p50_s=float(np.median(ttft)),
            tpot_p50_s=float(np.median(tpot)), exact_streams=exact, near_tie_streams=ties,
            launches=launches, post_warmup_recompiles=engine.post_warmup_recompiles(),
            decode_steps=counters_now.get("serving/decode_steps", 0),
            spec_accepted=counters_now.get("serving/spec_accepted_total", 0),
            spec_drafted=counters_now.get("serving/spec_drafted_total", 0),
            chunked_prefills=counters_now.get("serving/chunked_prefills", 0),
        )
        if warmed:
            if engine.post_warmup_recompiles() != 0:
                fail(f"serve[{name}]: {engine.post_warmup_recompiles()} recompiles after warmup")
            if serve_cfg.spec_decode_k and not summary["spec_accepted"] > 0:
                fail(f"serve[{name}]: no draft was accepted")
            if serve_cfg.prefill_chunk_tokens and not summary["chunked_prefills"] > 0:
                fail(f"serve[{name}]: no prefill was chunked")
            if serve_cfg.weight_dtype:
                summary["byte_breakdown"] = engine.byte_breakdown()
                summary["serving_line_precision"] = {
                    k: line["serving"][k] for k in ("weight_bits", "param_bytes",
                                                    "param_bytes_f32", "quantized_params")}
            # The same config eager: every rung without a CUDA graph.
            eager = InferenceEngine(model_cfg, model, cfg=serve_cfg, registry=MetricsRegistry(),
                                    cuda_graphs=False)
            eager.warmup()
            e_replies, e_wall, _, _ = serve_http(eager, reqs, counters)
            if [r["tokens"] for r in e_replies] != [r["tokens"] for r in replies]:
                check_streams(torch, name + "/eager", eager, reqs, e_replies,
                              model_cfg.vocab_size)
            prompts = [b["prompt"] for b in reqs]
            summary.update(
                eager_tok_per_s=sum(len(r["tokens"]) for r in e_replies) / e_wall,
                decode_step_wall_ms_graphs=decode_wall(torch, engine, prompts),
                decode_step_wall_ms_eager=decode_wall(torch, eager, prompts),
                eager_post_warmup_recompiles=eager.post_warmup_recompiles(),
                card=smi,
            )
            del eager
        log(f"serve[{name}]: {json.dumps(summary)}")
        profile = device_breakdown(torch, engine, reqs)
        step = profile["decode"]
        if engine.cuda_graphs and step["paged_kernel_launches_profiled"] != \
                step["paged_kernel_launches_counted"]:
            fail(f"serve[{name}]: the graph replays' paged-kernel tally "
                 f"{step['paged_kernel_launches_counted']} != the profiler's "
                 f"{step['paged_kernel_launches_profiled']}")
        if kernel == "paged_decode" and not step["paged_kernel_launches_counted"] > 0:
            fail(f"serve[{name}]: no paged-kernel launch counted from the graph replays")
        log(f"profile[{name}] (per prefill / per decode step, ms): {json.dumps(profile)}")
        summaries.append(summary)
        del engine
        torch.cuda.empty_cache()
    return summaries


# ---------------------------------------------------------- phase 5b


REPLICA_LENGTHS = (17, 100, 700)     # hand-off prompts, each greedy and sampled
REPLICA_NEW = 16                     # tokens a hand-off request generates
REPLICA_SAMPLING = (("greedy", {}), ("sampled", {"temperature": 0.8, "top_k": 40}))
# The KV dtypes of the hand-off rounds and their attention: the fused
# paged kernel dequantizes int8 in the kernel; fp8 KV decodes through the
# gather path (the engine refuses paged_flash with fp8), its prefill still
# through flash-decode.
REPLICA_ROUNDS = (("f32", dict(attention="paged_flash")),
                  ("int8", dict(attention="paged_flash", kv_dtype="int8")),
                  ("fp8", dict(attention="flash", kv_dtype="fp8")))
REPLICA_BASE = dict(max_slots=8, kv_block_size=16, prefix_cache=True)
SHARED_PREFIX = 256                  # the delta hand-off's shared prompt prefix


def http_json(url: str, body=None, timeout: float = 600.0) -> tuple[int, dict, float]:
    """(status, reply, wall seconds) of a GET (``body`` None) or a JSON
    POST; an HTTP error status is a result, not an exception."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    return status, json.loads(raw or b"{}"), time.perf_counter() - t0


class ReplicaStack:
    """One port replica in this process: engine (warmed unless asked not
    to), batcher and frontend on a loopback port."""

    def __init__(self, model_cfg, model, name: str, *, warm: bool = True, **serve_kw):
        from tensorflow_examples_torch.serving.batcher import ContinuousBatcher
        from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
        from tensorflow_examples_torch.serving.frontend import ServingFrontend
        from tensorflow_examples_torch.telemetry.registry import MetricsRegistry

        self.name = name
        self.engine = InferenceEngine(model_cfg, model, cfg=ServeConfig(**serve_kw),
                                      registry=MetricsRegistry())
        self.warmup_s = None
        if warm:
            t0 = time.perf_counter()
            counts = self.engine.warmup()
            self.warmup_s = time.perf_counter() - t0
            if sum(counts.values()) != self.engine.expected_compiles():
                fail(f"replica[{name}]: warmup ran {counts}")
        self.batcher = ContinuousBatcher(self.engine).start()
        self.frontend = ServingFrontend(self.batcher).start()

    def post(self, path: str, body: dict):
        return http_json(self.frontend.url(path), body)

    def get(self, path: str) -> dict:
        status, reply, _ = http_json(self.frontend.url(path))
        if status != 200:
            fail(f"replica[{self.name}]: GET {path} answered {status}: {reply}")
        return reply

    def counter(self, name: str) -> int:
        return int(self.engine.registry.counter_values().get(name, 0))

    def close(self) -> None:
        self.frontend.close()
        self.batcher.close(drain=False)


def expect(result, want: int, what: str) -> dict:
    """The reply of ``result`` (an :func:`http_json` triple); fails unless
    its status is ``want``."""
    status, reply, _ = result
    if status != want:
        fail(f"replica: {what} answered {status}, expected {want}: {str(reply)[:300]}")
    return reply


def page_bytes(pages: dict) -> int:
    """The payload's array bytes before base64."""
    total = 0
    for spec in pages["arrays"].values():
        item = {"float32": 4, "bfloat16": 2, "float16": 2}.get(spec["dtype"], 1)
        total += item * int(np.prod(spec["shape"]))
    return total


def handoff_round(torch, model, model_cfg, counters, smi, label, kw, rng, saved) -> dict:
    """One KV dtype's round: mixed, prefill and decode stacks; every
    prompt length greedy and sampled, the hand-off against the mixed
    stack's stream; which kernel each leg launched; the 700-token
    prompt's export and import times and payload bytes. The f32 round
    also runs the delta hand-off and keeps a payload for the geometry
    checks of later rounds."""
    layers = model_cfg.num_layers
    stacks = {role: ReplicaStack(model_cfg, model, f"{label}/{role}", role=role,
                                 **REPLICA_BASE, **kw)
              for role in ("mixed", "prefill", "decode")}
    paged_kernel = kw["attention"] == "paged_flash"
    out = {"warmup_s": {r: s.warmup_s for r, s in stacks.items()}, "cases": []}
    try:
        for n in REPLICA_LENGTHS:
            for mode, sampling in REPLICA_SAMPLING:
                prompt = [int(t) for t in rng.integers(0, model_cfg.vocab_size, n)]
                body = {"prompt": prompt, "max_new_tokens": REPLICA_NEW,
                        "seed": int(rng.integers(0, 1000)), **sampling}
                mixed = expect(stacks["mixed"].post("/generate", body), 200, "mixed /generate")
                flash0 = counters["flash_decode"].launches
                result = stacks["prefill"].post("/prefill", body)
                pre, pre_wall = expect(result, 200, f"{label} /prefill"), result[2]
                flash_pre = counters["flash_decode"].launches - flash0
                if flash_pre < layers:
                    fail(f"replica[{label}]: the prefill stack's cold {n}-token prefill launched "
                         f"flash_decode {flash_pre} times, fewer than once a layer ({layers})")
                steps0 = stacks["decode"].counter("serving/decode_steps")
                paged0 = counters["paged_decode"].launches
                flash0 = counters["flash_decode"].launches
                result = stacks["decode"].post(
                    "/resume", {**body, "pages": pre["pages"], "first_token": pre["first_token"]})
                res, res_wall = expect(result, 200, f"{label} /resume"), result[2]
                steps = stacks["decode"].counter("serving/decode_steps") - steps0
                paged = counters["paged_decode"].launches - paged0
                if counters["flash_decode"].launches != flash0:
                    fail(f"replica[{label}]: the decode stack ran a prefill on a resume")
                if paged_kernel and paged < steps * layers:
                    fail(f"replica[{label}]: {paged} paged_decode launches for {steps} decode "
                         f"steps of {layers} layers on imported pages")
                if res["tokens"] != mixed["tokens"]:
                    fail(f"replica[{label}] {n} tokens {mode}: hand-off stream {res['tokens']} "
                         f"!= the mixed stack's {mixed['tokens']}")
                case = {"n": n, "mode": mode, "flash_decode_prefill": flash_pre,
                        "decode_steps": steps, "paged_decode": paged,
                        "mixed_ttft_s": mixed["ttft_s"],
                        "handoff_ttft_s": pre["total_s"] + res["ttft_s"],
                        "handoff_ttft_wall_s": (pre_wall + res_wall
                                                - (res["total_s"] - res["ttft_s"])),
                        "payload_bytes": page_bytes(pre["pages"])}
                out["cases"].append(case)
                if label == "f32" and n == REPLICA_LENGTHS[0] and mode == "greedy":
                    saved["f32_pages"] = (body, pre)
        if label != "f32":
            body, pre = saved["f32_pages"]
            status, reply, _ = stacks["decode"].post(
                "/resume", {**body, "pages": pre["pages"], "first_token": pre["first_token"]})
            if status != 400 or "pages geometry mismatch: kv_bits=32" not in reply.get("error", ""):
                fail(f"replica[{label}]: f32 pages into a {label} stack answered {status} {reply}")
            out["kv_dtype_mismatch"] = reply["error"]
        out["timing_700"] = handoff_pieces(torch, stacks, model_cfg, label, rng, smi)
        log(f"replica[{label}] cases: {json.dumps(out['cases'])}")
        big = [c for c in out["cases"] if c["n"] == REPLICA_LENGTHS[-1]]
        log(f"replica[{label}] TTFT, 700-token prompts (replica-measured): hand-off "
            f"{[round(c['handoff_ttft_s'], 6) for c in big]} s (prefill total + resume ttft; "
            f"client wall {[round(c['handoff_ttft_wall_s'], 6) for c in big]}) vs mixed "
            f"{[round(c['mixed_ttft_s'], 6) for c in big]} s; {smi}")
        if label == "f32":
            out["delta"] = delta_handoff(stacks, model_cfg, rng)
            other = ReplicaStack(model_cfg, model, "f32/block32", warm=False, max_slots=2,
                                 kv_block_size=32, prefill_bucket_floor=32,
                                 attention="paged_flash")
            try:
                body, pre = saved["f32_pages"]
                status, reply, _ = other.post(
                    "/resume", {**body, "pages": pre["pages"], "first_token": pre["first_token"]})
            finally:
                other.close()
            if status != 400 or reply.get("error") != ("pages geometry mismatch: block_size=16 "
                                                       "but this replica serves block_size=32"):
                fail(f"replica: block-16 pages into a block-32 stack answered {status} {reply}")
            out["block_size_mismatch"] = reply["error"]
            out["slo"] = slo_preemption(stacks["mixed"], model_cfg, rng)
        for role, stack in stacks.items():
            recompiles = stack.get("/health")["post_warmup_recompiles"]
            if recompiles != 0:
                fail(f"replica[{label}/{role}]: {recompiles} recompiles after warmup")
    finally:
        for stack in stacks.values():
            stack.close()
        del stacks
        gc.collect()
        torch.cuda.empty_cache()
    return out


def handoff_pieces(torch, stacks, model_cfg, label, rng, smi) -> dict:
    """A 700-token prompt's hand-off in pieces, in process while the
    stacks are idle: export (device gather, host copy, base64), the JSON
    text, and decode + import (the in-place block writes); and the
    payload's bytes."""
    prompt = [int(t) for t in rng.integers(0, model_cfg.vocab_size, REPLICA_LENGTHS[-1])]
    pre_eng, dec_eng = stacks["prefill"].engine, stacks["decode"].engine
    slot = pre_eng.pool.alloc()
    pre_eng.prefill(slot, prompt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pages = pre_eng.export_kv_pages(slot, prompt)
    t1 = time.perf_counter()
    wire = json.dumps(pages)
    t2 = time.perf_counter()
    pre_eng.pool.free(slot)
    slot = dec_eng.pool.alloc()
    t3 = time.perf_counter()
    dec_eng.import_kv_pages(slot, json.loads(wire), prompt)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    dec_eng.pool.free(slot)
    raw = page_bytes(pages)
    out = {"export_encode_ms": (t1 - t0) * 1e3, "json_dumps_ms": (t2 - t1) * 1e3,
           "decode_import_ms": (t4 - t3) * 1e3, "payload_bytes": raw,
           "bytes_per_prompt_token": raw / len(prompt), "wire_bytes": len(wire), "card": smi}
    log(f"replica[{label}] timing, 700-token prompt: export+encode {out['export_encode_ms']:.3f} "
        f"ms, json.dumps {out['json_dumps_ms']:.3f} ms, decode+import (json.loads included) "
        f"{out['decode_import_ms']:.3f} ms; payload {raw} B before base64 = "
        f"{raw / len(prompt):.1f} B a prompt token, {len(wire)} B on the wire; {smi}")
    return out


def delta_handoff(stacks, model_cfg, rng) -> dict:
    """Two prompts sharing a 256-token prefix: the second's prefill skips
    what the decode stack's /health digest covers, the payload starts at
    a later block and the stream still equals the mixed stack's."""
    from tensorflow_examples_torch.serving import scheduler

    prefix = [int(t) for t in rng.integers(0, model_cfg.vocab_size, SHARED_PREFIX)]
    out = {}
    for i, tail_len in enumerate((20, 37)):
        prompt = prefix + [int(t) for t in rng.integers(0, model_cfg.vocab_size, tail_len)]
        body = {"prompt": prompt, "max_new_tokens": REPLICA_NEW, "seed": 3 + i,
                "temperature": 0.8, "top_k": 40}
        health = stacks["decode"].get("/health")
        keys = scheduler.prompt_chain_keys(prompt, health["prefix_block_size"])
        skip = scheduler.affinity_blocks(keys, frozenset(health["prefix_digest"])) \
            * health["prefix_block_size"]
        mixed = expect(stacks["mixed"].post("/generate", body), 200, "delta /generate")
        pre = expect(stacks["prefill"].post("/prefill", {**body, "skip_tokens": skip}),
                     200, "delta /prefill")
        res = expect(stacks["decode"].post("/resume", {**body, "pages": pre["pages"],
                                                       "first_token": pre["first_token"]}),
                     200, "delta /resume")
        start = pre["pages"].get("start_block", 0)
        if res["tokens"] != mixed["tokens"]:
            fail(f"replica delta #{i}: hand-off {res['tokens']} != mixed {mixed['tokens']}")
        if i == 1 and not (skip == SHARED_PREFIX and start == SHARED_PREFIX // 16):
            fail(f"replica delta: skip {skip}, start_block {start}; expected the shared "
                 f"{SHARED_PREFIX}-token prefix skipped")
        out[f"request_{i}"] = {"skip_tokens": skip, "start_block": start,
                               "blocks_shipped": pre["pages"]["arrays"]["k"]["shape"][1],
                               "payload_bytes": page_bytes(pre["pages"])}
    log(f"replica delta hand-off: {json.dumps(out)}")
    return out


def slo_preemption(stack, model_cfg, rng) -> dict:
    """Fill the slots with batch requests, then send interactive ones:
    at least one batch request is preempted, and every batch stream equals
    the one it gets when served alone."""
    slots = REPLICA_BASE["max_slots"]
    batch = [{"prompt": [int(t) for t in rng.integers(0, model_cfg.vocab_size, 30 + i)],
              "max_new_tokens": 200, "seed": i, "slo": "batch",
              **({"temperature": 0.8, "top_k": 40} if i % 2 else {})} for i in range(slots)]
    inter = [{"prompt": [int(t) for t in rng.integers(0, model_cfg.vocab_size, 12)],
              "max_new_tokens": 8, "seed": 100 + i} for i in range(slots // 2)]
    before = stack.get("/window")["serving"]["preempted_batch"]
    with concurrent.futures.ThreadPoolExecutor(len(batch) + len(inter)) as pool:
        futs = [pool.submit(stack.post, "/generate", b) for b in batch]
        deadline = time.monotonic() + 60
        while stack.get("/health")["active_requests"] < slots:
            if time.monotonic() > deadline or all(f.done() for f in futs):
                fail("replica slo: the batch requests never filled the slots")
            time.sleep(0.002)
        ifuts = [pool.submit(stack.post, "/generate", b) for b in inter]
        replies = [f.result() for f in futs + ifuts]
    for result in replies:
        expect(result, 200, "slo /generate")
    preempted = stack.get("/window")["serving"]["preempted_batch"] - before
    if preempted < 1:
        fail("replica slo: no batch request was preempted for interactive traffic")
    for body, (_, reply, _) in zip(batch, replies):
        alone = expect(stack.post("/generate", body), 200, "slo solo /generate")
        if alone["tokens"] != reply["tokens"]:
            fail(f"replica slo: a batch stream {reply['tokens'][:8]}... differs from its "
                 f"solo run {alone['tokens'][:8]}...")
    out = {"preempted_batch": preempted,
           "interactive_e2e_max_s": max(r[1]["total_s"] for r in replies[slots:]),
           "batch_e2e_min_s": min(r[1]["total_s"] for r in replies[:slots])}
    log(f"replica slo: {json.dumps(out)}")
    return out


def brownout_check(model, model_cfg, rng, smi) -> dict:
    """An open-loop burst on a brownout stack raises the level; batch is
    shed with 503 while interactive gets 200; the level clears."""
    stack = ReplicaStack(model_cfg, model, "brownout", attention="paged_flash", max_slots=8,
                         kv_block_size=16, brownout=True, brownout_queue_hi=4,
                         brownout_hold_s=2.0)
    try:
        burst = [{"prompt": [int(t) for t in rng.integers(0, model_cfg.vocab_size, 20)],
                  "max_new_tokens": 32, "seed": i} for i in range(24)]
        with concurrent.futures.ThreadPoolExecutor(len(burst) + 2) as pool:
            futs = [pool.submit(stack.post, "/generate", b) for b in burst]
            deadline = time.monotonic() + 30
            while (level := stack.get("/health")["brownout_level"]) < 1:
                if time.monotonic() > deadline or all(f.done() for f in futs):
                    fail("replica brownout: the burst never raised the brownout level")
                time.sleep(0.002)
            shed = [stack.post("/generate", {**burst[0], "slo": "batch"}) for _ in range(2)]
            interactive = stack.post("/generate", {**burst[1], "max_new_tokens": 4})
            replies = [f.result() for f in futs]
        for status, reply, _ in shed:
            if status != 503 or not reply.get("shed"):
                fail(f"replica brownout: a batch request at level >= 1 answered {status} {reply}")
        expect(interactive, 200, "brownout interactive /generate")
        for result in replies:
            expect(result, 200, "brownout burst /generate")
        t0 = time.monotonic()
        while (health := stack.get("/health"))["brownout_level"] != 0:
            if time.monotonic() - t0 > 60:
                fail(f"replica brownout: level {health['brownout_level']} did not clear")
            time.sleep(0.05)
        line = stack.get("/window")["serving"]
        out = {"level_seen": level, "max_level": max(line["brownout_level"], level),
               "transitions": line["brownout_transitions"], "shed_batch": line["shed_batch"],
               "shed_interactive": line["shed_interactive"],
               "truncated_brownout": sum(r[1].get("truncated") == "brownout" for r in replies),
               "clear_s": time.monotonic() - t0, "card": smi}
        if out["shed_interactive"] or out["shed_batch"] < 2:
            fail(f"replica brownout: shed counters {out}")
    finally:
        stack.close()
    log(f"replica brownout: {json.dumps(out)}")
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def free_port_pair() -> int:
    """A port p with p + 1 free too (the fleet CLI spawns replicas on
    consecutive ports from its base)."""
    import socket

    for _ in range(100):
        p = free_port()
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", p + 1))
            except OSError:
                continue
        return p
    fail("no two consecutive free ports")


def serve_cli_drain(here: str, model_cfg, rng, smi) -> dict:
    """The serving CLI as a process on the card (2 layers at full width):
    requests in flight at SIGTERM finish with 200, the process exits 0 and
    its serving.jsonl holds schema-14 lines."""
    import signal
    import threading

    port = free_port()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as stats_dir:
        cmd = [sys.executable, "-m", "tensorflow_examples_torch.serve", "--num_layers", "2",
               "--port", str(port), "--stats_every", "0.5", "--stats_dir", stats_dir,
               "--kv_block_size", "16", "--attention", "paged_flash", "--max_slots", "4"]
        log_path = os.path.join(stats_dir, "serve.log")
        with open(log_path, "w") as log_file:
            proc = subprocess.Popen(cmd, cwd=here, stdout=log_file, stderr=subprocess.STDOUT)
        url = f"http://127.0.0.1:{port}"
        try:
            t0 = time.monotonic()
            while True:
                if proc.poll() is not None:
                    fail(f"serve CLI exited {proc.returncode} before serving: "
                         f"{open(log_path).read()[-2000:]}")
                try:
                    if http_json(url + "/health", timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                if time.monotonic() - t0 > 300:
                    fail("serve CLI not healthy after 300 s")
                time.sleep(0.2)
            ready_s = time.monotonic() - t0
            bodies = [{"prompt": [int(t) for t in rng.integers(0, model_cfg.vocab_size, 10)],
                       "max_new_tokens": 1000, "seed": i} for i in range(2)]
            replies: list = [None, None]

            def run(i):
                replies[i] = http_json(url + "/generate", bodies[i])

            threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            while http_json(url + "/health", timeout=5)[1].get("active_requests", 0) < 2:
                if not any(t.is_alive() for t in threads):
                    fail("serve CLI: the requests finished before both were in flight")
                time.sleep(0.002)
            recompiles = http_json(url + "/health", timeout=5)[1]["post_warmup_recompiles"]
            proc.send_signal(signal.SIGTERM)
            for t in threads:
                t.join(timeout=120)
            code = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if code != 0:
            fail(f"serve CLI exited {code} after SIGTERM: {open(log_path).read()[-2000:]}")
        for i, reply in enumerate(replies):
            if reply is None or reply[0] != 200 or len(reply[1]["tokens"]) != 1000:
                fail(f"serve CLI: in-flight request {i} at SIGTERM answered "
                     f"{None if reply is None else (reply[0], str(reply[1])[:200])}")
        with open(os.path.join(stats_dir, "serving.jsonl")) as f:
            lines = [json.loads(line) for line in f if line.strip()]
    good = [ln for ln in lines if ln.get("schema_version") == 14 and ln.get("kind") == "serving"]
    if not good:
        fail(f"serve CLI: serving.jsonl holds no schema-14 serving line ({len(lines)} lines)")
    if recompiles != 0:
        fail(f"serve CLI: {recompiles} recompiles after warmup")
    out = {"ready_s": ready_s, "exit_code": code, "serving_lines": len(good),
           "generated": [len(r[1]["tokens"]) for r in replies], "card": smi}
    log(f"replica serve CLI drain: {json.dumps(out)}")
    return out


def phase_replica(torch, model, model_cfg, counters, smi: str, here: str) -> dict:
    """The serving replica process: the prefill -> decode hand-off over
    HTTP between port stacks in f32, int8 and fp8 KV against a mixed
    stack, the delta hand-off, geometry refusals, SLO preemption,
    brownout and the CLI's drain. Returns the launch counts of the
    phase."""
    rng = np.random.default_rng(21)
    saved: dict = {}
    reset_counts(counters)
    t0 = time.perf_counter()
    rounds = {label: handoff_round(torch, model, model_cfg, counters, smi, label, kw, rng, saved)
              for label, kw in REPLICA_ROUNDS}
    brownout = brownout_check(model, model_cfg, rng, smi)
    launches = {k: counters[k].launches for k in ("flash_decode", "paged_decode")}
    if min(launches.values()) < 1:
        fail(f"replica: a kernel of the path was launched no time: {launches}")
    cli = serve_cli_drain(here, model_cfg, rng, smi)
    summary = {"launches": launches, "wall_s": time.perf_counter() - t0,
               "bytes_per_prompt_token": {k: r["timing_700"]["bytes_per_prompt_token"]
                                          for k, r in rounds.items()},
               "rounds": {k: {key: v for key, v in r.items() if key != "cases"}
                          for k, r in rounds.items()},
               "brownout": brownout, "cli": cli, "card": smi}
    log(f"replica: {json.dumps(summary)}")
    return summary


# ------------------------------------------------------------ the fleet

FLEET_BASE = dict(max_slots=8, kv_block_size=16, prefix_cache=True, attention="paged_flash")
FLEET_LENGTHS = (17, 100, 700)       # routed prompts, each greedy and sampled
FLEET_NEW = 32                       # tokens a fleet request generates
FLEET_BATCH, FLEET_INTERACTIVE = 8, 4


def fleet_router(urls, tmp: str, name: str, **kw):
    """A port router over ``urls`` on a loopback frontend, every trace
    kept into ``<tmp>/<name>.traces``, a journal at ``<tmp>/<name>.journal``."""
    from tensorflow_examples_torch.serving.journal import RequestJournal
    from tensorflow_examples_torch.serving.router import Router, RouterConfig, RouterFrontend
    from tensorflow_examples_torch.telemetry.registry import MetricsRegistry

    journal = RequestJournal(os.path.join(tmp, f"{name}.journal"))
    router = Router(urls, registry=MetricsRegistry(), journal=journal,
                    trace_path=os.path.join(tmp, f"{name}.traces"),
                    cfg=RouterConfig(probe_interval_s=0.1, trace_sample_fraction=1.0), **kw)
    router.start()
    front = RouterFrontend(router).start()
    return router, front, journal


def ttft_wall(result) -> float:
    """Client-side seconds to the first token of a non-streaming reply:
    its wall less the replica-measured decode time after the first token."""
    _, reply, wall = result
    return wall - (reply["total_s"] - reply["ttft_s"])


def fleet_bodies(model_cfg, rng, name: str) -> dict:
    """The fleet's traffic: prompts of 17, 100 and 700 tokens greedy and
    sampled, two sharing a 256-token prefix, and 8 batch + 4 interactive
    requests sent together; each with a request id."""
    vocab = model_cfg.vocab_size
    bodies = {}
    for n in FLEET_LENGTHS:
        for mode, sampling in REPLICA_SAMPLING:
            bodies[f"{n}/{mode}"] = {
                "prompt": [int(t) for t in rng.integers(0, vocab, n)],
                "max_new_tokens": FLEET_NEW, "seed": int(rng.integers(0, 1000)), **sampling}
    prefix = [int(t) for t in rng.integers(0, vocab, SHARED_PREFIX)]
    for i, tail in enumerate((20, 37)):
        bodies[f"prefix/{i}"] = {"prompt": prefix + [int(t) for t in rng.integers(0, vocab, tail)],
                                 "max_new_tokens": FLEET_NEW, "seed": 50 + i,
                                 "temperature": 0.8, "top_k": 40}
    for i in range(FLEET_BATCH + FLEET_INTERACTIVE):
        bodies[f"mix/{i}"] = {
            "prompt": [int(t) for t in rng.integers(0, vocab, 24 + 3 * i)],
            "max_new_tokens": FLEET_NEW, "seed": 100 + i,
            "slo": "batch" if i < FLEET_BATCH else "interactive",
            **({"temperature": 0.8, "top_k": 40} if i % 2 else {})}
    return {k: {**b, "request_id": f"{name}-{k}"} for k, b in bodies.items()}


def drive_fleet(front_url: str, bodies: dict, *, mix: bool = True) -> dict:
    """Every body through the router: the single prompts one at a time,
    the shared-prefix pair with a probe sweep between (the second must
    find the first's blocks), the batch + interactive mix together."""
    out = {}
    for key, body in bodies.items():
        if key.startswith(("mix/", "prefix/1")):
            continue
        out[key] = http_json(front_url, body)
    time.sleep(0.5)
    out["prefix/1"] = http_json(front_url, bodies["prefix/1"])
    mix = [k for k in bodies if k.startswith("mix/")] if mix else []
    if not mix:
        return out
    with concurrent.futures.ThreadPoolExecutor(len(mix)) as pool:
        for key, result in zip(mix, pool.map(lambda k: http_json(front_url, bodies[k]), mix)):
            out[key] = result
    return out


def check_same_tokens(what: str, routed: dict, direct: dict) -> None:
    for key, result in routed.items():
        got = expect(result, 200, f"fleet {what} {key}")["tokens"]
        want = expect(direct[key], 200, f"fleet direct {key}")["tokens"]
        if got != want:
            fail(f"fleet {what} {key}: routed tokens {got[:8]}... != direct {want[:8]}...")


def check_trace_trees(path: str, want_names: set, what: str) -> dict:
    """Every kept trace in ``path`` (the port's ``read_traces``) is one
    tree: one root, every parent present; returns coverage counts."""
    from tensorflow_examples_torch.telemetry import schema, tracing

    traces = tracing.read_traces(path)
    if not traces:
        fail(f"fleet {what}: no kept trace in {path}")
    names: set = set()
    for tid, doc in traces.items():
        ids = {s["span_id"] for s in doc["spans"]}
        roots = [s for s in doc["spans"] if not s.get("parent_id")]
        orphans = [s["name"] for s in doc["spans"] if s.get("parent_id") and s["parent_id"]
                   not in ids]
        if len(roots) != 1 or orphans:
            fail(f"fleet {what}: trace {tid} has roots {[s['name'] for s in roots]} and "
                 f"orphans {orphans}")
        names |= {s["name"] for s in doc["spans"]}
    if not want_names <= names:
        fail(f"fleet {what}: traces lack spans {sorted(want_names - names)}: {sorted(names)}")
    with open(path) as f:
        for line in f:
            problems = schema.validate_line(json.loads(line))
            if problems:
                fail(f"fleet {what}: trace line refused: {problems}")
    return {"traces": len(traces), "spans": sum(len(d["spans"]) for d in traces.values()),
            "span_names": sorted(names)}


def check_router_line(router, what: str) -> dict:
    from tensorflow_examples_torch.telemetry import schema

    line = json.loads(json.dumps(router.stats_line()))
    problems = schema.validate_line(line)
    if problems:
        fail(f"fleet {what}: the router's serving line is refused: {problems}")
    missing = [k for k in (*schema.SERVING_KEYS_V12, *schema.SERVING_KEYS_V13,
                           *schema.SERVING_KEYS_V14) if k not in line["serving"]]
    if missing:
        fail(f"fleet {what}: the router's serving line lacks {missing}")
    return line["serving"]


def fleet_routed(model, model_cfg, counters, rng, smi, tmp) -> dict:
    """(a) two mixed stacks behind the router, and (b) a prefill and a
    decode stack behind another; (c) their traces and serving lines."""
    bodies = fleet_bodies(model_cfg, rng, "a")
    stacks = [ReplicaStack(model_cfg, model, f"fleet/mixed{i}", **FLEET_BASE) for i in range(2)]
    roles = {role: ReplicaStack(model_cfg, model, f"fleet/{role}", role=role, **FLEET_BASE)
             for role in ("prefill", "decode")}
    out = {}
    try:
        router, front, journal = fleet_router([s.frontend.url("") for s in stacks], tmp, "a")
        try:
            reset_counts(counters)
            routed = drive_fleet(front.url("/generate"), bodies)
            out["routed_launches"] = {k: counters[k].launches
                                      for k in ("flash_decode", "paged_decode")}
            if min(out["routed_launches"].values()) < 1:
                fail(f"fleet: a kernel of the routed path was launched no time: "
                     f"{out['routed_launches']}")
            holder = max(stacks, key=lambda s: s.get("/health")["prefix_hit_rate"])
            hits = router.registry.counter_values().get("router/affinity_hits_total", 0)
            if holder.get("/health")["prefix_hit_rate"] <= 0 or hits < 1:
                fail(f"fleet (a): the shared prefix missed: affinity hits {hits}, "
                     f"hit rates {[s.get('/health')['prefix_hit_rate'] for s in stacks]}")
            direct = {k: stacks[0].post("/generate", {kk: v for kk, v in b.items()
                                                      if kk != "request_id"})
                      for k, b in bodies.items()}
            check_same_tokens("(a) mixed pair", routed, direct)
            out["mixed"] = {
                "ttft_s": {f"{n}/greedy": routed[f"{n}/greedy"][1]["ttft_s"]
                           for n in FLEET_LENGTHS},
                "router_overhead_s": [ttft_wall(routed[k]) - ttft_wall(direct[k])
                                      for k in routed if k.split("/")[0].isdigit()],
                "affinity_hits": hits, "serving": check_router_line(router, "(a)")}
            out["mixed"]["router_overhead_mean_s"] = float(np.mean(
                out["mixed"]["router_overhead_s"]))
        finally:
            front.close()
            router.close()
            journal.close()
        out["mixed"]["traces"] = check_trace_trees(
            os.path.join(tmp, "a.traces"), {"request", "dispatch", "queue_wait", "prefill",
                                            "decode_segment"}, "(c) mixed")
        bodies = fleet_bodies(model_cfg, rng, "b")
        router, front, journal = fleet_router(
            [s.frontend.url("") for s in roles.values()], tmp, "b")
        try:
            routed = drive_fleet(front.url("/generate"), bodies, mix=False)
            counts = router.registry.counter_values()
            if counts.get("router/handoffs_total", 0) < len(routed):
                fail(f"fleet (b): {counts.get('router/handoffs_total', 0)} hand-offs for "
                     f"{len(routed)} single requests")
            if counts.get("router/handoff_delta_tokens_total", 0) < SHARED_PREFIX:
                fail(f"fleet (b): the repeated prefix was not sent as a delta: {counts}")
            direct = {k: stacks[0].post("/generate", {kk: v for kk, v in bodies[k].items()
                                                      if kk != "request_id"}) for k in routed}
            check_same_tokens("(b) prefill/decode pair", routed, direct)
            out["handoff"] = {
                "ttft_s": {f"{n}/greedy": routed[f"{n}/greedy"][1]["ttft_s"]
                           for n in FLEET_LENGTHS},
                "ttft_wall_s": {f"{n}/greedy": ttft_wall(routed[f"{n}/greedy"])
                                for n in FLEET_LENGTHS},
                "handoffs": counts["router/handoffs_total"],
                "delta_tokens": counts["router/handoff_delta_tokens_total"],
                "serving": check_router_line(router, "(b)")}
        finally:
            front.close()
            router.close()
            journal.close()
        out["handoff"]["traces"] = check_trace_trees(
            os.path.join(tmp, "b.traces"), {"request", "prefill_leg", "resume_leg", "queue_wait",
                                            "prefill", "resume_import", "decode_segment"},
            "(c) hand-off")
        for stack in [*stacks, *roles.values()]:
            if stack.get("/health")["post_warmup_recompiles"] != 0:
                fail(f"fleet: {stack.name} recompiled after warmup")
    finally:
        for stack in [*stacks, *roles.values()]:
            stack.close()
    log(f"fleet (a)/(b) TTFT of greedy prompts {list(FLEET_LENGTHS)}: routed mixed "
        f"{out['mixed']['ttft_s']} s, routed hand-off {out['handoff']['ttft_s']} s (replica-"
        f"measured; client wall {out['handoff']['ttft_wall_s']}); router overhead a request "
        f"{out['mixed']['router_overhead_mean_s'] * 1e3:.3f} ms (routed minus direct TTFT, "
        f"client wall, mean of {len(out['mixed']['router_overhead_s'])}); {smi}")
    return out


def fleet_engine_factory(model, model_cfg):
    from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
    from tensorflow_examples_torch.telemetry.registry import MetricsRegistry

    return lambda: InferenceEngine(model_cfg, model, cfg=ServeConfig(**FLEET_BASE),
                                   registry=MetricsRegistry())


def failover_post(endpoints, body, timeout: float = 120.0):
    """A client of a router pair: each endpoint in turn, the same body
    (its request id), until one answers 200."""
    import http.client

    deadline = time.monotonic() + timeout
    while True:
        for url in endpoints:
            try:
                result = http_json(url, body, timeout=timeout)
            except (OSError, http.client.HTTPException):
                continue  # the dying router reset the connection or cut the reply
            if result[0] == 200 or time.monotonic() > deadline:
                return result
        time.sleep(0.05)


def fleet_chaos(model, model_cfg, rng, smi, tmp) -> dict:
    """(d) a crash mid-stream fails over and the supervisor restarts the
    replica in-process under live traffic; (e) the router pair's
    takeover; (f) a burn-rate alert under ``slowrep`` and the prober."""
    import threading

    from tensorflow_examples_torch.serving.chaos import ChaosFleet, RouterPair
    from tensorflow_examples_torch.serving.prober import CanaryProber, fleet_targets
    from tensorflow_examples_torch.serving.router import Router, RouterConfig, RouterFrontend
    from tensorflow_examples_torch.telemetry import slo
    from tensorflow_examples_torch.telemetry.registry import MetricsRegistry
    from tensorflow_examples_torch.utils import faults

    bodies = [b for k, b in fleet_bodies(model_cfg, rng, "d").items() if k.startswith("mix/")]
    for b in bodies:
        b.pop("request_id")
    cfg = RouterConfig(probe_interval_s=0.1, retry_budget_s=60.0, max_retries=4,
                       eject_after=1, eject_cooldown_s=1.0)
    fault = faults.serve_install("crash@1:6")
    fleet = ChaosFleet([fleet_engine_factory(model, model_cfg)] * 2, router_cfg=cfg,
                       supervisor_kw=dict(poll_s=0.05, health_stall_s=5.0,
                                          warm_timeout_s=120.0))
    out: dict = {}
    try:
        fleet.start()
        front = RouterFrontend(fleet.router).start()
        try:
            url = front.url("/generate")
            # Live traffic from before the crash until after the supervisor
            # has restarted replica 1 in this process (a fresh engine,
            # warmed, its decode rungs captured as CUDA graphs while
            # replica 0 keeps launching kernels).
            during: list = []
            stop = threading.Event()

            short = [{**b, "max_new_tokens": 8} for b in bodies]

            def traffic(k):
                while not stop.is_set():
                    try:
                        result = http_json(url, short[k % len(short)])
                    except Exception as e:  # noqa: BLE001 — a failure to report
                        result = (0, {"error": repr(e)}, 0.0)
                    during.append((time.monotonic(), k % len(short), result))
                    k += 4

            feeders = [threading.Thread(target=traffic, args=(k,), daemon=True) for k in range(4)]
            for feeder in feeders:
                feeder.start()
            victim, survivor = fleet.replicas[1].url, fleet.replicas[0].engine
            # supervisor event -> (when this thread saw it, the survivor's
            # decode steps then)
            seen: dict = {}
            with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
                futs = [pool.submit(http_json, url, b) for b in bodies]
                deadline = time.monotonic() + 120
                while "readmitted" not in seen and time.monotonic() < deadline:
                    for u, event in list(fleet.supervisor.events):
                        if u == victim and event not in seen:
                            seen[event] = (time.monotonic(), survivor.registry.counter_values()
                                           .get("serving/decode_steps", 0))
                    time.sleep(0.002)
                crashed = [f.result() for f in futs]
            time.sleep(0.5)
            stop.set()
            for feeder in feeders:
                feeder.join(timeout=120)
            if ("crash", 1, 6) not in fault.fired:
                fail(f"fleet (d): the crash did not fire: {fault.fired}")
            events = [e for u, e in fleet.supervisor.events if u == victim]
            if events[:3] != ["detected", "restarted", "readmitted"] or not \
                    fleet.await_fleet_green(2, timeout_s=30):
                fail(f"fleet (d): the supervisor did not bring replica 1 back: {events}")
            bad = [str(r[:2])[:200] for _, _, r in during if r[0] != 200]
            window = (seen["detected"][0], seen["readmitted"][0])
            steps = seen["readmitted"][1] - seen["detected"][1]
            served = [r for t, _, r in during if window[0] < t < window[1]]
            if bad or steps < 1:
                fail(f"fleet (d): replica 0 ran {steps} decode steps while replica 1 was "
                     f"restarted ({window[1] - window[0]:.3f} s); failures {bad[:3]}")
            direct = [http_json(fleet.replicas[0].url + "/generate", b) for b in bodies]
            for i, (got, want) in enumerate(zip(crashed, direct)):
                if expect(got, 200, "(d) crash")["tokens"] != expect(want, 200, "direct")["tokens"]:
                    fail(f"fleet (d): request {i} changed across the failover")
            for _, k, result in during:
                if result[1]["tokens"] != direct[k][1]["tokens"][:8]:
                    fail(f"fleet (d): request {k} sent during the restart changed its tokens")
            counts = fleet.router.registry.counter_values()
            for rep in fleet.replicas:
                if rep.engine.post_warmup_recompiles() != 0:
                    fail(f"fleet (d): replica {rep.replica_id} recompiled after warmup")
            out["crash"] = {"failovers": counts.get("router/failovers_total", 0),
                            "restarts": counts.get("router/restarts_total", 0),
                            "restart_window_s": window[1] - window[0],
                            "survivor_decode_steps_during_restart": steps,
                            "replies_during_restart": len(served),
                            "served_during_recovery": len(during),
                            "events": events, "serving": check_router_line(fleet.router, "(d)")}
        finally:
            front.close()
        # (e) the router pair over the same replicas.
        fault = faults.serve_install("killrouter@3")
        pair = RouterPair(fleet.urls, journal_path=os.path.join(tmp, "pair.journal"),
                          lease_path=os.path.join(tmp, "pair.lease"), router_cfg=cfg,
                          standby_interval_s=0.1, miss_budget_s=1.0)
        pair.supervisor = fleet.supervisor
        pair.start()
        try:
            keyed = [{**b, "request_id": f"tko-{i}"} for i, b in enumerate(bodies[:6])]
            with concurrent.futures.ThreadPoolExecutor(len(keyed)) as pool:
                replies = list(pool.map(lambda b: failover_post(pair.endpoints(), b), keyed))
            if not any(k == "killrouter" for k, _, _ in fault.fired):
                fail(f"fleet (e): killrouter did not fire: {fault.fired}")
            if not pair.monitor.promoted.wait(30.0):
                fail("fleet (e): the standby did not promote")
            for i, result in enumerate(replies):
                got = expect(result, 200, f"(e) request {i}")["tokens"]
                want = expect(direct[i], 200, "direct")["tokens"]
                if got != want:
                    fail(f"fleet (e): request {i} changed across the takeover")
            dup = expect(http_json(pair.endpoints()[1], keyed[0]), 200, "(e) duplicate")
            if not dup.get("dedup") or dup["tokens"] != replies[0][1]["tokens"]:
                fail(f"fleet (e): the duplicate request id was not deduplicated: {str(dup)[:200]}")
            tail = expect(http_json(pair.endpoints()[1], {**keyed[1], "resume_from": 5}), 200,
                          "(e) resume_from")
            if not tail.get("resumed") or tail["tokens"] != replies[1][1]["tokens"][5:]:
                fail(f"fleet (e): resume_from 5 answered {str(tail)[:200]}")
            if pair.journal.incomplete():
                fail(f"fleet (e): {len(pair.journal.incomplete())} intents left incomplete")
            out["takeover"] = {"takeover_latency_s": pair.monitor.takeover_latency_s,
                               "replayed": pair.monitor.replayed,
                               "serving": check_router_line(pair.standby, "(e)")}
        finally:
            pair.close()
        # (f) the SLO engine under slowrep on replica 1, and the prober.
        faults.serve_install("slowrep@1:0.05")
        strict = slo.SLOConfig(objectives=(slo.SLOObjective(
            slo="interactive", e2e_p95_s=1.0, error_budget=0.05, availability=0.9),),
            windows_s=(10.0, 30.0), burn_thresholds=(2.0, 1.0), pending_for_s=0.0,
            resolve_after_s=30.0)
        alerts_path = os.path.join(tmp, "alerts.jsonl")
        router = Router(fleet.urls, registry=MetricsRegistry(), cfg=cfg, slo_cfg=strict,
                        alert_path=alerts_path).start()
        front = RouterFrontend(router).start()
        try:
            prober = CanaryProber(fleet_targets(front.url(""), fleet.urls),
                                  alerts=router.alerts, registry=router.registry)
            probes = [r["ok"] for _ in range(3) for r in prober.probe_once()]
            inter = [{**b, "slo": "interactive"} for b in bodies]
            # Replica 0 drained for the burst (an operator's verb), so the
            # router sends it all to the slow replica.
            router.drain(fleet.urls[0])
            with concurrent.futures.ThreadPoolExecutor(4) as pool:
                for result in pool.map(lambda b: http_json(front.url("/generate"), b), inter):
                    expect(result, 200, "(f) /generate")
            router.undrain(fleet.urls[0])
            router.alerts.evaluate()
            serving = check_router_line(router, "(f)")
            alerts = slo.read_alerts(alerts_path)
            if serving["alerts_firing"] < 1 or not any(a["state"] == "firing" for a in alerts):
                fail(f"fleet (f): no burn-rate alert fired under slowrep: {serving}, {alerts}")
            watch = slo_watch_exits(front.url(""), router.alerts, strict)
            out["slo"] = {"probes_ok": sum(probes), "probes": len(probes), "slo_watch": watch,
                          "alerts": [(a["name"], a["state"], a.get("value")) for a in alerts],
                          "serving": {k: serving[k] for k in ("alerts_firing",
                                                              "error_budget_remaining",
                                                              "probe_success_rate",
                                                              "alert_count")}}
        finally:
            front.close()
            router.close()
    finally:
        faults.serve_clear()
        fleet.close()
    log(f"fleet (d)-(f): {json.dumps(out)}; {smi}")
    return out


def slo_watch_exits(url: str, alerts, cfg) -> dict:
    """``python -m tensorflow_examples_torch.slo_watch URL --once`` while
    the router's alert fires (exit 1), and after it clears (exit 0): the
    alert engine's clock moved past the slow window, then past
    ``resolve_after_s`` more, evaluated at each."""
    here = os.path.dirname(os.path.abspath(__file__))

    def watch() -> tuple[int, str]:
        p = subprocess.run([sys.executable, "-m", "tensorflow_examples_torch.slo_watch", url,
                            "--once"], cwd=here, capture_output=True, text=True, timeout=120)
        return p.returncode, p.stdout

    firing = watch()
    clock, ahead = alerts._now, max(cfg.windows_s) + 1.0
    for shift in (ahead, ahead + cfg.resolve_after_s):
        alerts._now = lambda shift=shift: clock() + shift
        alerts.evaluate()
    cleared = watch()
    if firing[0] != 1 or "FIRING" not in firing[1] or cleared[0] != 0 \
            or "FIRING" in cleared[1]:
        fail(f"fleet (f): slo_watch --once exited {firing[0]} while firing and {cleared[0]} "
             f"after the alert cleared (want 1 and 0): {firing[1]!r} / {cleared[1]!r}")
    return {"exit_firing": firing[0], "exit_cleared": cleared[0],
            "firing_lines": firing[1].splitlines()[1:]}


def fleet_cli(here: str, model_cfg, rng, smi) -> dict:
    """(g) the fleet CLI as a process over two supervised serve
    processes (2 layers at full width): one is ``kill -9``'d, restarted
    and readmitted; SIGTERM drains the CLI to exit 0."""
    import signal

    base, port = free_port_pair(), free_port()
    replica = (f"{sys.executable} -m tensorflow_examples_torch.serve --num_layers 2 "
               "--kv_block_size 16 --attention paged_flash --max_slots 4 --stats_every 0 "
               "--port {port}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as logs:
        log_path = os.path.join(logs, "fleet.log")
        with open(log_path, "w") as log_file:
            proc = subprocess.Popen(
                [sys.executable, "-m", "tensorflow_examples_torch.serve_fleet", "--port",
                 str(port), "--spawn-base-port", str(base), "--spawn", replica,
                 "--spawn", replica, "--health-stall", "15", "--stats-every", "0"],
                cwd=here, stdout=log_file, stderr=subprocess.STDOUT, start_new_session=True)
        url = f"http://127.0.0.1:{port}"
        t0 = time.monotonic()

        def wait(what, ready):
            while not ready():
                if proc.poll() is not None:
                    fail(f"fleet CLI exited {proc.returncode} waiting for {what}: "
                         f"{open(log_path).read()[-3000:]}")
                if time.monotonic() - t0 > 300:
                    fail(f"fleet CLI: no {what} after 300 s: {open(log_path).read()[-3000:]}")
                time.sleep(0.2)

        try:
            wait("router", lambda: "router on :" in open(log_path).read())
            ready_s = time.monotonic() - t0
            body = {"prompt": [int(t) for t in rng.integers(0, model_cfg.vocab_size, 12)],
                    "max_new_tokens": 16, "seed": 1}
            first = expect(http_json(url + "/generate", body), 200, "fleet CLI /generate")
            # The second spawn serves --spawn-base-port + 1.
            victim = subprocess.run(["pgrep", "-f", "--", f"--port {base + 1}$"],
                                    capture_output=True, text=True).stdout.split()
            if len(victim) != 1:
                fail(f"fleet CLI: {len(victim)} processes serve port {base + 1}")
            t_kill = time.monotonic()
            os.kill(int(victim[0]), signal.SIGKILL)
            wait("restart", lambda: http_json(url + "/window", timeout=10)[1]["serving"][
                "router_restarts"] >= 1)
            restart_s = time.monotonic() - t_kill
            reps = http_json(url + "/replicas", timeout=10)[1]["replicas"]
            if any(r["quarantined"] or r["breaker"] != "closed" for r in reps):
                fail(f"fleet CLI: a replica is out after the restart: {reps}")
            again = expect(http_json(url + "/generate", body), 200, "fleet CLI /generate")
            if again["tokens"] != first["tokens"]:
                fail("fleet CLI: the tokens changed after the restart")
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=120)
        finally:
            # The CLI's process group holds its spawned replicas too.
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        if code != 0:
            fail(f"fleet CLI exited {code} after SIGTERM: {open(log_path).read()[-3000:]}")
    out = {"ready_s": ready_s, "restart_s": restart_s, "exit_code": code, "card": smi}
    log(f"fleet CLI: {json.dumps(out)}")
    return out


def phase_fleet(torch, model, model_cfg, counters, smi: str, here: str) -> dict:
    """The fleet's control plane on the card: the port's router over
    warmed GPT-2 124M replicas (f32, ``paged_flash``), traces, failover
    and in-process restart, the router pair's takeover, the SLO engine
    and the fleet CLI. Returns the launch counts from (a)'s routed
    requests to the end of (f), and the phase's numbers."""
    rng = np.random.default_rng(31)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        routed = fleet_routed(model, model_cfg, counters, rng, smi, tmp)
        chaos = fleet_chaos(model, model_cfg, rng, smi, tmp)
    launches = {k: counters[k].launches for k in ("flash_decode", "paged_decode")}
    cli = fleet_cli(here, model_cfg, rng, smi)
    gc.collect()
    torch.cuda.empty_cache()
    summary = {"launches": launches, "routed_launches": routed["routed_launches"],
               "wall_s": time.perf_counter() - t0, "routed": routed, "chaos": chaos,
               "cli": cli, "card": smi}
    log(f"fleet: {json.dumps(summary)}")
    return summary


# ---------------------------------------------------------- phase 5i


# Sharded serving: GPT-2 124M on {model: 2}, two ranks sharing the card.
SHARDED_CONFIGS = (("dense_flash", dict(attention="flash")),
                   ("paged_flash", dict(kv_block_size=16, attention="paged_flash")),
                   ("paged_flash_int8", dict(kv_block_size=16, attention="paged_flash",
                                             kv_dtype="int8")))
SHARDED_LENS = (5, 17, 40, 64, 100, 150, 230, 300)  # phase_serving's prompt lengths
SHARDED_NEW = 16             # tokens a served request generates
SHARDED_STEPS = 8            # decode steps in each timed window
SHARDED_HEADS = 6            # a rank's heads: GPT-2's 12 over model 2
SHARDED_PROBE_LEN = 100      # the prefill whose logits are held to one rank's
SHARDED_CLI_LAYERS = 2       # the torchrun serve CLI's depth cut
SHARDED_FSDP_STEPS = 2       # {fsdp: 2}'s timed decode steps: each gathers every cut weight
# The sharded world's configs (name, mesh, ServeConfig fields, the one-rank
# config held to, decode steps timed, whether to warm the ladder first):
# SHARDED_CONFIGS on {model: 2}, then paged_flash on {fsdp: 2}, 12 heads a
# rank and every fsdp-cut weight gathered through the host at each use
# (its 19-rung warmup would cost ~11 s of gathers on the card).
SHARDED_WORLD = tuple((name, {"model": 2}, kw, name, SHARDED_STEPS, True)
                      for name, kw in SHARDED_CONFIGS) + (
    ("fsdp_paged_flash", {"fsdp": 2}, dict(SHARDED_CONFIGS)["paged_flash"], "paged_flash",
     SHARDED_FSDP_STEPS, False),)
# The KV-page hand-off between {model: 2} and one rank, each way: (label,
# the one-rank config it runs and is held to).
SHARDED_HANDOFF = (("f32", "paged_flash"), ("int8", "paged_flash_int8"))
# A rank's measurement windows, filled by the sharded_* functions that
# rank 0 runs on every rank through MeshDriver.run.
_WINDOW: dict = {}


def sharded_counters() -> dict:
    from tensorflow_examples_torch.ops import decode, paged_decode

    return {"flash_decode": decode.flash_decode_attention,
            "paged_decode": paged_decode.paged_decode_attention}


def time_collectives(coll) -> None:
    """Add the host seconds of every psum (``_all_reduce``: over gloo, the
    copy to pinned host memory, which waits for the operand, the reduce
    and the copy back) to ``_WINDOW["collective_s"]``, and of every
    all-gather (``_all_gather``: an fsdp weight before use, the pages'
    heads) to ``_WINDOW["gather_s"]``."""
    for name, key in (("_all_reduce", "collective_s"), ("_all_gather", "gather_s")):
        inner = getattr(coll, name)

        def timed(*args, _inner=inner, _key=key, **kwargs):
            t0 = time.perf_counter()
            try:
                return _inner(*args, **kwargs)
            finally:
                _WINDOW[_key] = _WINDOW.get(_key, 0.0) + time.perf_counter() - t0

        setattr(coll, name, timed)


def _decode_steps(engine) -> int:
    return int(engine.registry.counter_values().get("serving/decode_steps", 0))


def sharded_window_start(engine) -> None:
    import torch

    torch.cuda.synchronize()
    reset_counts(sharded_counters())
    _WINDOW.update(collective_s=0.0, gather_s=0.0, steps0=_decode_steps(engine),
                   t0=time.perf_counter())


def sharded_window_end(engine, name: str) -> None:
    import torch

    torch.cuda.synchronize()
    _WINDOW.setdefault("windows", {})[name] = {
        "launches": {k: c.launches for k, c in sharded_counters().items()},
        "decode_steps": _decode_steps(engine) - _WINDOW["steps0"],
        "wall_s": time.perf_counter() - _WINDOW["t0"], "collective_s": _WINDOW["collective_s"],
        "gather_s": _WINDOW["gather_s"]}


def sharded_profile_start(engine) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    time.sleep(PROFILER_LEAD_S)
    _WINDOW.update(prof=prof, t0=time.perf_counter())


def sharded_profile_end(engine, steps: int) -> None:
    """Device ms a decode step of this rank's kernels, the port's share,
    and the host wall a step under the profiler."""
    import torch
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - _WINDOW["t0"]) * 1e3 / steps
    prof = _WINDOW.pop("prof")
    prof.__exit__(None, None, None)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    device = sum(e.self_device_time_total for e in events) / 1e3 / steps
    ours = sum(e.self_device_time_total for e in events if any(
        k in e.key for k in ("flash_decode_", "paged_decode_kernel", "merge_splits_kernel")))
    _WINDOW["profile"] = {"device_ms": device, "port_kernel_ms": ours / 1e3 / steps,
                          "profiled_wall_ms": wall_ms}


def sharded_requests(vocab: int) -> list[dict]:
    rng = np.random.default_rng(41)
    return [{"prompt": [int(t) for t in rng.integers(0, vocab, n)],
             "max_new_tokens": SHARDED_NEW, "seed": i} for i, n in enumerate(SHARDED_LENS)]


def batcher_streams(engine, bodies) -> list[list[int]]:
    """The requests at once through a ContinuousBatcher (no HTTP): each
    stream's tokens."""
    from tensorflow_examples_torch.serving.batcher import ContinuousBatcher, Request

    batcher = ContinuousBatcher(engine).start()
    try:
        futures = [batcher.submit(Request(prompt=b["prompt"], max_new_tokens=b["max_new_tokens"],
                                          seed=b["seed"])) for b in bodies]
        return [f.result(timeout=300).tokens for f in futures]
    finally:
        batcher.close()


def sharded_drive(engine, run, bodies, probe, steps: int = SHARDED_STEPS,
                  warm: bool = True) -> dict:
    """What phase 5i measures of one engine, the same calls on one rank
    and on the mesh (where ``engine`` is rank 0's leader and ``run``
    publishes a measurement function to every rank): the warmup (unless
    ``warm`` is False), the requests through the batcher in a counted
    window, one prefill of ``probe`` in another (its logits returned),
    and ``steps`` decode steps over every request's slot timed (host
    wall) and, in a second run, profiled."""
    import torch

    out = {"warmup_s": None}
    if warm:
        t0 = time.perf_counter()
        engine.warmup()
        out["warmup_s"] = time.perf_counter() - t0
    run(sharded_window_start)
    out["streams"] = batcher_streams(engine, bodies)
    run(sharded_window_end, "serve")
    slot = engine.pool.alloc()
    run(sharded_window_start)
    out["probe_logits"] = engine.prefill(slot, probe)[1]
    run(sharded_window_end, "prefill")
    engine.pool.free(slot)
    slots = [engine.pool.alloc() for _ in bodies]
    entries = [[s, engine.prefill(s, b["prompt"])[0], 0, 0.0, 0] for s, b in zip(slots, bodies)]

    def decode_steps(n):
        for _ in range(n):
            toks = engine.decode([tuple(e) for e in entries])
            for e in entries:
                e[1] = toks[e[0]]

    decode_steps(2)
    run(sharded_window_start)
    t0 = time.perf_counter()
    decode_steps(steps)
    torch.cuda.synchronize()
    out["decode_wall_ms"] = (time.perf_counter() - t0) * 1e3 / steps
    run(sharded_window_end, "decode")
    run(sharded_profile_start)
    decode_steps(steps)
    run(sharded_profile_end, steps)
    for s in slots:
        engine.pool.free(s)
    out["post_warmup_recompiles"] = engine.post_warmup_recompiles()
    return out


def handoff_export(engine, run, bodies) -> dict:
    """Prefill every request and export its pages, the prefills in a
    counted window: each request's (first token, payload) and each
    export's host ms (the gather over ``model``, the host copy, base64)."""
    import torch

    out = {"handoffs": [], "export_ms": []}
    run(sharded_window_start)
    for b in bodies:
        slot = engine.pool.alloc()
        first, _ = engine.prefill(slot, b["prompt"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pages = engine.export_kv_pages(slot, b["prompt"])
        out["export_ms"].append((time.perf_counter() - t0) * 1e3)
        engine.pool.free(slot)
        out["handoffs"].append((first, pages))
    run(sharded_window_end, "handoff_prefill")
    return out


def handoff_import(engine, run, bodies, handoffs) -> dict:
    """Import every request's pages into a slot of its own (each import's
    host ms: decode, checks, the heads sent to each rank and written on
    the card), then decode all of them SHARDED_NEW - 1 steps in a counted
    window: each request's stream, its first token the prefill's."""
    import torch

    out = {"import_ms": []}
    entries = []
    for b, (first, pages) in zip(bodies, handoffs):
        slot = engine.pool.alloc()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.import_kv_pages(slot, pages, b["prompt"])
        torch.cuda.synchronize()
        out["import_ms"].append((time.perf_counter() - t0) * 1e3)
        entries.append([slot, int(first), 0, 0.0, 0])
    streams = {e[0]: [e[1]] for e in entries}
    run(sharded_window_start)
    for _ in range(SHARDED_NEW - 1):
        toks = engine.decode([tuple(e) for e in entries])
        for e in entries:
            e[1] = toks[e[0]]
            streams[e[0]].append(e[1])
    run(sharded_window_end, "handoff_decode")
    for e in entries:
        engine.pool.free(e[0])
    out["streams"] = [streams[e[0]] for e in entries]
    return out


def sharded_worker(rank: int, model_kw: dict, bodies, probe, one_rank_handoffs) -> dict:
    """One rank of the world of 2: GPT-2 124M from seed 0, each
    SHARDED_WORLD config's sharded engine (eager: its collectives are
    staged through host memory), rank 0 leading :func:`sharded_drive`,
    rank 1 replaying it; then, on {model: 2}, for each KV dtype a prefill
    engine exporting every request (:func:`handoff_export`) and a decode
    engine importing one rank's pages and decoding them
    (:func:`handoff_import`). Each rank's windows, profile, replayed calls
    and pool host state."""
    import torch

    from tensorflow_examples_torch.core import collectives as coll
    from tensorflow_examples_torch.models import transformer
    from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
    from tensorflow_examples_torch.serving.mesh_driver import MeshDriver
    from tensorflow_examples_torch.sharding import ShardingConfig
    from tensorflow_examples_torch.telemetry.registry import MetricsRegistry

    time_collectives(coll)
    model_cfg = transformer.TransformerConfig(**model_kw)
    model = transformer.GPT2(model_cfg, seed=0)
    out = {"backend": torch.distributed.get_backend(), "configs": {}, "handoff": {}}

    def lead_or_follow(engine, drive) -> dict:
        driver = MeshDriver()
        _WINDOW.clear()
        res = {"heads": engine.local_heads, "digest": engine.param_sharding_digest}
        if rank == 0:
            res.update(drive(driver.leader(engine), lambda fn, *a: driver.run(engine, fn, *a)))
            driver.stop()
            res.update(published=driver.calls, publish_s=driver.publish_s)
        else:
            res["replayed"] = driver.follow(engine)
            res["post_warmup_recompiles"] = engine.post_warmup_recompiles()
        res.update(windows=_WINDOW["windows"], profile=_WINDOW.get("profile"),
                   host_state=engine.pool.host_state())
        return res

    def engine_on(mesh, **kw):
        return InferenceEngine(model_cfg, model, cfg=ServeConfig(max_slots=8, **kw),
                               registry=MetricsRegistry(), sharding=ShardingConfig(mesh=mesh),
                               cuda_graphs=False)

    for name, mesh, kw, _, steps, warm in SHARDED_WORLD:
        out["configs"][name] = lead_or_follow(
            engine_on(mesh, **kw),
            lambda lead, run: sharded_drive(lead, run, bodies, probe, steps, warm))
        gc.collect()
        torch.cuda.empty_cache()
    for label, ref_name in SHARDED_HANDOFF:
        kw = dict(SHARDED_CONFIGS)[ref_name]
        out["handoff"][f"{label}/prefill"] = lead_or_follow(
            engine_on({"model": 2}, role="prefill", **kw),
            lambda lead, run: handoff_export(lead, run, bodies))
        out["handoff"][f"{label}/decode"] = lead_or_follow(
            engine_on({"model": 2}, role="decode", **kw),
            lambda lead, run: handoff_import(lead, run, bodies, one_rank_handoffs[label]))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def sharded_kernel_rows(torch, decode, paged, precision) -> dict:
    """Rows 6 and 7 at a rank's shape (H 6): flash-decode f32 B1 D64 at
    q_len = length = 512, paged decode S8 BS16 nb64 D64 ragged and full,
    fp32 and int8, each against its plain version, with kernel, plain,
    library and bound times."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    randn = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    h, d, n = SHARDED_HEADS, 64, 512
    q, k, v = randn(1, h, n, d), randn(1, h, n, d), randn(1, h, n, d)
    out = decode.flash_decode_attention(q, k, v, n)
    err = float((out - decode.decode_attention_reference(q, k, v, n)).abs().max())
    if not torch.isfinite(out).all() or err > 2e-5:
        fail(f"sharded flash_decode H{h}: max_abs_err {err:.3e} > 2e-5")
    bound_ms, by = bound(*flash_times(n, n, n, h, d, "float32", 4))
    rows = {"flash_decode": {
        "shape": f"float32 B=1 H={h} q_len={n} length={n} max_len={n} D={d}", "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: decode.flash_decode_attention(q, k, v, n)),
        "plain_ms": cuda_ms(torch, lambda: decode.decode_attention_reference(q, k, v, n)),
        "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v,
                                                                            is_causal=True)),
        "bound_ms": bound_ms, "bound_by": by}}
    s, bs, nb = 8, 16, 64
    shapes = []
    for shape_label, lengths_l in PAGED_SHAPES:
        tables = paged_tables(torch, gen, lengths_l, bs, nb)
        lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
        qd = randn(s, h, d)
        kb, vb = randn(s * nb + 1, h, bs, d), randn(s * nb + 1, h, bs, d)
        qk, ks = precision.quantize_int8_rows(kb)
        qv, vs = precision.quantize_int8_rows(vb)
        kb_nan, vb_nan, ks_nan, vs_nan = poison_tails(torch, (kb, vb, ks, vs), tables,
                                                      lengths_l, bs)
        tables = tables.to(dev)
        live = lengths > 0
        for label, clean, poisoned, itemsize in (
                ("fp32", ((kb, vb), {}), ((kb_nan, vb_nan), {}), 4),
                ("int8", ((qk, qv), {"k_scale": ks, "v_scale": vs}),
                 ((qk, qv), {"k_scale": ks_nan, "v_scale": vs_nan}), 1)):
            args, kw = poisoned
            got = paged.paged_decode_attention(qd, *args, lengths, tables, **kw)
            ref = paged.paged_decode_reference(qd, *clean[0], lengths, tables, **clean[1])
            perr = float((got[live] - ref[live]).abs().max())
            if not torch.isfinite(got).all() or perr > 2e-6:
                fail(f"sharded paged_decode H{h} {label} {shape_label}: max_abs_err {perr:.3e}")
            pb, by = bound(*paged_times(lengths_l, bs, h, d, itemsize, bool(kw)))
            shapes.append(dict(
                shape=f"S={s} H={h} BS={bs} nb={nb} D={d} {label} {shape_label}",
                max_abs_err=perr, bound_ms=pb, bound_by=by,
                ms=cuda_ms(torch, lambda: paged.paged_decode_attention(
                    qd, *args, lengths, tables, **kw)),
                plain_ms=cuda_ms(torch, lambda: paged.paged_decode_reference(
                    qd, *clean[0], lengths, tables, **clean[1])), library_ms=None))
    rows["paged_decode"] = {**shapes[0], "max_abs_err": max(x["max_abs_err"] for x in shapes),
                            "all_shapes": shapes}
    for name, row in rows.items():
        log(f"sharded {name} at a rank's shape: {json.dumps(row)}")
    return rows


def torchrun_rank_pid(parent: int, rank: int) -> int | None:
    """The pid of ``torchrun``'s worker of ``rank``, read from /proc."""
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{entry}/environ", "rb") as f:
                env = f.read().split(b"\0")
        except OSError:
            continue
        if ppid == parent and f"RANK={rank}".encode() in env:
            return int(entry)
    return None


def sharded_cli(torch, here: str, model_cfg, smi: str) -> dict:
    """``torchrun --nproc_per_node 2 -m tensorflow_examples_torch.serve`` on a
    ``{model: 2}`` workdir (GPT-2 124M widths cut to SHARDED_CLI_LAYERS
    layers, seed 0, the checkpoint and ``sharding.json`` a training run on
    that mesh keeps): healthy with the mesh and the digest, one
    ``/generate`` equal to a one-rank engine's tokens, rank 0 drained by
    SIGTERM and every process exiting 0."""
    import dataclasses
    import signal
    import types

    from tensorflow_examples_torch.models import transformer
    from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
    from tensorflow_examples_torch.sharding import ShardingConfig, resolve_params
    from tensorflow_examples_torch.sharding.config import rules_to_json
    from tensorflow_examples_torch.telemetry.registry import MetricsRegistry
    from tensorflow_examples_torch.train.checkpoint import CheckpointManager

    cfg = dataclasses.replace(model_cfg, num_layers=SHARDED_CLI_LAYERS)
    model = transformer.GPT2(cfg, seed=0)
    params = dict(model.named_parameters())
    mesh = {"data": 1, "fsdp": 1, "model": 2, "context": 1, "pipe": 1}
    digest = resolve_params(params, types.SimpleNamespace(shape=mesh),
                            transformer.GPT2_RULES).digest()
    serve_kw = dict(max_slots=4, kv_block_size=16, attention="paged_flash")
    body = {"prompt": [int(t) for t in np.random.default_rng(5).integers(0, cfg.vocab_size, 40)],
            "max_new_tokens": SHARDED_NEW, "seed": 0}
    one = InferenceEngine(cfg, model, cfg=ServeConfig(**serve_kw), registry=MetricsRegistry(),
                          cuda_graphs=False)
    want = batcher_streams(one, [body])[0]
    del one
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_cli_") as workdir:
        with CheckpointManager(workdir) as ckpt:
            ckpt.save(1, types.SimpleNamespace(step=1, params=params, opt_state={},
                                               model_state={}))
        ShardingConfig(mesh={"data": 1, "model": 2},
                       rules=rules_to_json(transformer.GPT2_RULES)).save(
            os.path.join(workdir, "sharding.json"),
            extra={"param_sharding_digest": digest, "mesh_shape": mesh})
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
               "--nproc_per_node", "2", "--master_addr", "127.0.0.1", "--master_port",
               str(free_port()), "-m", "tensorflow_examples_torch.serve", "--workdir", workdir,
               "--port", str(port), "--stats_every", "0",
               *(x for k, v in serve_kw.items() for x in (f"--{k}", str(v))),
               *(x for k in ("vocab_size", "max_len", "num_layers", "num_heads", "d_model")
                 for x in (f"--{k}", str(getattr(cfg, k))))]
        log_path = os.path.join(workdir, "serve.log")
        t0 = time.monotonic()
        with open(log_path, "w") as log_file:
            proc = subprocess.Popen(cmd, cwd=here, stdout=log_file, stderr=subprocess.STDOUT)
        url = f"http://127.0.0.1:{port}"
        try:
            while True:
                if proc.poll() is not None:
                    fail(f"sharded serve CLI exited {proc.returncode} before serving: "
                         f"{open(log_path).read()[-3000:]}")
                try:
                    status, health, _ = http_json(url + "/health", timeout=5)
                    if status == 200:
                        break
                except OSError:
                    pass
                if time.monotonic() - t0 > 300:
                    fail("sharded serve CLI not healthy after 300 s")
                time.sleep(0.2)
            ready_s = time.monotonic() - t0
            status, reply, _ = http_json(url + "/generate", body)
            rank0 = torchrun_rank_pid(proc.pid, 0)
            if rank0 is None:
                fail("sharded serve CLI: no rank-0 worker under torchrun")
            os.kill(rank0, signal.SIGTERM)
            code = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        text = open(log_path).read()
    if code != 0 or status != 200:
        fail(f"sharded serve CLI: /generate {status}, exit {code}: {text[-3000:]}")
    if reply["tokens"] != want:
        fail(f"sharded serve CLI: tokens {reply['tokens']} != one rank's {want}")
    if health.get("param_sharding_digest") != digest or health.get("mesh_shape", {}).get(
            "model") != 2 or health["post_warmup_recompiles"] != 0:
        fail(f"sharded serve CLI: /health {health}")
    for needed in ("sharding config:", "cuda graphs off (collectives staged through host memory)",
                   "replayed"):
        if needed not in text:
            fail(f"sharded serve CLI: no {needed!r} in its log: {text[-3000:]}")
    out = {"ready_s": ready_s, "exit_code": code, "digest": digest,
           "mesh_shape": health["mesh_shape"], "tokens_equal_one_rank": True, "card": smi}
    log(f"sharded serve CLI (torchrun, 2 ranks, {SHARDED_CLI_LAYERS} layers): {json.dumps(out)}")
    return out


def handoff_pages_err(ours: dict, theirs: dict) -> dict:
    """Two payloads of one prompt: whether their meta agrees, the f32
    pages' max abs difference, the int8 pages' max level difference and
    the scales' max relative difference."""
    import torch

    from tensorflow_examples_torch.serving import scheduler

    meta = lambda p: {k: v for k, v in p.items() if k != "arrays"}
    _, a = scheduler.decode_pages(ours)
    _, b = scheduler.decode_pages(theirs)
    out = {"meta_equal": meta(ours) == meta(theirs) and sorted(a) == sorted(b)}
    for name in sorted(a):
        x, y = a[name].double(), b[name].double()
        if x.shape != y.shape:
            out["meta_equal"] = False
            continue
        key = ("scale_rel" if name.endswith("scale") else
               "int8_levels" if a[name].dtype == torch.int8 else "f32_abs")
        diff = float(((x - y).abs() / y.abs().clamp_min(1e-30)).max() if key == "scale_rel"
                     else (x - y).abs().max())
        out[key] = max(out.get(key, 0.0), diff)
    return out


def held_streams(torch, what: str, engine, bodies, streams, refs) -> dict:
    """Each stream against the one-rank engine's with :func:`stream_verdict`
    (``engine`` gives the reference logits): exact and near-tie counts."""
    exact = ties = 0
    for body, served, want in zip(bodies, streams, refs):
        verdict = stream_verdict(torch, engine, body["prompt"], served, want)
        if verdict == "exact":
            exact += 1
        elif verdict[0] == "tie":
            ties += 1
        else:
            fail(f"sharded{what} prompt_len={len(body['prompt'])}: stream {served} differs "
                 f"from the one-rank engine's {want} at token {verdict[1]} (top-2 gap "
                 f"{verdict[2]})")
    return {"exact_streams": exact, "near_tie_streams": ties}


def phase_sharded_serving(torch, model, model_cfg, decode, paged, precision, smi: str,
                          here: str) -> dict:
    """GPT-2 124M served on {model: 2} and on {fsdp: 2} by two ranks
    sharing the card (gloo, host-staged collectives, eager rungs),
    against the one-rank eager engine on the same weights: streams (a
    near-tie allowed), one prefill's logits (1e-4), each rank's launches
    of rows 6 and 7 (12 flash-decode a prefill, 12 paged a decode step),
    the decode step's host wall, device time and psum and gather shares a
    rank; the KV-page hand-off each way between {model: 2} and one rank,
    f32 and int8 KV (the sharded export's pages held to one rank's, every
    stream to the one-rank mixed engine's, each leg's launches per rank,
    the export and import host ms and the payload MB); rows 6-7 at a
    rank's shape; the serve CLI under torchrun."""
    from tensorflow_examples_torch.core import distributed
    from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
    from tensorflow_examples_torch.telemetry.registry import MetricsRegistry

    t_phase = time.perf_counter()
    layers = model_cfg.num_layers
    kernel_rows = sharded_kernel_rows(torch, decode, paged, precision)
    bodies = sharded_requests(model_cfg.vocab_size)
    probe = [int(t) for t in np.random.default_rng(43).integers(0, model_cfg.vocab_size,
                                                                SHARDED_PROBE_LEN)]

    def one_rank_engine(**kw):
        return InferenceEngine(model_cfg, model, cfg=ServeConfig(max_slots=8, **kw),
                               registry=MetricsRegistry(), cuda_graphs=False)

    one_rank = {}
    for name, kw in SHARDED_CONFIGS:
        engine = one_rank_engine(**kw)
        _WINDOW.clear()
        res = sharded_drive(engine, lambda fn, *a: fn(engine, *a), bodies, probe)
        res.update(windows=_WINDOW["windows"], profile=_WINDOW["profile"])
        one_rank[name] = res
        del engine
    one_handoffs = {}
    for label, ref_name in SHARDED_HANDOFF:
        engine = one_rank_engine(role="prefill", **dict(SHARDED_CONFIGS)[ref_name])
        _WINDOW.clear()
        one_handoffs[label] = handoff_export(engine, lambda fn, *a: fn(engine, *a), bodies)
        one_handoffs[label]["windows"] = _WINDOW["windows"]
        del engine
    gc.collect()
    torch.cuda.empty_cache()
    model_kw = {f: getattr(model_cfg, f) for f in ("vocab_size", "max_len", "num_layers",
                                                   "num_heads", "d_model")}
    t0 = time.perf_counter()
    ranks = distributed.run_world(
        sharded_worker, 2, model_kw, bodies, probe,
        {label: h["handoffs"] for label, h in one_handoffs.items()}, device="cuda",
        timeout_s=900)
    world_s = time.perf_counter() - t0
    out = {"configs": {}, "handoff": {}, "kernel_rows": kernel_rows, "world_s": world_s,
           "card": smi}
    launches = {"flash_decode": [0, 0], "paged_decode": [0, 0]}
    verdict_engine = one_rank_engine()  # reference_logits only
    for name, mesh, kw, ref_name, steps, _ in SHARDED_WORLD:
        ref = one_rank[ref_name]
        per_rank = [r["configs"][name] for r in ranks]
        lead = per_rank[0]
        row = held_streams(torch, f"[{name}] served", verdict_engine, bodies,
                                    lead["streams"], ref["streams"])
        logit_err = float(np.abs(lead["probe_logits"] - ref["probe_logits"]).max())
        if not logit_err <= 1e-4:
            fail(f"sharded[{name}]: prefill logits {logit_err:.3e} from one rank's (> 1e-4)")
        if per_rank[0]["host_state"] != per_rank[1]["host_state"]:
            fail(f"sharded[{name}]: the ranks' pool host state differs")
        if per_rank[1]["replayed"] != lead["published"]:
            fail(f"sharded[{name}]: rank 1 replayed {per_rank[1]['replayed']} of "
                 f"{lead['published']} calls")
        heads = model_cfg.num_heads // mesh.get("model", 1)
        if any(r["heads"] != heads for r in per_rank) or \
                any(r["post_warmup_recompiles"] != 0 for r in per_rank) or \
                lead["digest"] != per_rank[1]["digest"]:
            fail(f"sharded[{name}]: heads, recompiles or digest: "
                 f"{[(r['heads'], r['post_warmup_recompiles'], r['digest']) for r in per_rank]}")
        paged_route = kw["attention"] == "paged_flash"
        for i, r in enumerate(per_rank):
            w = r["windows"]
            want = {
                "prefill": {"flash_decode": layers, "paged_decode": 0},
                "decode": {"flash_decode": 0,
                           "paged_decode": layers * steps if paged_route else 0},
                "serve": {"flash_decode": layers * len(bodies),
                          "paged_decode": layers * w["serve"]["decode_steps"] if paged_route
                          else 0}}
            got = {k: w[k]["launches"] for k in want}
            if got != want or w["serve"]["decode_steps"] < SHARDED_NEW - 1:
                fail(f"sharded[{name}] rank {i}: launches {got}, expected {want}")
            for k in launches:
                launches[k][i] += w["serve"]["launches"][k]
        row = out["configs"][name] = {
            "mesh": mesh, **row, "prefill_logits_max_abs_err": logit_err,
            "launches_per_rank": [r["windows"] for r in per_rank],
            "decode_step_wall_ms": {"one_rank": ref["decode_wall_ms"],
                                    "rank0": lead["decode_wall_ms"]},
            "decode_step_device_ms": {"one_rank": ref["profile"]["device_ms"],
                                      "per_rank": [r["profile"]["device_ms"] for r in per_rank]},
            "decode_step_port_kernel_ms": {
                "one_rank": ref["profile"]["port_kernel_ms"],
                "per_rank": [r["profile"]["port_kernel_ms"] for r in per_rank]},
            "decode_psum_share_per_rank": [
                r["windows"]["decode"]["collective_s"] / r["windows"]["decode"]["wall_s"]
                for r in per_rank],
            "decode_gather_share_per_rank": [
                r["windows"]["decode"]["gather_s"] / r["windows"]["decode"]["wall_s"]
                for r in per_rank],
            "published_calls": lead["published"], "publish_ms_per_call":
            lead["publish_s"] * 1e3 / max(lead["published"], 1),
            "warmup_s": {"one_rank": ref["warmup_s"], "rank0": lead["warmup_s"]}}
        log(f"sharded[{name}] (GPT-2 124M f32 on {mesh}, 2 ranks on one card, gloo, eager): "
            f"{json.dumps(row)}; {smi}")
        log(f"sharded[{name}] decode step: host wall ms one rank "
            f"{ref['decode_wall_ms']:.3f} vs rank 0 {lead['decode_wall_ms']:.3f}; device ms one "
            f"rank {ref['profile']['device_ms']:.3f} vs per rank "
            f"{[round(r['profile']['device_ms'], 4) for r in per_rank]}; psum share per rank "
            f"{[round(x, 4) for x in row['decode_psum_share_per_rank']]}; gather share per rank "
            f"{[round(x, 4) for x in row['decode_gather_share_per_rank']]}; {smi}")
    for label, ref_name in SHARDED_HANDOFF:
        out["handoff"][label] = sharded_handoff_check(
            torch, label, ref_name, ranks, one_handoffs[label], one_rank[ref_name], bodies,
            layers, launches, one_rank_engine, verdict_engine, smi)
    del verdict_engine
    gc.collect()
    torch.cuda.empty_cache()
    out["launches_per_rank"] = launches
    out["cli"] = sharded_cli(torch, here, model_cfg, smi)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"sharded serving: launches of rows 6-7 per rank over the served requests and the "
        f"hand-offs {json.dumps(launches)}; world {world_s:.1f} s; phase {out['phase_s']:.1f} s; "
        f"{smi}")
    return out


def sharded_handoff_check(torch, label, ref_name, ranks, one_pre, one_mixed, bodies, layers,
                          launches, one_rank_engine, verdict_engine, smi) -> dict:
    """One KV dtype's hand-off each way between {model: 2} and one rank:
    the sharded export's pages against one rank's (f32 within 1e-4, int8
    within one level, scales within rtol 1e-4, the meta equal); the
    sharded pages decoded by a one-rank decode engine here, and one
    rank's decoded by the sharded decode engine, each stream held to the
    one-rank mixed engine's; each leg's launches (per rank on the mesh);
    the export and import host ms on rank 0 against one rank's, and the
    payload MB."""
    pre_ranks = [r["handoff"][f"{label}/prefill"] for r in ranks]
    dec_ranks = [r["handoff"][f"{label}/decode"] for r in ranks]
    sharded_pre, sharded_dec = pre_ranks[0], dec_ranks[0]
    errs = [handoff_pages_err(ours, theirs) for (_, ours), (_, theirs) in
            zip(sharded_pre["handoffs"], one_pre["handoffs"])]
    worst = {k: max(e.get(k, 0.0) for e in errs) for k in ("f32_abs", "int8_levels",
                                                            "scale_rel")}
    if not all(e["meta_equal"] for e in errs) or worst["f32_abs"] > 1e-4 or \
            worst["int8_levels"] > 1 or worst["scale_rel"] > 1e-4:
        fail(f"sharded hand-off [{label}]: the sharded export against one rank's: {errs}")
    engine = one_rank_engine(role="decode", **dict(SHARDED_CONFIGS)[ref_name])
    _WINDOW.clear()
    back = handoff_import(engine, lambda fn, *a: fn(engine, *a), bodies,
                          sharded_pre["handoffs"])
    back_windows = _WINDOW["windows"]
    del engine
    out = {"pages_vs_one_rank": worst,
           "sharded_prefill_to_one_rank_decode": held_streams(
               torch, f" hand-off [{label}] sharded prefill -> one-rank decode", verdict_engine, bodies,
               back["streams"], one_mixed["streams"]),
           "one_rank_prefill_to_sharded_decode": held_streams(
               torch, f" hand-off [{label}] one-rank prefill -> sharded decode", verdict_engine, bodies,
               sharded_dec["streams"], one_mixed["streams"])}
    decode_want = {"flash_decode": 0, "paged_decode": layers * (SHARDED_NEW - 1)}
    prefill_want = {"flash_decode": layers * len(bodies), "paged_decode": 0}
    for what, windows in (("one-rank prefill", [one_pre["windows"]["handoff_prefill"]]),
                          ("sharded prefill", [r["windows"]["handoff_prefill"]
                                               for r in pre_ranks]),
                          ("one-rank decode", [back_windows["handoff_decode"]]),
                          ("sharded decode", [r["windows"]["handoff_decode"]
                                              for r in dec_ranks])):
        want = prefill_want if "prefill" in what else decode_want
        for i, w in enumerate(windows):
            if w["launches"] != want:
                fail(f"sharded hand-off [{label}] {what} rank {i}: launches {w['launches']}, "
                     f"expected {want}")
    for group in (pre_ranks, dec_ranks):
        if group[0]["host_state"] != group[1]["host_state"] or \
                group[1]["replayed"] != group[0]["published"]:
            fail(f"sharded hand-off [{label}]: the ranks' host state or replayed calls differ")
    for i in range(2):
        for k in launches:
            launches[k][i] += (pre_ranks[i]["windows"]["handoff_prefill"]["launches"][k]
                               + dec_ranks[i]["windows"]["handoff_decode"]["launches"][k])
    longest = int(np.argmax([len(b["prompt"]) for b in bodies]))
    mb = [page_bytes(p) / 1e6 for _, p in one_pre["handoffs"]]
    out.update(
        launches_per_rank={"prefill": [r["windows"]["handoff_prefill"]["launches"]
                                       for r in pre_ranks],
                           "decode": [r["windows"]["handoff_decode"]["launches"]
                                      for r in dec_ranks]},
        payload_mb={"longest": mb[longest], "all": sum(mb)},
        prompt_tokens={"longest": len(bodies[longest]["prompt"]),
                       "all": sum(len(b["prompt"]) for b in bodies)},
        export_ms={"one_rank": one_pre["export_ms"], "rank0": sharded_pre["export_ms"]},
        import_ms={"one_rank": back["import_ms"], "rank0": sharded_dec["import_ms"]},
        export_gather_s_rank0=sharded_pre["windows"]["handoff_prefill"]["gather_s"],
        card=smi)
    log(f"sharded hand-off [{label}] (GPT-2 124M on {{model: 2}} <-> one rank, paged_flash): "
        f"{json.dumps(out)}")
    log(f"sharded hand-off [{label}], the {out['prompt_tokens']['longest']}-token prompt "
        f"({mb[longest]:.3f} MB of pages): export host ms one rank "
        f"{one_pre['export_ms'][longest]:.3f} vs rank 0 {sharded_pre['export_ms'][longest]:.3f}; "
        f"import host ms one rank {back['import_ms'][longest]:.3f} vs rank 0 "
        f"{sharded_dec['import_ms'][longest]:.3f}; all {len(bodies)} requests "
        f"({sum(mb):.3f} MB): export {sum(one_pre['export_ms']):.3f} vs "
        f"{sum(sharded_pre['export_ms']):.3f} ms, import {sum(back['import_ms']):.3f} vs "
        f"{sum(sharded_dec['import_ms']):.3f} ms; {smi}")
    return out


# ------------------------------------------------ the other workloads


def phase_bert_flash_kernels(torch, attention) -> dict:
    """The three training flash kernels at BERT-base GLUE's attention:
    B 32, H 12, S 128, D 64, non-causal, an f32 key bias from the padding
    mask (lengths drawn in [8, 128], -1e30 past each), and a batch with
    no padding; bf16 on the tensor cores and f32 SIMT, each held to its
    plain version at the flash phase's tolerances and rerun on the same
    inputs for the same bits. Timed on the ragged batch, with SDPA given
    the same additive mask as a yardstick only."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(12)
    b, h, s = BERT_ATTN
    d = 64
    kw = dict(heads=h, causal=False, sm_scale=d ** -0.5)
    lengths = torch.randint(8, s + 1, (b,), generator=gen)
    biases = {"ragged": torch.where(torch.arange(s)[None] < lengths[:, None], 0.0,
                                    attention.NEG_INF).to(dev),
              "no padding": torch.zeros(b, s, device=dev)}
    rows, worst = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        want = flash_variant(dname, d)
        for label, kb in biases.items():
            q, k, v, do = (torch.randn(b * h, s, d, generator=gen).to(dev, dtype) for _ in range(4))
            dlse = torch.zeros(b * h, s, device=dev)
            (o, lse), v_fwd = ran(attention.flash_fwd, lambda: attention.flash_fwd(q, k, v, kb,
                                                                                   **kw))
            o_ref, lse_ref = attention.flash_fwd_plain(q, k, v, kb, **kw)
            delta = (do.float() * o_ref.float()).sum(-1)
            args = (q, k, v, do, lse_ref, delta, dlse, kb)
            (dk, dv), v_dkv = ran(attention.flash_bwd_dkv,
                                  lambda: attention.flash_bwd_dkv(*args, **kw))
            dq, v_dq = ran(attention.flash_bwd_dq, lambda: attention.flash_bwd_dq(*args, **kw))
            dk_ref, dv_ref = attention.flash_bwd_dkv_plain(*args, **kw)
            dq_ref = attention.flash_bwd_dq_plain(*args, **kw)
            variants = {"fwd": v_fwd, "dkv": v_dkv, "dq": v_dq}
            if any(took != want for took in variants.values()):
                fail(f"bert flash[{label}] {dname}: variants {variants}, expected {want}")
            same = {"fwd": all(map(torch.equal, (o, lse), attention.flash_fwd(q, k, v, kb, **kw))),
                    "dkv": all(map(torch.equal, (dk, dv),
                                   attention.flash_bwd_dkv(*args, **kw))),
                    "dq": torch.equal(dq, attention.flash_bwd_dq(*args, **kw))}
            if not all(same.values()):
                fail(f"bert flash[{label}] {dname}: a rerun on the same inputs changed bits: "
                     f"{same}")
            fwd_tol = 2e-5 if dtype == torch.float32 else 2e-2
            errs = {"fwd": allclose_err(torch, o, o_ref, fwd_tol, fwd_tol)}
            lse_err = allclose_err(torch, lse, lse_ref, 1e-4, 1e-5)
            for kind, pairs in (("dkv", ((dk, dk_ref), (dv, dv_ref))), ("dq", ((dq, dq_ref),))):
                if dtype == torch.float32:
                    errs[kind] = worst_of(*(allclose_err(torch, a, r, 5e-4, 5e-4)
                                            for a, r in pairs))
                else:  # within 2e-2 of the plain version's largest gradient
                    errs[kind] = worst_of(*(allclose_err(
                        torch, a, r, 2e-2 * float(r.float().abs().max()), 0.0) for a, r in pairs))
            bad = [k_ for k_, (_, ok) in errs.items() if not ok] + ([] if lse_err[1] else ["lse"])
            log(f"bert flash[{label}] {dname} B={b} H={h} S={s} D={d} non-causal, lengths "
                f"{int(lengths.min())}..{int(lengths.max())}: max_abs_err fwd {errs['fwd'][0]:.3e} "
                f"lse {lse_err[0]:.3e} dkv {errs['dkv'][0]:.3e} dq {errs['dq'][0]:.3e}; variants "
                f"{variants}; rerun bit-identical")
            if bad:
                fail(f"bert flash[{label}] {dname}: {bad} outside tolerance (fwd {fwd_tol}, f32 "
                     "grads 5e-4, bf16 grads 2e-2 of max)")
            for kind, (err, _) in errs.items():
                worst[f"{dname}/{kind}"] = max(worst.get(f"{dname}/{kind}", 0.0), err)
            if label != "ragged":
                continue
            q4, k4, v4, do4 = (t.reshape(b, h, s, d) for t in (q, k, v, do))
            mask = kb[:, None, None, :].to(dtype)
            sdpa_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                              attn_mask=mask))
            qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
            out4 = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
            sdpa_bwd = cuda_ms(torch, lambda: torch.autograd.grad(out4, (qg, kg, vg), do4,
                                                                  retain_graph=True), iters=10)
            calls = {"fwd": (lambda: attention.flash_fwd(q, k, v, kb, **kw),
                             lambda: attention.flash_fwd_plain(q, k, v, kb, **kw)),
                     "dkv": (lambda: attention.flash_bwd_dkv(*args, **kw),
                             lambda: attention.flash_bwd_dkv_plain(*args, **kw)),
                     "dq": (lambda: attention.flash_bwd_dq(*args, **kw),
                            lambda: attention.flash_bwd_dq_plain(*args, **kw))}
            for kind, (kernel, plain) in calls.items():
                ms = cuda_ms(torch, kernel)
                plain_ms = cuda_ms(torch, plain, iters=5, warmup=1)
                t_bytes, t_ops = flash_train_times(s, s, b * h, d, False, dname, q.element_size(),
                                                   kind)
                t_bytes += b * s * 4 / HBM_BYTES_PER_S * 1e3  # the key bias, read once
                bound_ms, by = bound(t_bytes, t_ops)
                log(f"bert flash_{kind} {dname} B={b} H={h} S={s} D={d} non-causal key bias: "
                    f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bytes_ms {t_bytes:.5f} ops_ms "
                    f"{t_ops:.5f} bound_ms {bound_ms:.5f} ({by}), {bound_ms / ms:.0%} of bound; "
                    f"library sdpa+mask fwd_ms {sdpa_fwd:.4f} bwd_ms {sdpa_bwd:.4f}")
                rows[f"{dname}/{kind}"] = dict(
                    shape=f"B={b} H={h} S={s} D={d} non-causal key bias {dname}", ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                    library_ms=sdpa_fwd if kind == "fwd" else None,
                    **({} if kind == "fwd" else {"sdpa_bwd_ms": sdpa_bwd}),
                    max_abs_err=errs[kind][0], variant=variants[kind])
    out = {}
    for kind, name in (("fwd", "flash_fwd"), ("dkv", "flash_bwd_dkv"), ("dq", "flash_bwd_dq")):
        row = dict(rows[f"bfloat16/{kind}"])
        row["float32"] = rows[f"float32/{kind}"]
        row["worst_abs_err_all_cases"] = {"bfloat16": worst[f"bfloat16/{kind}"],
                                          "float32": worst[f"float32/{kind}"]}
        out[name] = row
    return out


def run_cli(main_fn, argv) -> dict:
    """A CLI entry point in this process: its JSON result line."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    if rc != 0:
        fail(f"{main_fn.__module__} {' '.join(argv)}: exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def cli_train(torch, counters, name: str, argv: list, workdir: str, batch: int, smi: str,
              eval_argv: list) -> dict:
    """``train.cli`` for a workload (``--workdir`` ``workdir``,
    telemetry lines on), then ``train.eval`` on its workdir: the result
    lines, the launch counts around the training run, p50 step ms and
    examples/s from its window lines (the first step, which pays set-up,
    left out), and the peak memory."""
    from tensorflow_examples_torch.train import cli
    from tensorflow_examples_torch.train import eval as eval_cli

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    final = run_cli(cli.main, ["--workload", name, *argv, "--workdir", workdir,
                               "--telemetry_sinks", "jsonl", "--log_every", "1",
                               "--eval_every", "0"])
    wall = time.perf_counter() - t0
    launches = {**{k: counters[k].launches for k in TRAIN_KERNELS}, **flash_variants(counters)}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    lines = [json.loads(x) for x in open(os.path.join(workdir, "telemetry", "metrics.jsonl"))]
    windows = [x for x in lines if x["kind"] == "window"]
    losses = [x["metrics"]["train/loss"] for x in windows]
    step_ms = float(np.median([x["metrics"]["train/step_time_s"] for x in windows[1:]])) * 1e3
    evaluated = run_cli(eval_cli.main, ["--workload", name, *eval_argv, "--workdir", workdir])
    if evaluated["step"] != final["steps"]:
        fail(f"{name}: eval restored step {evaluated['step']}, the run ended at {final['steps']}")
    summary = dict(steps=final["steps"], wall_s=wall, step_ms_p50=step_ms,
                   examples_per_s=batch / step_ms * 1e3, peak_mem_gib=peak_gib,
                   loss_first=losses[0], loss_last=losses[-1], losses=losses,
                   final={k: v for k, v in final.items() if k.startswith("eval_")},
                   eval_cli={k: v for k, v in evaluated.items() if k.startswith("eval_")},
                   launches=launches, card=smi)
    if not all(np.isfinite(losses)) or any(x["metrics"]["train/bad_step"] for x in windows):
        fail(f"{name}: losses not finite or a step skipped: {losses}")
    for k, v in summary["final"].items():  # the same checkpoint, kernels and batches
        if abs(evaluated[k] - v) > 1e-5 * max(1.0, abs(v)):
            fail(f"{name}: train.eval's {k} {evaluated[k]} differs from the run's final {v}")
    return summary


def phase_bert_glue(torch, counters, smi: str, tmp: str) -> dict:
    """BERT-base GLUE fine-tuning at the ``BertGlueConfig`` defaults with
    ``attention="flash"`` (bf16, dropout 0.1, batch 32 x 128, synthetic
    SST-2), checks (b) of the module docstring."""
    import shutil

    from tensorflow_examples_torch.core import rng
    from tensorflow_examples_torch.data.memory import train_iterator
    from tensorflow_examples_torch.train import cli
    from tensorflow_examples_torch.train.checkpoint import CheckpointManager
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import bert_glue

    base = bert_glue.BertGlueConfig(attention="flash")
    layers, batch = base.num_layers, base.global_batch_size
    train_ds, eval_ds = bert_glue.datasets(base)
    batch0 = next(train_iterator(train_ds, batch, seed=base.seed))

    # Step 0, f32, dropout 0.1 (the same masks on both paths): the flash
    # kernels against the plain attention.
    step0 = {}
    for impl in ("flash", "xla"):
        cfg = base.replace(precision="f32", attention=impl)
        trainer = Trainer(bert_glue.make_task(cfg), cfg)
        leaves = {k: p.detach().requires_grad_() for k, p in trainer.state.params.items()}
        reset_counts(counters)
        loss, _, _ = trainer.task.loss_fn(
            trainer.policy.cast_compute(leaves), {}, trainer.put_batch(batch0),
            rng=rng.StepNoise(trainer.step_key(0)), train=True)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        step0[impl] = (float(loss.detach()), dict(zip(leaves, grads)), {
            **{k: counters[k].launches for k in FLASH_KERNELS}, **flash_variants(counters)})
        del trainer, leaves, loss, grads
        torch.cuda.empty_cache()
    (loss_f, g_f, n_f), (loss_x, g_x, n_x) = step0["flash"], step0["xla"]
    rel = abs(loss_f - loss_x) / abs(loss_x)
    gname, gworst = max(((k, float((g_f[k] - g_x[k]).abs().max())
                          / max(float(g_x[k].abs().max()), 1e-30)) for k in g_x),
                        key=lambda kv: kv[1])
    log(f"bert step 0, f32, dropout 0.1: loss flash {loss_f:.7f} xla {loss_x:.7f} (rel "
        f"{rel:.2e}, limit 1e-5); worst grad {gname}: max|diff| / max|grad| {gworst:.2e} "
        f"(limit 1e-3) over {len(g_x)} tensors; launches flash {n_f}, xla {n_x}")
    if not (np.isfinite(loss_f) and rel <= 1e-5 and gworst <= 1e-3):
        fail("bert step 0: the flash step disagrees with the xla step")
    if n_f != flash_want(layers, "simt") or any(n_x.values()):
        fail(f"bert step 0: flash launches {n_f}, expected {flash_want(layers, 'simt')}; xla "
             f"{n_x}, expected none")
    del step0, g_f, g_x

    # The slice: 20 steps through the training CLI, checkpoints at 10 and 20.
    workdir = os.path.join(tmp, "bert")
    model = ["--attention", "flash"]
    run = cli_train(torch, counters, "bert_glue", model + [
        "--train_steps", str(TRAIN_STEPS), "--warmup_steps", "2", "--checkpoint_every", "10"],
        workdir, batch, smi, model)
    n_eval = -(-eval_ds.size // batch)
    want = {**flash_want(layers * TRAIN_STEPS, "tensor_core"),
            "flash_fwd": layers * (TRAIN_STEPS + n_eval),
            "flash_fwd_tensor_core": layers * (TRAIN_STEPS + n_eval), "ce_fwd": 0, "ce_bwd": 0}
    if run["launches"] != want:
        fail(f"bert: launches {run['launches']} over {TRAIN_STEPS} steps and {n_eval} eval "
             f"batches, expected {want} (12 of each a step, 12 forward an eval batch, all on "
             "the tensor cores)")
    run["launches_per_step"] = {k: layers for k in FLASH_KERNELS}

    # Resume: a fresh Trainer from the step-10 checkpoint trains to 20.
    resumed = workdir + "-resumed"
    shutil.copytree(CheckpointManager(workdir).step_dir(10),
                    os.path.join(resumed, "checkpoints", "10"))
    cfg = base.replace(train_steps=TRAIN_STEPS, warmup_steps=2, log_every=1, eval_every=0,
                       checkpoint_every=10, workdir=resumed, telemetry_sinks="")
    data = lambda start: train_iterator(train_ds, batch, seed=cfg.seed, start_step=start)
    trainer = Trainer(bert_glue.make_task(cfg), cfg)
    trainer.fit(data, num_steps=TRAIN_STEPS)
    ours = [x["loss"] for x in trainer.history]
    worst = max(abs(a - b) / abs(b) for a, b in zip(ours, run["losses"][10:]))
    if [x["step"] for x in trainer.history] != list(range(11, TRAIN_STEPS + 1)) or worst > 1e-3:
        fail(f"bert resume: steps {[x['step'] for x in trainer.history]}, losses {ours} vs "
             f"{run['losses'][10:]} (rel {worst:.2e}, limit 1e-3)")
    run["resume"] = dict(from_step=10, worst_rel_loss_diff=worst,
                         identical_steps=sum(a == b for a, b in zip(ours, run["losses"][10:])))
    batch_t = trainer.put_batch(next(data(TRAIN_STEPS)))

    def one_step():
        trainer.state, _ = trainer._train_step(trainer.state, batch_t)

    one_step()
    run["profile"] = device_split(torch, one_step)
    del trainer, batch_t
    # CoLA (MCC) and STS-B (Pearson, the regression head): a few steps and eval.
    run["tasks"] = {}
    for task, score in (("cola", "eval_mcc"), ("stsb", "eval_pearson")):
        gc.collect()
        torch.cuda.empty_cache()
        out = run_cli(cli.main, ["--workload", "bert_glue", "--task", task, *model, "--train_steps", "4",
                       "--warmup_steps", "1", "--log_every", "4", "--eval_every", "0",
                       "--telemetry_sinks", ""])
        if not np.isfinite(out.get(score, float("nan"))) or not np.isfinite(out["loss"]):
            fail(f"bert {task}: {score} missing or not finite: {out}")
        run["tasks"][task] = {k: v for k, v in out.items() if k.startswith("eval_")}
    log(f"bert_glue: {json.dumps(run)}")
    gc.collect()
    torch.cuda.empty_cache()
    return run


@contextlib.contextmanager
def cudnn_deterministic(torch):
    """cuDNN deterministic, its autotuner off (bitwise reruns), then as
    it was."""
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def write_cifar_batches(root: str, seed: int = 0) -> str:
    """CIFAR-10's python-pickle distribution at its real size (5 training
    batches and a test batch of 10 000 images each) with seeded uint8
    pixels and labels."""
    import pickle

    rng = np.random.default_rng(seed)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (10000, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, 10000).tolist()}, f)
    return root


def phase_cifar10(torch, counters, smi: str, tmp: str) -> dict:
    """CIFAR-10 ResNet-20 at the ``Cifar10Config`` defaults on seeded
    python-pickle batches (uint8, augmented by the native library),
    checks (c) of the module docstring."""
    from tensorflow_examples_torch import native
    from tensorflow_examples_torch.data.memory import train_iterator
    from tensorflow_examples_torch.train.checkpoint import CheckpointManager
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import cifar10

    t0 = time.perf_counter()
    data_dir = write_cifar_batches(os.path.join(tmp, "cifar-data"))
    write_s = time.perf_counter() - t0
    if not native.available():
        fail("cifar10: the native augmentation library (native/fastdata.cpp) did not build")
    base = cifar10.Cifar10Config(data_dir=data_dir)
    workdir = os.path.join(tmp, "cifar10")
    run = cli_train(torch, counters, "cifar10", ["--data_dir", data_dir, "--train_steps",
                                                 str(TRAIN_STEPS)],
                    workdir, base.global_batch_size, smi, ["--data_dir", data_dir])
    run["data_write_s"] = write_s
    saved, step = CheckpointManager(workdir).load_latest()
    stats = saved["model_state"]["batch_stats"]
    moved = stats_moved(torch, stats)
    if step != TRAIN_STEPS or moved != len(stats):
        fail(f"cifar10: {moved} of {len(stats)} running statistics moved off their init by "
             f"step {step}")
    run["batch_stats_moved"] = f"{moved} of {len(stats)}"

    # 4 steps as one launch of steps_per_launch=4 (a CUDA graph) against 4
    # eager steps, cuDNN deterministic.
    train_ds = cifar10.datasets(base)[0]
    cfg = base.replace(train_steps=4, log_every=4, eval_every=0, checkpoint_every=0,
                       telemetry_sinks="")
    data = lambda start: train_iterator(train_ds, cfg.global_batch_size, seed=cfg.seed,
                                        start_step=start, augment=cifar10.train_augment(cfg))
    with cudnn_deterministic(torch):
        runs = {}
        for k in (1, 4):
            trainer = Trainer(cifar10.make_task(cfg), cfg.replace(steps_per_launch=k))
            trainer.fit(data, num_steps=4)
            runs[k] = trainer
    vec = lambda t, part: torch.cat([x.float().reshape(-1) for x in
                                     (t.state.params.values() if part == "params" else
                                      t.state.model_state["batch_stats"].values())])
    graph = {}
    for part in ("params", "batch_stats"):
        a, b = vec(runs[1], part), vec(runs[4], part)
        graph[part] = dict(max_rel_diff=float((a - b).abs().max() / a.abs().max()),
                           bitwise=bool(torch.equal(a, b)))
    graph["losses_eager"] = runs[1].history[-1]["loss"]
    graph["losses_graph"] = runs[4].history[-1]["loss"]
    graph["graphs"] = runs[4].bundled_step(4).captured
    run["graph_k4"] = graph
    if graph["graphs"] != 1 or any(graph[p]["max_rel_diff"] > 1e-5
                                   for p in ("params", "batch_stats")):
        fail(f"cifar10: 4 steps as one CUDA graph against 4 eager steps: {graph} (limit 1e-5)")
    trainer = runs[1]
    batch_t = trainer.put_batch(next(data(4)))

    def one_step():
        trainer.state, _ = trainer._train_step(trainer.state, batch_t)

    one_step()
    run["profile"] = device_split(torch, one_step)
    del runs, trainer, batch_t
    log(f"cifar10: {json.dumps(run)}")
    gc.collect()
    torch.cuda.empty_cache()
    return run


def phase_mnist(torch, counters, smi: str, tmp: str) -> dict:
    """MNIST MLP at the ``MnistConfig`` defaults (synthetic data), 20
    steps and eval through the CLIs, and one profiled step."""
    from tensorflow_examples_torch.data.memory import train_iterator
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import mnist

    base = mnist.MnistConfig()
    run = cli_train(torch, counters, "mnist", ["--train_steps", str(TRAIN_STEPS)],
                    os.path.join(tmp, "mnist"), base.global_batch_size, smi, [])
    trainer = Trainer(mnist.make_task(base), base)
    batch_t = trainer.put_batch(next(train_iterator(mnist.datasets(base)[0],
                                                    base.global_batch_size, seed=base.seed)))

    def one_step():
        trainer.state, _ = trainer._train_step(trainer.state, batch_t)

    one_step()
    run["profile"] = device_split(torch, one_step)
    log(f"mnist: {json.dumps(run)}")
    del trainer, batch_t
    return run


# --------------------------------------------------------------- imagenet

IMAGENET_BATCH = 256          # bench.py:762's batch a chip: the phase's cut (default 1024)
IMAGENET_SYNTHETIC_STEPS = 10  # (a)'s depth: the numpy stream costs ~1.7 s a step
IMAGENET_EVAL_BATCHES = 2     # synthetic eval batches (default 8): each costs ~1.7 s of numpy
IMAGENET_OOM_BATCHES = (1024, 4096)  # one-step probes: the recipe's batch, and one past the card
# (b), (c') and (g): a TFRecord shard of the 64 fixture JPEGs repeated to
# 320 records, copied to 4 train shards (5 batches of 256 an epoch) and one
# validation shard (a batch of 256, then 64 rows padded to 256 under mask 0).
IMAGENET_FIXTURE = os.path.join("tests", "data", "imagenet_fixture.tfrecord")
IMAGENET_TRAIN_SHARDS, IMAGENET_SHARD_RECORDS = 4, 320
IMAGENET_WORKERS = 8       # decode workers (the card's host has 8 cores)
IMAGENET_FED_STEPS = 10    # steps of the fed run; its profiled window, run-relative
IMAGENET_RESUME_STEP = 7
IMAGENET_FED_PROFILE = (5, 2)
IMAGENET_ACCUM = 4         # the recipe's batch 1024 as 4 micro-batches of 256
IMAGENET_ACCUM_UPDATES = 2
PROM_SAMPLE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? "
                         r"(-?\d+(\.\d+)?([eE][+-]?\d+)?|NaN|[+-]Inf)$")
# A probe's process: one fitted step on a batch of zeros (the values do
# not move the memory; the synthetic stream would spend 7-27 s of numpy
# on the batch), telemetry lines in argv[2], exit non-zero on an OOM.
OOM_PROBE = """
import logging, sys
import numpy as np
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.workloads import imagenet
logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
n = int(sys.argv[1])
cfg = imagenet.ImagenetConfig(global_batch_size=n, train_steps=1, warmup_steps=5, log_every=1,
                              eval_every=0, checkpoint_every=0, prefetch_depth=1,
                              telemetry_sinks="jsonl", workdir=sys.argv[2])
batch = {"image": np.zeros((n, 224, 224, 3), np.float32), "label": np.zeros(n, np.int32)}
Trainer(imagenet.make_task(cfg), cfg).fit(iter([batch]))
"""


class MetricsScraper(threading.Thread):
    """Polls a training run's ``/metrics`` and ``/health`` until a scrape
    after the first window carries ``memory/peak_live_bytes``."""

    def __init__(self, port: int):
        super().__init__(daemon=True)
        self.port, self.result, self.stop = port, None, threading.Event()

    def run(self):
        base = f"http://127.0.0.1:{self.port}"
        while not self.stop.is_set():
            try:
                with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
                    metrics = (r.status, r.read().decode())
                with urllib.request.urlopen(base + "/health", timeout=5) as r:
                    health = (r.status, json.loads(r.read()))
            except (OSError, ValueError):
                time.sleep(0.2)
                continue
            if health[1].get("last_step") and "memory_peak_live_bytes" in metrics[1]:
                self.result = {"metrics": metrics, "health": health}
                return
            time.sleep(0.2)


def check_scrape(scraper) -> dict:
    """(f): the scrape parses as Prometheus text and carries the peak."""
    got = scraper.result
    if got is None:
        fail("imagenet (f): no scrape of /metrics with memory_peak_live_bytes during the run")
    samples = {}
    for line in got["metrics"][1].strip().splitlines():
        if line.startswith("#"):
            continue
        if not PROM_SAMPLE.match(line):
            fail(f"imagenet (f): /metrics line does not parse: {line!r}")
        samples[line.split("{")[0]] = float(line.rsplit(" ", 1)[1])
    if got["metrics"][0] != 200 or got["health"][0] != 200 or not (
            samples.get("memory_peak_live_bytes", 0) > 0):
        fail(f"imagenet (f): /metrics {got['metrics'][0]}, /health {got['health'][0]}, "
             f"peak {samples.get('memory_peak_live_bytes')}")
    return {"metrics_status": 200, "health_status": 200, "samples": len(samples),
            "memory_peak_live_bytes": samples["memory_peak_live_bytes"],
            "health_last_step": got["health"][1]["last_step"]}


def oom_probe(here: str, tmp: str, batch: int) -> dict:
    """``OOM_PROBE`` at ``global_batch_size`` ``batch`` in a process of
    its own (an OOM leaves the allocator fragmented): its exit code, its
    peak from the final line when the step fits, and whether its log
    holds the OOM report, with all its sections, before the traceback
    when it does not."""
    workdir = os.path.join(tmp, f"imagenet-oom-{batch}")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", OOM_PROBE, str(batch), workdir], cwd=here,
                       capture_output=True, text=True, timeout=600)
    out = {"global_batch_size": batch, "exit_code": p.returncode,
           "wall_s": time.perf_counter() - t0, "oom": "OutOfMemoryError" in p.stderr}
    lines = [json.loads(x) for x in open(os.path.join(workdir, "telemetry", "metrics.jsonl"))]
    final = [x for x in lines if x["kind"] == "final"][-1]
    out["exit_reason"] = final["exit_reason"]
    out["fits"] = p.returncode == 0
    if out["fits"]:
        out["peak_live_gib"] = final["memory"]["peak_live_bytes"] / 2**30
        return out
    report_at = p.stderr.find("== OOM allocation forensics ==")
    traceback_at = p.stderr.find("Traceback", max(report_at, 0))
    report = p.stderr[report_at:traceback_at] if report_at >= 0 else ""
    out["report_before_traceback"] = 0 <= report_at < traceback_at
    out["report_sections"] = [s for s in ("live arrays:", "fit-start breakdown:",
                                          "device allocator:", "live arrays by size:")
                              if s in report]
    out["report_head"] = report.splitlines()[1:5]
    return out


def resnet_kinds(kernels) -> dict:
    """A ResNet step's kernel ms by kind, from ``device_split``'s
    (name, ms) list: cuDNN's layout transposes, convolutions and matmuls
    (cuDNN, CUTLASS, cuBLAS), reductions (BatchNorm's statistics, the
    loss), pooling, elementwise (BatchNorm's apply, ReLU, casts, the
    optimizer) and the rest."""
    kinds = {"layout": 0.0, "conv_matmul": 0.0, "reduce": 0.0, "pool": 0.0,
             "elementwise": 0.0, "other": 0.0}
    for name, ms in kernels:
        n = name.lower()
        kind = ("layout" if "nchwtonhwc" in n or "nhwctonchw" in n else
                "conv_matmul" if any(t in n for t in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                                                      "xmma", "cutlass", "gemm", "nvjet"))
                else "reduce" if "reduce" in n else
                "pool" if "pool" in n else
                "elementwise" if "elementwise" in n else "other")
        kinds[kind] += ms
    return kinds


def write_imagenet_shards(here: str, root: str) -> str:
    """The fixture's records repeated into one shard by the port's own
    writer, copied to the ``train-*`` and ``validation-*`` shards (the
    writer's pure-Python CRCs cost ~5 ms a record)."""
    import shutil

    from tensorflow_examples_torch.data import sources

    recs = list(sources.iter_tfrecord_records(os.path.join(here, IMAGENET_FIXTURE),
                                              verify_crc=True))
    os.makedirs(root, exist_ok=True)
    first = os.path.join(root, f"train-00000-of-{IMAGENET_TRAIN_SHARDS:05d}")
    sources.write_tfrecord(first, [recs[i % len(recs)] for i in range(IMAGENET_SHARD_RECORDS)])
    for s in range(1, IMAGENET_TRAIN_SHARDS):
        shutil.copyfile(first, os.path.join(root, f"train-{s:05d}-of-{IMAGENET_TRAIN_SHARDS:05d}"))
    shutil.copyfile(first, os.path.join(root, "validation-00000-of-00001"))
    return root


def take_batches(it, n: int) -> tuple[list, float, float]:
    """``n`` batches of a stream, the seconds they took (the pool's
    start-up and first batch included) and the images/s after the first
    batch (``n`` > 1), the stream closed after."""
    t0 = time.perf_counter()
    out, arrived = [], []
    for _ in range(n):
        out.append(next(it))
        arrived.append(time.perf_counter())
    close = getattr(it, "close", None)
    if close is not None:
        close()
    rate = sum(len(b["label"]) for b in out[1:]) / (arrived[-1] - arrived[0]) if n > 1 else None
    return out, arrived[-1] - t0, rate


def span_p50s(trace_path: str, first: int) -> dict:
    """The input spans of a run's host trace, p50 ms and count:
    ``data_fetch`` (the loop's wait for its next batch), ``data_wait``
    (the prefetcher's pops from the decode workers), ``data_work`` split
    into the workers' (a batch parsed and decoded on one thread) and the
    loop thread's (a batch pinned and its copy issued), whose durations
    are listed. The process's tracer holds every earlier run's spans
    too: the run's own start at index ``first``."""
    events = json.load(open(trace_path))
    events = (events["traceEvents"] if isinstance(events, dict) else events)[first:]
    named = lambda n: [e for e in events if e.get("name") == n]
    loop = {e["tid"] for e in named("data_fetch")}
    work = named("data_work")
    spans = {"data_fetch": named("data_fetch"), "data_wait": named("data_wait"),
             "data_work_decode": [e for e in work if e["tid"] not in loop],
             "data_work_place": [e for e in work if e["tid"] in loop]}
    out = {}
    for name, es in spans.items():
        out[f"{name}_ms_p50"] = float(np.median([e["dur"] for e in es])) / 1e3 if es else None
        out[f"{name}_count"] = len(es)
    out["data_fetch_ms"] = [round(e["dur"] / 1e3, 2) for e in spans["data_fetch"]]
    return out


def profile_idle(profile_dir: str, wall_s: float) -> dict:
    """The card's idle share over a training run's profiler window: the
    union of the kernels' intervals in its trace against the window's
    host wall."""
    path = max((os.path.join(profile_dir, f) for f in os.listdir(profile_dir)),
               key=os.path.getmtime)
    events = json.load(open(path))
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel" and e.get("ph") == "X")
    busy_us, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return {"kernels": len(spans), "busy_ms": busy_us / 1e3, "wall_ms": wall_s * 1e3,
            "idle_share": 1.0 - busy_us / 1e6 / wall_s}


def window_metric(workdir: str, key: str) -> dict:
    """step -> a window line's metric, from a run's telemetry lines."""
    lines = [json.loads(x) for x in open(os.path.join(workdir, "telemetry", "metrics.jsonl"))]
    return {x["step"]: x["metrics"][key] for x in lines if x["kind"] == "window"}


def stats_moved(torch, stats) -> int:
    """How many BatchNorm running statistics left their init (means 0,
    variances 1)."""
    return sum(not torch.equal(t, torch.zeros_like(t) if k.endswith("mean") else
                               torch.ones_like(t)) for k, t in stats.items())


def imagenet_shards(torch, counters, smi: str, tmp: str, here: str, base, probes) -> dict:
    """Checks (b), (c') and (g) of the module docstring: ResNet-50 fed by
    the port's JPEG stage from TFRecord shards."""
    import shutil

    from tensorflow_examples_torch import native
    from tensorflow_examples_torch.data import imagenet as imagenet_data
    from tensorflow_examples_torch.data import sources
    from tensorflow_examples_torch.telemetry import spans
    from tensorflow_examples_torch.train import cli
    from tensorflow_examples_torch.train.checkpoint import CheckpointManager
    from tensorflow_examples_torch.workloads import imagenet

    out = {}
    t0 = time.perf_counter()
    root = write_imagenet_shards(here, os.path.join(tmp, "imagenet-shards"))
    if not native.available("jpeg"):
        fail(f"imagenet (b): the port's JPEG decoder did not build: {native.build_errors}")
    b = {"shards_written_s": time.perf_counter() - t0, "library": native.jpeg_library_path(),
         "train_records": IMAGENET_TRAIN_SHARDS * IMAGENET_SHARD_RECORDS,
         "validation_records": IMAGENET_SHARD_RECORDS}
    ldd = subprocess.run(["ldd", native.jpeg_library_path()], capture_output=True, text=True)
    if "libjpeg" in ldd.stdout:
        fail(f"imagenet (b): the port's decoder links libjpeg: {ldd.stdout}")
    fed = base.replace(data_dir=root, input_workers=IMAGENET_WORKERS)
    epoch = IMAGENET_TRAIN_SHARDS * IMAGENET_SHARD_RECORDS // IMAGENET_BATCH

    # The stage alone on one thread, then the pipeline.
    jpegs = [imagenet_data.parse_imagenet_example(r)[0] for r in
             sources.iter_tfrecord_records(os.path.join(here, IMAGENET_FIXTURE))]
    jpegs = (jpegs * (IMAGENET_BATCH // len(jpegs) + 1))[:IMAGENET_BATCH]
    t0 = time.perf_counter()
    imagenet_data.decode_augment_batch(jpegs, list(range(len(jpegs))), train=True,
                                       image_size=base.image_size, seed=0, step=0, threads=1)
    b["stage_images_per_s_1_thread"] = len(jpegs) / (time.perf_counter() - t0)
    # Two epochs inline and through 8 workers, compared; 3 batches through 1.
    inline, b["inline_s"], _ = take_batches(
        imagenet.make_train_iter(fed.replace(input_workers=0), 0), 2 * epoch)
    pooled, b["workers_8_s"], b["images_per_s_8_workers"] = take_batches(
        imagenet.make_train_iter(fed, 0), 2 * epoch)
    _, b["workers_1_s"], b["images_per_s_1_worker"] = take_batches(
        imagenet.make_train_iter(fed.replace(input_workers=1), 0), 3)
    b["images_per_s_inline"] = 2 * epoch * IMAGENET_BATCH / b["inline_s"]
    same = all(np.array_equal(x[k], y[k]) for x, y in zip(inline, pooled) for k in x)
    size = base.image_size
    if not same or len(pooled) != 2 * epoch or inline[0]["image"].shape != (
            IMAGENET_BATCH, size, size, 3):
        fail(f"imagenet (b): {IMAGENET_WORKERS} workers' batches differ from the inline decode's")
    b["workers_equal_inline"] = f"{2 * epoch} batches (2 epochs) bitwise"
    del inline, pooled
    log(f"imagenet (b) pipeline: {json.dumps(b)}; host {os.cpu_count()} cpus; {smi}")

    # 10 fed steps through train.cli (cuDNN deterministic, so that a
    # resume can be held bitwise), a window of them profiled, then the
    # run resumed from its step-7 checkpoint in a fresh workdir.
    argv = ["--global_batch_size", str(IMAGENET_BATCH), "--warmup_steps", "5",
            "--data_dir", root, "--input_workers", str(IMAGENET_WORKERS)]
    first_span = len(spans.default_tracer().chrome_trace()["traceEvents"])
    with cudnn_deterministic(torch):
        workdir = os.path.join(tmp, "imagenet-fed")
        p_start, p_num = IMAGENET_FED_PROFILE
        run = cli_train(torch, counters, "imagenet",
                        [*argv, "--train_steps", str(IMAGENET_FED_STEPS),
                         "--checkpoint_every", str(IMAGENET_RESUME_STEP),
                         "--profile_start_step", str(p_start),
                         "--profile_num_steps", str(p_num)],
                        workdir, IMAGENET_BATCH, smi, argv)
        resumed_dir = os.path.join(tmp, "imagenet-fed-resumed")
        src = os.path.join(workdir, "checkpoints", str(IMAGENET_RESUME_STEP))
        shutil.copytree(src, os.path.join(resumed_dir, "checkpoints", str(IMAGENET_RESUME_STEP)))
        run_cli(cli.main, ["--workload", "imagenet", *argv, "--train_steps",
                           str(IMAGENET_FED_STEPS), "--workdir", resumed_dir,
                           "--telemetry_sinks", "jsonl", "--log_every", "1",
                           "--eval_every", "0"])
    if any(run["launches"].values()):
        fail(f"imagenet (b): ResNet-50 launched a port kernel: {run['launches']}")
    losses = window_metric(workdir, "train/loss")
    again = window_metric(resumed_dir, "train/loss")
    tail = range(IMAGENET_RESUME_STEP + 1, IMAGENET_FED_STEPS + 1)
    final_a, _ = CheckpointManager(workdir).load_latest()
    final_b, _ = CheckpointManager(resumed_dir).load_latest()
    params_equal = all(torch.equal(v, final_b["params"][k]) for k, v in final_a["params"].items())
    stats = final_a["model_state"]["batch_stats"]
    b["resume"] = {"steps": list(tail), "uninterrupted": [losses[s] for s in tail],
                   "resumed": [again.get(s) for s in tail], "final_params_bitwise": params_equal}
    if [again.get(s) for s in tail] != [losses[s] for s in tail] or not params_equal:
        fail(f"imagenet (b): the resume at step {IMAGENET_RESUME_STEP} is not the uninterrupted "
             f"run: {b['resume']}")
    if stats_moved(torch, stats) != len(stats):
        fail("imagenet (b): a running statistic did not move")
    del final_a, final_b, stats
    step_s = window_metric(workdir, "train/step_time_s")
    profiled = set(range(p_start + 1, p_start + p_num + 1))
    timed_steps = [v for k, v in step_s.items() if k > 1 and k not in profiled]
    lines = [json.loads(x) for x in open(os.path.join(workdir, "telemetry", "metrics.jsonl"))]
    prof = [x for x in lines if x["kind"] == "final"][-1]["profile"]
    b["fed"] = {"step_ms_p50": float(np.median(timed_steps)) * 1e3,
                "steps_timed": len(timed_steps),
                "examples_per_s": IMAGENET_BATCH / float(np.median(timed_steps)),
                "losses": run["losses"], "peak_mem_gib": run["peak_mem_gib"],
                **span_p50s(os.path.join(workdir, "telemetry", "trace.json"), first_span),
                "profiled_steps": sorted(profiled),
                "profile": profile_idle(prof["dir"], prof["wall_secs"]),
                "cudnn": "deterministic, benchmark off"}
    log(f"imagenet (b) fed: {json.dumps(b['fed'])}; resume {json.dumps(b['resume'])}; {smi}")
    out["b"] = b

    # (c') the eval over the padded validation shard: the run's final eval
    # and train.eval's agree (cli_train), the pad rows under mask 0.
    masks = [x["mask"] for x in imagenet.make_eval_iter(fed)]
    pad = len(masks) * IMAGENET_BATCH - IMAGENET_SHARD_RECORDS
    weight = sum(float(m.sum()) for m in masks)
    out["c_shards"] = {"final": run["final"], "eval_cli": run["eval_cli"], "batches": len(masks),
                       "weight": weight, "pad_rows": pad}
    if weight != IMAGENET_SHARD_RECORDS or float(masks[-1][IMAGENET_BATCH - pad:].sum()) != 0 \
            or not all(np.isfinite(v) for v in run["final"].values()):
        fail(f"imagenet (c'): padded eval {out['c_shards']}")
    log(f"imagenet (c') padded eval: {json.dumps(out['c_shards'])}")

    # (g) the recipe's batch: 1024 as IMAGENET_ACCUM micro-batches of 256,
    # IMAGENET_ACCUM_UPDATES applied updates, beside (e)'s one-step probe.
    workdir_g = os.path.join(tmp, "imagenet-accum")
    argv_g = [*argv, "--grad_accum_steps", str(IMAGENET_ACCUM)]
    accum = cli_train(torch, counters, "imagenet",
                      [*argv_g, "--train_steps", str(IMAGENET_ACCUM * IMAGENET_ACCUM_UPDATES)],
                      workdir_g, IMAGENET_BATCH, smi, argv_g)
    saved, step = CheckpointManager(workdir_g).load_latest()
    stats = saved["model_state"]["batch_stats"]
    moved = stats_moved(torch, stats)
    recipe = probes[0]
    out["g"] = {"global_batch": IMAGENET_ACCUM * IMAGENET_BATCH, "micro_batch": IMAGENET_BATCH,
                "grad_accum_steps": IMAGENET_ACCUM, "micro_steps": step,
                "updates": step // IMAGENET_ACCUM, "losses": accum["losses"],
                "batch_stats_moved": f"{moved} of {len(stats)}",
                "peak_mem_gib": accum["peak_mem_gib"], "micro_step_ms_p50": accum["step_ms_p50"],
                "one_step_1024_probe": {k: recipe.get(k) for k in (
                    "fits", "exit_reason", "peak_live_gib", "oom")}}
    if step != IMAGENET_ACCUM * IMAGENET_ACCUM_UPDATES or moved != len(stats) \
            or not all(np.isfinite(accum["losses"])):
        fail(f"imagenet (g): {out['g']}")
    log(f"imagenet (g) batch {IMAGENET_ACCUM * IMAGENET_BATCH} as {IMAGENET_ACCUM} x {IMAGENET_BATCH}: "
        f"{json.dumps(out['g'])}; "
        f"{smi}")
    del saved, stats
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_imagenet(torch, counters, smi: str, tmp: str, here: str) -> dict:
    """ResNet-50 on ImageNet at the ``ImagenetConfig`` defaults but the
    batch (``IMAGENET_BATCH``), 20 steps with warmup 5 and a shorter
    synthetic eval, checks (a) and (c)-(f) of the module docstring."""
    from tensorflow_examples_torch.telemetry.memory import tree_bytes
    from tensorflow_examples_torch.train import cli
    from tensorflow_examples_torch.train.checkpoint import CheckpointManager
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import imagenet

    t_phase = time.perf_counter()
    cuts = {"global_batch_size": IMAGENET_BATCH, "train_steps": IMAGENET_SYNTHETIC_STEPS,
            "warmup_steps": 5,
            "eval_batches": IMAGENET_EVAL_BATCHES}
    argv = [a for k, v in cuts.items() for a in (f"--{k}", str(v))]
    base = imagenet.ImagenetConfig(**cuts, telemetry_sinks="")
    out = {"config": "resnet50, 224 px, 1000 classes, bf16, sgd nesterov warmup-cosine, "
                     "label smoothing 0.1, synthetic stream", "reduced": cuts, "card": smi}

    # (a) the synthetic stream through train.cli, scraped (f) while it runs.
    port = free_port()
    scraper = MetricsScraper(port)
    scraper.start()
    workdir = os.path.join(tmp, "imagenet")
    run = cli_train(torch, counters, "imagenet", [*argv, "--metrics_port", str(port)], workdir,
                    IMAGENET_BATCH, smi, argv)
    scraper.stop.set()
    scraper.join(10)
    out["f"] = check_scrape(scraper)
    lines = [json.loads(x) for x in open(os.path.join(workdir, "telemetry", "metrics.jsonl"))]
    saved, step = CheckpointManager(workdir).load_latest()
    stats = saved["model_state"]["batch_stats"]
    moved = stats_moved(torch, stats)
    if step != IMAGENET_SYNTHETIC_STEPS or moved != len(stats):
        fail(f"imagenet (a): {moved} of {len(stats)} running statistics moved by step {step}")
    run["batch_stats_moved"] = f"{moved} of {len(stats)}"
    if any(run["launches"].values()):
        fail(f"imagenet (a): ResNet-50 launched a port kernel: {run['launches']}")
    del saved, stats
    # (c) the run's final eval equals train.eval's (cli_train holds them to
    # 1e-5); the synthetic eval's weight is every row, mask 1.
    masks = [b["mask"] for b in imagenet.make_eval_iter(base)]
    weight = sum(float(m.sum()) for m in masks)
    if weight != IMAGENET_EVAL_BATCHES * IMAGENET_BATCH or any(m.min() != 1.0 for m in masks):
        fail(f"imagenet (c): synthetic eval weight {weight}")
    out["c"] = {"final": run["final"], "eval_cli": run["eval_cli"], "weight": weight}

    trainer = Trainer(imagenet.make_task(base), base)
    # (e) the fit-start line against the state; the run's peak against the allocator's.
    mem = lines[0]["memory"]
    want = {"params_bytes": tree_bytes(trainer.state.params),
            "opt_bytes": tree_bytes(trainer.state.opt_state),
            "model_state_bytes": tree_bytes(trainer.state.model_state)}
    if lines[0]["kind"] != "memory" or any(mem[k] != v for k, v in want.items()):
        fail(f"imagenet (e): memory line {mem} against tree_bytes {want}")
    final_peak = lines[-1]["memory"]["peak_live_bytes"]
    allocator_peak = run["peak_mem_gib"] * 2**30
    out["e"] = {**want, "final_peak_live_gib": final_peak / 2**30,
                "max_memory_allocated_gib": run["peak_mem_gib"],
                "ratio": final_peak / allocator_peak}
    if abs(final_peak / allocator_peak - 1.0) > 0.05:
        fail(f"imagenet (e): the final line's peak {final_peak} is not within 5% of "
             f"torch.cuda.max_memory_allocated {allocator_peak}")
    host_batch = next(imagenet.make_train_iter(base, 0))
    batch_t = trainer.put_batch(host_batch)

    def one_step():
        trainer.state, _ = trainer._train_step(trainer.state, batch_t)

    one_step()
    run["profile"] = profile = device_split(torch, one_step, top=0)
    run["profile_by_kind_ms"] = resnet_kinds(profile["top"])
    profile["top"] = profile["top"][:16]
    # The trainer with its input free: fit over one host batch repeated.
    repeated = Trainer(imagenet.make_task(base), base.replace(log_every=1))
    repeated.fit(iter([host_batch] * 10), num_steps=10)
    step_s = [h["step_time_s"] for h in repeated.history[1:]]
    run["repeated_batch_step_ms_p50"] = float(np.median(step_s)) * 1e3
    run["repeated_batch_examples_per_s"] = IMAGENET_BATCH / float(np.median(step_s))
    out["a"] = run
    del trainer, repeated, batch_t, host_batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"imagenet (a) synthetic: {json.dumps(run)}")
    log(f"imagenet (c) eval: {json.dumps(out['c'])}; (f) metrics server: {json.dumps(out['f'])}")

    # (d) LARS: 4 steps through the CLI; loss finite, parameters moved.
    workdir_d = os.path.join(tmp, "imagenet-lars")
    final = run_cli(cli.main, ["--workload", "imagenet", "--optimizer", "lars",
                               "--global_batch_size", str(IMAGENET_BATCH), "--train_steps", "4",
                               "--warmup_steps", "5", "--eval_batches", "1",
                               "--telemetry_sinks", "", "--workdir", workdir_d])
    saved, step = CheckpointManager(workdir_d).load_latest()
    init = Trainer(imagenet.make_task(base), base).state.params
    moved = sum(not torch.equal(saved["params"][k].to(init[k].device), v)
                for k, v in init.items())
    out["d"] = {"steps": step, "loss": final["loss"], "params_moved": f"{moved} of {len(init)}"}
    if step != 4 or not np.isfinite(final["loss"]) or moved < 0.95 * len(init):
        fail(f"imagenet (d): lars {out['d']}")
    del saved, init
    gc.collect()
    torch.cuda.empty_cache()
    log(f"imagenet (d) lars: {json.dumps(out['d'])}")

    # (e) one-step probes at the recipe's batch and past the card, each in
    # a process of its own.
    probes = [oom_probe(here, tmp, n) for n in IMAGENET_OOM_BATCHES]
    out["e"]["probes"] = probes
    recipe, over = probes
    full_report = lambda p: (p["oom"] and p["report_before_traceback"]
                             and len(p["report_sections"]) == 4)
    if not recipe["fits"] and not full_report(recipe):
        fail(f"imagenet (e): global_batch_size {recipe['global_batch_size']} neither ran nor "
             f"ended in an OOM with its report: {recipe}")
    if over["fits"] or over["exit_reason"] != "error:OutOfMemoryError" or not full_report(over):
        fail(f"imagenet (e): global_batch_size {over['global_batch_size']} must end in "
             f"torch.OutOfMemoryError with the report before the traceback: {over}")
    log(f"imagenet (e) memory: {json.dumps(out['e'])}; {smi}")
    out.update(imagenet_shards(torch, counters, smi, tmp, here, base, probes))
    out["phase_s"] = time.perf_counter() - t_phase
    fed = out["b"]["fed"]
    log(f"imagenet: phase {out['phase_s']:.1f} s, step p50 {run['step_ms_p50']:.2f} ms "
        f"(synthetic stream), {run['repeated_batch_step_ms_p50']:.2f} ms (one batch repeated), "
        f"{fed['step_ms_p50']:.2f} ms (shards, {IMAGENET_WORKERS} workers, idle "
        f"{fed['profile']['idle_share']:.1%}), peak {run['peak_mem_gib']:.2f} GiB, batch "
        f"{recipe['global_batch_size']} {'fits' if recipe['fits'] else 'OOM'} in one step, "
        f"{out['g']['micro_step_ms_p50']:.2f} ms a micro-step as {IMAGENET_ACCUM} x "
        f"{IMAGENET_BATCH}; {smi}")
    return out


# ------------------------------------------------------------------ mesh

MESH_LAYERS = 2   # the mesh phase's depth cut (GPT-2 124M widths, 12 layers by default)
MESH_STEPS = 4    # steps of a layout's f32 trajectory
MESH_BF16_STEPS = 2  # bf16 steps a layout; the second is timed
MESH_LAYOUTS_2 = (  # (name, mesh, config overrides) in one world of 2 ranks on the card
    ("data", {"data": 2}, {}),
    ("data+zero1", {"data": 2}, {"zero1": True}),
    ("fsdp", {"fsdp": 2}, {}),
    ("model+tp_vocab", {"model": 2}, {"tp_vocab": True}),
    ("context ring zigzag", {"context": 2}, {"attention": "flash"}),
    ("context ulysses", {"context": 2}, {"attention": "ulysses"}),
)
# Pipeline and expert-parallel layouts. Worker keys beside the config's:
# "bf16" False skips the timed bf16 run, "capacity" is the MoE capacity
# factor, and a layout's f32 losses are held to its "ref" run.
MESH_PIPE_LAYERS = 4  # interleaving: 2 stages x 2 virtual stages a rank
MESH_MICROBATCHES = 4  # Gpt2Config's num_microbatches default
MESH_EP_CAPACITY = 4.0  # the seeded init routes up to 2.35x the mean load to one expert
MESH_LAYOUTS_2 += (
    ("pipe 1f1b", {"pipe": 2}, {}),
    ("pipe gpipe", {"pipe": 2}, {"pipeline_schedule": "gpipe"}),
    ("pipe 1f1b 4 layers", {"pipe": 2}, {"num_layers": MESH_PIPE_LAYERS, "bf16": False,
                                         "ref": "one rank 4 layers"}),
    ("pipe interleaved", {"pipe": 2}, {"num_layers": MESH_PIPE_LAYERS, "pipe_interleave": 2,
                                       "ref": "pipe 1f1b 4 layers"}),
)
# The dense {data: 2, model: 2} layout is left to "data+model moe ep",
# whose h_0 is a dense tensor-parallel block on the same mesh.
MESH_LAYOUTS_4 = (("data+pipe", {"data": 2, "pipe": 2}, {}),
                  ("model+pipe flash", {"model": 2, "pipe": 2}, {"attention": "flash"}),
                  ("data+model moe ep", {"data": 2, "model": 2},
                   {"moe_experts": 8, "moe_top_k": 2, "capacity": MESH_EP_CAPACITY,
                    "ref": "one rank moe"}))
MESH_PIPE_LAYOUTS = ("pipe 1f1b", "pipe gpipe", "pipe 1f1b 4 layers", "pipe interleaved",
                     "data+pipe", "model+pipe flash")
MESH_RTOL = 3e-3        # mesh against one device, f32 (tests/test_sharding.py:306-321)
MESH_ATOL = 1e-5        # beside MESH_RTOL for the running statistics (the CPU tests')
MESH_ZERO1_RTOL = 1e-6  # ZeRO-1 against data parallelism (tests/test_sharding.py:352)
MESH_INTERLEAVE_RTOL = 1e-5  # interleaved against plain 1F1B (tests/test_train_gpt2.py:352)
MESH_WORKER_KEYS = ("bf16", "capacity", "ref")
MESH_CLI = ["--workload", "gpt2", "--num_layers", str(MESH_LAYERS), "--warmup_steps", "2",
            "--log_every", "1", "--eval_every", "0", "--checkpoint_every", "4",
            "--telemetry_sinks", "jsonl"]


def mesh_config(**kw):
    """GPT-2 124M widths (d 768, 12 heads of 64, seq 1024, vocab 50257,
    batch 16) at ``MESH_LAYERS`` layers, f32, dropout 0, no files."""
    from tensorflow_examples_torch.workloads import gpt2

    base = dict(num_layers=MESH_LAYERS, dropout=0.0, precision="f32", warmup_steps=2,
                train_steps=MESH_STEPS, log_every=MESH_STEPS, eval_every=0, checkpoint_every=0,
                watchdog_secs=0, telemetry_sinks="")
    base.update(kw)
    return gpt2.Gpt2Config(**base)


def mesh_batches(cfg, n: int) -> list:
    rng = np.random.RandomState(0)
    return [{"tokens": rng.randint(0, cfg.vocab_size, size=(cfg.global_batch_size,
                                                             cfg.seq_len + 1)).astype(np.int32)}
            for _ in range(n)]


def mesh_steps(torch, trainer, batches, drops: list | None = None) -> tuple[list, list]:
    """(losses, step ms) of ``trainer.train_step`` over ``batches``; an
    MoE step's ``moe_drop`` is appended to ``drops``."""
    losses, ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        losses.append(float(metrics["loss"]))  # syncs
        ms.append((time.perf_counter() - t0) * 1e3)
        if drops is not None and "moe_drop" in metrics:
            drops.append(float(metrics["moe_drop"]))
    return losses, ms


def pipe_launches_want(name: str, kw: dict, mesh_kw: dict, rank: int) -> dict:
    """Kernels 1-5 a pipeline layout launches on ``rank`` in MESH_STEPS
    f32 steps: 1F1B runs each microbatch's stage forward twice (the
    forward tick, and again in the backward tick) and its backward once,
    and the last stage adds the head's CE the same way; GPipe runs each
    microbatch's stage once each way and the head on every rank, over
    the rank's whole batch."""
    n_pipe = mesh_kw["pipe"]
    layers = kw.get("num_layers", MESH_LAYERS) // n_pipe
    stage = rank % n_pipe  # pipe is the minor axis of every layout here
    m = MESH_MICROBATCHES
    if kw.get("pipeline_schedule") == "gpipe":
        per = {"flash_fwd": m * layers, "flash_bwd_dkv": m * layers, "flash_bwd_dq": m * layers,
               "ce_fwd": 1, "ce_bwd": 1}
    else:
        last = stage == n_pipe - 1
        per = {"flash_fwd": 2 * m * layers, "flash_bwd_dkv": m * layers,
               "flash_bwd_dq": m * layers, "ce_fwd": 2 * m if last else 0,
               "ce_bwd": m if last else 0}
    return {k: v * MESH_STEPS for k, v in per.items()}


class rank_routing(pinned_routing):
    """``pinned_routing`` without the router jitter, for comparing an
    expert-parallel rank with the one-rank run: the jitter's keys differ
    between them by design (the expert-parallel router folds each route
    axis's index into its key), so both runs route without it, and a
    rank replays the one-rank run's decisions for its own tokens."""

    def route(self, tokens, gate_w, *, top_k, rng, jitter):
        return super().route(tokens, gate_w, top_k=top_k, rng=None, jitter=0.0)


def mesh_counters():
    from tensorflow_examples_torch.ops import attention, cross_entropy

    return {"flash_fwd": attention.flash_fwd, "flash_bwd_dkv": attention.flash_bwd_dkv,
            "flash_bwd_dq": attention.flash_bwd_dq, "ce_fwd": cross_entropy.ce_fwd,
            "ce_bwd": cross_entropy.ce_bwd}


# BERT-base and ResNet-50 on the world of 2: f32 trajectories
# against one rank, then bf16 steps a rank, the second timed.
WORKLOAD_STEPS = 4        # f32 steps of each against its one-rank run
WORKLOAD_BF16_STEPS = 2
RESNET_MESH_BATCH = 64    # ResNet-50's f32 global batch: 2 x 32 on {data: 2}
RESNET_MESH_BF16_BATCH = 256  # 2 x 128, against phase_imagenet's one-rank 256
BERT_MESH_LAYOUT = {"model": 2}
RESNET_MESH_LAYOUT = {"data": 2}


def resnet_mesh_config(precision: str, batch: int):
    """ResNet-50 at the recipe's widths (224 px, 1000 classes), its
    learning rate scaled to the batch as the recipe scales it (0.1 x
    batch / 256), warmup 2, no files."""
    from tensorflow_examples_torch.workloads import imagenet

    return imagenet.ImagenetConfig(global_batch_size=batch, precision=precision, warmup_steps=2,
                                   learning_rate=0.1 * batch / 256,
                                   train_steps=WORKLOAD_STEPS, log_every=WORKLOAD_STEPS,
                                   eval_every=0, checkpoint_every=0, watchdog_secs=0,
                                   telemetry_sinks="")


def resnet_batches(cfg, n: int) -> list:
    """``n`` seeded global batches of normalized-scale images and labels."""
    rng = np.random.default_rng(0)
    shape = (cfg.global_batch_size, cfg.image_size, cfg.image_size, 3)
    return [{"image": rng.standard_normal(shape, dtype=np.float32),
             "label": rng.integers(0, cfg.num_classes, cfg.global_batch_size).astype(np.int32)}
            for _ in range(n)]


def bert_mesh_config(precision: str):
    """BERT-base GLUE sst2 at the recipe's batch 32 x 128, flash attention,
    dropout 0, warmup 2, no files."""
    from tensorflow_examples_torch.workloads import bert_glue

    return bert_glue.BertGlueConfig(attention="flash", dropout=0.0, precision=precision,
                                    warmup_steps=2, train_steps=WORKLOAD_STEPS,
                                    log_every=WORKLOAD_STEPS, eval_every=0, checkpoint_every=0,
                                    watchdog_secs=0, telemetry_sinks="")


def bert_batches(cfg, n: int) -> list:
    from tensorflow_examples_torch.data import memory
    from tensorflow_examples_torch.workloads import bert_glue

    it = memory.train_iterator(bert_glue.datasets(cfg)[0], cfg.global_batch_size, seed=0)
    return [next(it) for _ in range(n)]


def workload_runs(torch, device, *, on_mesh: bool, resnet_bf16: bool = True) -> dict:
    """ResNet-50 on ``RESNET_MESH_LAYOUT`` and BERT-base flash on
    ``BERT_MESH_LAYOUT`` (or, ``on_mesh`` False, one rank): each one's f32
    losses over ``WORKLOAD_STEPS`` (ResNet-50's final ``batch_stats``, cuDNN
    deterministic; BERT's flash launches counted from 0 around them),
    then ``WORKLOAD_BF16_STEPS`` bf16 steps, the second timed, with the
    peak memory a rank (one rank: BERT's alone; ResNet-50's is
    phase_imagenet's at 256)."""
    from tensorflow_examples_torch.sharding import ShardingConfig
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import bert_glue, imagenet

    out = {}
    for name, layout, module, make_cfg, make_batches, runs in (
            ("resnet50", RESNET_MESH_LAYOUT, imagenet,
             lambda p: resnet_mesh_config(p, RESNET_MESH_BATCH if p == "f32" else
                                          RESNET_MESH_BF16_BATCH), resnet_batches,
             ("f32", "bf16") if resnet_bf16 else ("f32",)),
            ("bert", BERT_MESH_LAYOUT, bert_glue, bert_mesh_config, bert_batches,
             ("f32", "bf16"))):
        sc = ShardingConfig(mesh=layout if on_mesh else {"data": 1})
        mesh = sc.build_mesh(device=device)
        counters = mesh_counters()
        res = {}
        for precision in runs:
            cfg = make_cfg(precision)
            t0 = time.perf_counter()
            trainer = Trainer(module.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc)
            batches = make_batches(cfg, WORKLOAD_STEPS if precision == "f32"
                                   else WORKLOAD_BF16_STEPS)
            reset_counts(counters)
            torch.cuda.reset_peak_memory_stats(device)
            with cudnn_deterministic(torch) if name == "resnet50" else contextlib.nullcontext():
                losses, ms = mesh_steps(torch, trainer, batches)
            if precision == "f32":
                res.update(losses=losses, launches={k: c.launches for k, c in counters.items()
                                                    if k.startswith("flash")})
                if name == "resnet50":
                    res["batch_stats"] = {k: v.cpu().numpy() for k, v in
                                          trainer.state.model_state["batch_stats"].items()}
                else:
                    res["qkv_local"] = tuple(trainer.state.params[
                        "bert.layer_0.attn_qkv.kernel"].shape)
            else:
                res.update(bf16_step_ms=ms[-1], bf16_losses=losses,
                           bf16_peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2**30)
            res[f"{precision}_wall_s"] = time.perf_counter() - t0
            del trainer, batches
            gc.collect()
            torch.cuda.empty_cache()
        out[name] = res
    return out


def mesh_worker(rank: int, layouts, restore_dir: str | None, restore_argv,
                recorded=None, workloads: bool = False) -> dict:
    """One rank of a world on the card: each layout's f32 trajectory (its
    launches of kernels 1-5 counted from 0 around it) and bf16 step
    times, then, with ``restore_dir``, the checkpoint there restored on
    ``{model: 2}`` and gathered back: rank 0 reports whether every param
    equals the saved one bit for bit. ``recorded``: the one-rank MoE
    run's routing, which an expert-parallel layout's f32 run replays on
    this rank's tokens (:class:`rank_routing`). ``workloads``: then
    ResNet-50 and BERT-base on their layouts (:func:`workload_runs`)."""
    import torch

    from tensorflow_examples_torch.core import distributed
    from tensorflow_examples_torch.parallel import moe as moe_mod
    from tensorflow_examples_torch.sharding import ShardingConfig
    from tensorflow_examples_torch.telemetry.registry import default_registry
    from tensorflow_examples_torch.train.checkpoint import CheckpointManager
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import gpt2

    counters = mesh_counters()
    device = distributed.local_device("cuda")
    out = {"backend": torch.distributed.get_backend(), "device": str(device), "layouts": {}}
    for name, mesh_kw, kw in layouts:
        cfg_kw = {k: v for k, v in kw.items() if k not in MESH_WORKER_KEYS}
        cfg = mesh_config(**cfg_kw)
        overrides = {"moe_capacity_factor": kw["capacity"]} if "capacity" in kw else {}
        sc = ShardingConfig(mesh=mesh_kw, zero1=cfg.zero1)
        mesh = sc.build_mesh(device=device)
        batches = mesh_batches(cfg, MESH_STEPS)
        res = {}
        t_layout = time.perf_counter()
        for precision in ("f32", "bf16") if kw.get("bf16", True) else ("f32",):
            run_cfg = cfg.replace(precision=precision)
            trainer = Trainer(gpt2.make_task(run_cfg, mesh=mesh, **overrides), run_cfg,
                              mesh=mesh, sharding=sc)
            routing = contextlib.nullcontext()
            if precision == "f32" and cfg.moe_experts:
                # This rank routes tokens [i n, (i + 1) n) of the one-rank
                # run's flattened batch: its data rows, then its model block.
                n = cfg.global_batch_size * cfg.seq_len // mesh.axis_size(("data", "model"))
                i = mesh.axis_index(("data", "model"))
                routing = rank_routing(moe_mod, [
                    [torch.as_tensor(e[i * n:(i + 1) * n], device=device) for e in call]
                    for call in recorded])
            if precision == "f32":
                reset_counts(counters)
            drops = []
            with routing:
                losses, ms = mesh_steps(torch, trainer, batches if precision == "f32"
                                        else batches[:MESH_BF16_STEPS], drops)
            if precision == "f32":
                res["launches"] = {k: c.launches for k, c in counters.items()}
                res["losses"] = losses
                res["opt_bytes_per_device"] = trainer.byte_breakdown(per_device=True)["opt_state"]
                if cfg.moe_experts:
                    res["moe_drop"] = drops
                    res["routing_flips"] = (routing.flips, routing.worst_gap)
            else:
                res["bf16_step_ms"] = ms
                res["bf16_step_ms_p50"] = float(np.median(ms[1:]))
                if cfg.moe_experts:
                    res["bf16_moe_drop"] = drops
                if mesh.axis_size("pipe") > 1 and cfg.pipeline_schedule == "1f1b":
                    gauges = default_registry().gauge_values()  # the last bf16 step's schedule
                    res["bf16_1f1b"] = {k: gauges[f"pipeline/{k}"] for k in
                                        ("ticks", "idle_ticks", "wall_s", "exchange_s")}
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
        res["wall_s"] = time.perf_counter() - t_layout
        out["layouts"][name] = res
    if workloads:
        out["workloads"] = workload_runs(torch, device, on_mesh=True)
    if restore_dir:
        from tensorflow_examples_torch.train import cli

        _, _, _, cfg = cli.parse_config(restore_argv)
        sc = ShardingConfig(mesh={"model": 2})
        mesh = sc.build_mesh(device=device)
        trainer = Trainer(gpt2.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc)
        ckpt = CheckpointManager(restore_dir, layout=trainer.layout, primary=rank == 0)
        state, step = ckpt.restore_latest(trainer.state)
        whole = trainer.layout.gather_state({"params": state.params})["params"]
        if rank == 0:
            saved, _ = ckpt.load_latest()
            out["restore"] = {"step": step, "params": len(whole), "bitwise": all(
                torch.equal(whole[k].cpu(), saved["params"][k]) for k in saved["params"]),
                "qkv_local_heads": int(state.params["h_0.attn.qkv.kernel"].shape[2])}
    return out


def torchrun_pair(here: str, first: list, second: list) -> tuple[dict, dict]:
    """Two ``train.cli`` runs under ``torch.distributed.run`` (torchrun),
    2 ranks each, side by side on the card (neither is timed), checked
    in the calling thread (:func:`torchrun_result`)."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(torchrun_run, here, 2, argv) for argv in (first, second)]
        done = [r.result() for r in runs]
    return torchrun_result(first, *done[0]), torchrun_result(second, *done[1])


def torchrun_run(here: str, nproc: int, argv: list, timeout: int = 600):
    """(the finished process, its wall seconds)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(nproc), "--master_addr", "127.0.0.1",
           "--master_port", str(free_port()), "-m", "tensorflow_examples_torch.train.cli", *argv]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=here, capture_output=True, text=True, timeout=timeout)
    return p, time.perf_counter() - t0


def torchrun_result(argv: list, p, wall: float) -> dict:
    """A torchrun run's exit code checked, rank 0's result line, and the
    log lines naming the backend and a restore."""
    if p.returncode != 0:
        fail(f"torchrun {' '.join(argv)}: exit {p.returncode}\n{p.stderr[-4000:]}")
    results = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
    if len(results) != 1:
        fail(f"torchrun {' '.join(argv)}: {len(results)} result lines (only rank 0 prints one)")
    notes = [x.split(": ", 1)[-1] for x in p.stderr.splitlines()
             if "torch.distributed initialized" in x or "restored checkpoint" in x]
    return {"result": results[0], "wall_s": wall, "notes": notes}


def workload_checks(one: dict, ranks: list, imagenet_a: dict, smi: str) -> dict:
    """ResNet-50 on ``{data: 2}`` and BERT-base on ``{model: 2}`` held to
    their one-rank runs: the ranks' losses (and ResNet-50's statistics,
    bitwise) equal, the f32 losses within ``MESH_RTOL`` and each running
    statistic within ``MESH_RTOL`` and ``MESH_ATOL`` elementwise,
    BERT's 12 launches of each flash kernel a step on every rank at 6
    heads a rank; the bf16 step a rank beside one rank's. Each row is
    printed before any of its checks fails."""
    out, problems = {}, []
    for name, layout in (("resnet50", RESNET_MESH_LAYOUT), ("bert", BERT_MESH_LAYOUT)):
        per_rank, ref = [r[name] for r in ranks], one[name]
        losses = per_rank[0]["losses"]
        if any(r["losses"] != losses for r in per_rank):
            fail(f"mesh {name}: ranks disagree on the loss: {[r['losses'] for r in per_rank]}")
        rel = float(np.max(np.abs(np.array(losses) - ref["losses"]) / np.abs(ref["losses"])))
        if not rel <= MESH_RTOL:
            problems.append(f"mesh {name} {layout}: f32 losses {losses} vs one rank "
                            f"{ref['losses']}: rel {rel:.3e} > {MESH_RTOL}")
        bf16 = [r["bf16_losses"] for r in per_rank]
        if not np.all(np.isfinite(bf16)) or any(b != bf16[0] for b in bf16):
            problems.append(f"mesh {name}: bf16 losses {bf16}")
        row = out[name] = {
            "mesh": layout, "f32_losses": losses, "one_rank_f32_losses": ref["losses"],
            "rel_vs_one_rank": rel, "bf16_losses": bf16[0],
            "bf16_step_ms_per_rank": [r["bf16_step_ms"] for r in per_rank],
            "bf16_peak_mem_gib_per_rank": [r["bf16_peak_mem_gib"] for r in per_rank],
            "wall_s_per_rank": [r["f32_wall_s"] + r["bf16_wall_s"] for r in per_rank]}
        if name == "resnet50":
            stats, want = per_rank[0]["batch_stats"], ref["batch_stats"]
            if any(not np.array_equal(v, stats[k]) for r in per_rank[1:]
                   for k, v in r["batch_stats"].items()):
                problems.append("mesh resnet50: the ranks' batch_stats differ")
            # Each element's error over its bound, MESH_ATOL + MESH_RTOL x one rank's.
            ratio = {k: float(np.max(np.abs(v - want[k]) /
                                     (MESH_ATOL + MESH_RTOL * np.abs(want[k]))))
                     for k, v in stats.items() if k in want}
            worst = max(ratio, key=ratio.get)
            row.update(batch_stats_max_abs_err=max(float(np.max(np.abs(v - want[k])))
                                                   for k, v in stats.items() if k in want),
                       batch_stats_worst_err_over_bound=ratio[worst], batch_stats_worst=worst)
            if ratio[worst] > 1.0 or stats.keys() != want.keys():
                problems.append(f"mesh resnet50: {worst} off one rank's by {ratio[worst]:.3e} "
                                f"of its bound (rtol {MESH_RTOL}, atol {MESH_ATOL})")
            row.update(global_batch_f32=RESNET_MESH_BATCH, global_batch_bf16=RESNET_MESH_BF16_BATCH,
                       one_rank_bf16_step_ms_at_256=imagenet_a["repeated_batch_step_ms_p50"],
                       one_rank_bf16_peak_mem_gib_at_256=imagenet_a["peak_mem_gib"],
                       batch_stats_bitwise_across_ranks=True)
        else:
            want = {k: 12 * WORKLOAD_STEPS for k in FLASH_KERNELS}
            launches = [r["launches"] for r in per_rank]
            if launches != [want] * len(per_rank) or ref["launches"] != want:
                problems.append(f"mesh bert: flash launches per rank {launches} (one rank "
                                f"{ref['launches']}), want 12 a step: {want}")
            heads = [r["qkv_local"] for r in per_rank]
            if heads != [(768, 3, 6, 64)] * len(per_rank):
                problems.append(f"mesh bert: attn_qkv.kernel a rank {heads}, want [768, 3, 6, 64]")
            row.update(launches_per_rank=launches, qkv_local=heads[0],
                       one_rank_bf16_step_ms=ref["bf16_step_ms"],
                       one_rank_bf16_peak_mem_gib=ref["bf16_peak_mem_gib"])
        log(f"mesh {name} {layout}: {json.dumps(row)}; {smi}")
    if problems:
        fail("; ".join(problems))
    return out


def phase_mesh(torch, here: str, smi: str, tmp: str, imagenet_a: dict) -> dict:
    """GPT-2 training on meshes of ranks sharing the one card (gloo,
    collectives staged through host memory): each layout's f32 4-step
    trajectory against its reference (the one-rank run of the same
    config; interleaved 1F1B against plain 1F1B; expert parallelism
    against the one-rank MoE run with the routing replayed), ZeRO-1
    against data parallelism, bf16 step p50 per rank, the launches of
    kernels 1-5 on every rank (a pipeline layout's held to its
    schedule's count); then ``train.cli`` under torchrun on ``{data: 2}``
    and a resume on ``{model: 2}``, the checkpoint restored on ``{model:
    2}`` bit for bit, and on ``{data: 1, pipe: 2}`` resumed on ``{pipe:
    2}``; in the world of 2, ResNet-50 on ``{data: 2}`` and BERT-base
    flash on ``{model: 2}`` against their one-rank runs
    (:func:`workload_checks`)."""
    from tensorflow_examples_torch.core import distributed
    from tensorflow_examples_torch.parallel import moe as moe_mod
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import gpt2

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"config": f"GPT-2 124M widths (d 768, 12 heads, seq 1024, vocab 50257, batch 16) "
                     f"at {MESH_LAYERS} layers ({MESH_PIPE_LAYERS} for interleaving); f32 "
                     "dropout 0 for the trajectories, bf16 timed", "card": smi}
    # The one-rank runs the layouts are held to (tp_vocab and Ulysses are
    # the plain head and flash attention on one rank; a pipeline the
    # model unsplit): dense at MESH_LAYERS and at MESH_PIPE_LAYERS, and
    # the MoE config with its routing recorded, without jitter.
    cfg = mesh_config()
    trainer = Trainer(gpt2.make_task(cfg), cfg)
    ref = out["one_rank_losses"] = mesh_steps(torch, trainer, mesh_batches(cfg, MESH_STEPS))[0]
    trainer = Trainer(gpt2.make_task(cfg.replace(precision="bf16")), cfg.replace(precision="bf16"))
    ms = mesh_steps(torch, trainer, mesh_batches(cfg, MESH_BF16_STEPS))[1]
    out["one_rank_bf16_step_ms_p50"] = float(np.median(ms[1:]))
    refs = {"one rank": ref}
    cfg4 = mesh_config(num_layers=MESH_PIPE_LAYERS)
    trainer = Trainer(gpt2.make_task(cfg4), cfg4)
    refs["one rank 4 layers"] = mesh_steps(torch, trainer, mesh_batches(cfg4, MESH_STEPS))[0]
    ep_kw = {name: kw for name, _, kw in MESH_LAYOUTS_4}["data+model moe ep"]
    cfg_moe = mesh_config(moe_experts=ep_kw["moe_experts"], moe_top_k=ep_kw["moe_top_k"])
    trainer = Trainer(gpt2.make_task(cfg_moe, moe_capacity_factor=ep_kw["capacity"]), cfg_moe)
    with rank_routing(moe_mod) as routing:
        refs["one rank moe"] = mesh_steps(torch, trainer, mesh_batches(cfg_moe, MESH_STEPS))[0]
    recorded = [[e.cpu().numpy() for e in call] for call in routing.calls]
    out["one_rank_refs"] = refs
    log(f"mesh: one rank, f32 losses {json.dumps(refs)}; bf16 step p50 "
        f"{out['one_rank_bf16_step_ms_p50']:.2f} ms; {smi}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    one = workload_runs(torch, distributed.local_device("cuda"), on_mesh=False, resnet_bf16=False)
    log(f"mesh: one rank, ResNet-50 f32 losses {one['resnet50']['losses']} (batch "
        f"{RESNET_MESH_BATCH}), BERT-base f32 losses {one['bert']['losses']}, bf16 step "
        f"{one['bert']['bf16_step_ms']:.2f} ms; {smi}")

    # train.cli under torchrun on {data: 2} (the checkpoint the world below
    # restores) and, beside it, on {data: 1, pipe: 2} to step 4.
    workdir = os.path.join(tmp, "mesh-cli")
    pipe_dir = os.path.join(tmp, "mesh-pipe-cli")
    run_argv = [*MESH_CLI, "--train_steps", "4", "--workdir", workdir]
    out["torchrun_data"], out["torchrun_pipe"] = torchrun_pair(
        here, [*run_argv, "--mesh_data", "2"],
        [*MESH_CLI, "--train_steps", "4", "--workdir", pipe_dir, "--mesh_data", "1",
         "--mesh_pipe", "2"])
    log(f"mesh: torchrun data 2: {json.dumps(out['torchrun_data'])}")

    worlds = ((2, MESH_LAYOUTS_2, workdir), (4, MESH_LAYOUTS_4, None))
    ranks_out = {}
    for n, layouts, restore in worlds:
        t0 = time.perf_counter()
        ranks_out[n] = distributed.run_world(mesh_worker, n, layouts, restore,
                                             [*run_argv, "--mesh_model", "2"], recorded, n == 2,
                                             device="cuda", timeout_s=900)
        log(f"mesh: world of {n} ranks on one card, backend {ranks_out[n][0]['backend']} "
            f"(host-staged collectives), {time.perf_counter() - t0:.1f} s")
    restore = ranks_out[2][0]["restore"]
    if not restore["bitwise"] or restore["step"] != 4 or restore["qkv_local_heads"] != 6:
        fail(f"mesh: the {{data: 2}} checkpoint restored on {{model: 2}}: {restore}")
    out["restore_model2"] = restore
    # The resumes, side by side: {data: 2}'s on {model: 2}, the pipeline's
    # on {pipe: 2} with an explicit interleave of 1 (the same storage key).
    out["torchrun_resume_model"], out["torchrun_resume_pipe"] = torchrun_pair(
        here, [*MESH_CLI, "--train_steps", "6", "--workdir", workdir, "--mesh_model", "2"],
        [*MESH_CLI, "--train_steps", "6", "--workdir", pipe_dir, "--mesh_pipe", "2",
         "--pipe_interleave", "1"])
    resumed = out["torchrun_resume_model"]
    if resumed["result"]["steps"] != 6 or not any("restored checkpoint at step 4" in x
                                                  for x in resumed["notes"]):
        fail(f"mesh: torchrun resume on model 2: {resumed}")
    log(f"mesh: torchrun resume on model 2: {json.dumps(resumed)}")
    piped, resumed = out["torchrun_pipe"], out["torchrun_resume_pipe"]
    if piped["result"]["steps"] != 4 or piped["result"]["mesh"]["pipe"] != 2 or \
            resumed["result"]["steps"] != 6 or not any(
                "restored checkpoint at step 4" in x for x in resumed["notes"]) or \
            not np.isfinite(resumed["result"]["loss"]):
        fail(f"mesh: torchrun on pipe 2 and its resume: {piped} {resumed}")
    log(f"mesh: torchrun data 1 pipe 2: {json.dumps(piped)}; resumed on pipe 2, interleave 1: "
        f"{json.dumps(resumed)}")

    launches = {k: [0] * 4 for k in mesh_counters()}
    pipe_launches = {k: [0] * 4 for k in mesh_counters()}
    out["layouts"] = {}
    for n, layouts, _ in worlds:
        for name, mesh_kw, kw in layouts:
            per_rank = [r["layouts"][name] for r in ranks_out[n]]
            losses = per_rank[0]["losses"]
            if any(r["losses"] != losses for r in per_rank):
                fail(f"mesh {name}: ranks disagree on the loss: {[r['losses'] for r in per_rank]}")
            ref_name = kw.get("ref", "one rank")
            if ref_name in refs:
                want, rtol = refs[ref_name], MESH_RTOL
            else:
                want, rtol = out["layouts"][ref_name]["f32_losses"], MESH_INTERLEAVE_RTOL
            rel = float(np.max(np.abs(np.array(losses) - want) / np.abs(want)))
            if not rel <= rtol:
                fail(f"mesh {name}: f32 losses {losses} vs {ref_name} {want}: rel {rel:.3e} > "
                     f"{rtol}")
            for k in launches:
                for i, r in enumerate(per_rank):
                    launches[k][i] += r["launches"][k]
                    if name in MESH_PIPE_LAYOUTS:
                        pipe_launches[k][i] += r["launches"][k]
            if name in MESH_PIPE_LAYOUTS:
                want_l = [pipe_launches_want(name, kw, mesh_kw, i) for i in range(n)]
                if [r["launches"] for r in per_rank] != want_l:
                    fail(f"mesh {name}: launches per rank {[r['launches'] for r in per_rank]}, "
                         f"the schedule's {want_l}")
            row = out["layouts"][name] = {
                "mesh": mesh_kw, **kw, "f32_losses": losses, "ref": ref_name,
                "rel_vs_ref": rel, "launches_per_rank": [r["launches"] for r in per_rank],
                "opt_bytes_per_device": per_rank[0]["opt_bytes_per_device"],
                "wall_s_per_rank": [r["wall_s"] for r in per_rank]}
            if "bf16_step_ms_p50" in per_rank[0]:
                row["bf16_step_ms_p50_per_rank"] = [r["bf16_step_ms_p50"] for r in per_rank]
            if "bf16_1f1b" in per_rank[0]:
                # The bubble: the table's idle ticks a rank, and the share
                # of the schedule's host wall spent in its hops.
                row["bf16_1f1b_per_rank"] = [r["bf16_1f1b"] for r in per_rank]
            if "moe_drop" in per_rank[0]:
                flips = [r["routing_flips"] for r in per_rank]
                row.update(moe_drop=[r["moe_drop"] for r in per_rank],
                           bf16_moe_drop=[r["bf16_moe_drop"] for r in per_rank],
                           routing_flips=flips)
                if any(d != 0.0 for r in per_rank for d in r["moe_drop"] + r["bf16_moe_drop"]):
                    fail(f"mesh {name}: tokens dropped at capacity factor {kw['capacity']}: "
                         f"{row['moe_drop']} {row['bf16_moe_drop']}")
                if not all(gap < NEAR_TIE for _, gap in flips):
                    fail(f"mesh {name}: a replayed routing decision was no near-tie: {flips}")
            log(f"mesh {name} {mesh_kw}: f32 losses {losses} rel {rel:.3e} vs {ref_name}; bf16 "
                f"step p50 ms per rank {row.get('bf16_step_ms_p50_per_rank')}; wall s per rank "
                f"{row['wall_s_per_rank']}; launches per "
                f"rank {row['launches_per_rank']}"
                + (f"; 1F1B ticks, idle ticks, wall and hop seconds of the last bf16 step per "
                   f"rank {row['bf16_1f1b_per_rank']}" if "bf16_1f1b_per_rank" in row else "")
                + (f"; moe_drop {row['moe_drop']}, replayed routing flips and largest gap per "
                   f"rank {row['routing_flips']}" if "moe_drop" in row else "") + f"; {smi}")
    z1, dp = out["layouts"]["data+zero1"], out["layouts"]["data"]
    z_rel = float(np.max(np.abs(np.array(z1["f32_losses"]) - dp["f32_losses"])
                         / np.abs(dp["f32_losses"])))
    if not z_rel <= MESH_ZERO1_RTOL or not z1["opt_bytes_per_device"] < dp["opt_bytes_per_device"]:
        fail(f"mesh: zero1 vs data: rel {z_rel:.3e} (> {MESH_ZERO1_RTOL}?), optimizer bytes "
             f"per device {z1['opt_bytes_per_device']} vs {dp['opt_bytes_per_device']}")
    out["zero1_rel_vs_data"] = z_rel
    out["launches_per_rank"] = launches  # kernels 1-5, every layout, ranks 0-3
    out["pipe_launches_per_rank"] = pipe_launches  # the pipeline layouts alone
    idle = [k for k, per in launches.items() if any(v == 0 for v in per[:2])]
    if idle:
        fail(f"mesh: kernels {idle} not launched on every rank: {launches}")
    out["workloads"] = workload_checks(one, [r["workloads"] for r in ranks_out[2]], imagenet_a,
                                       smi)
    out["bert_launches_per_rank"] = {
        k: [r["workloads"]["bert"]["launches"][k] for r in ranks_out[2]] for k in FLASH_KERNELS}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh: launches of kernels 1-5 per rank over every layout {json.dumps(launches)}, "
        f"over the pipeline layouts {json.dumps(pipe_launches)}; zero1 vs data rel "
        f"{z_rel:.3e}; phase {out['phase_s']:.1f} s; {smi}")
    return out


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

    timed("build", phase_build, _build)
    rows = timed("kernels", phase_kernels, torch, decode, paged_decode, precision)
    rows.update(timed("flash_kernels", phase_flash_kernels, torch, attention))
    bert_rows = timed("bert_flash_kernels", phase_bert_flash_kernels, torch, attention)
    rows.update(timed("ce_kernels", phase_ce_kernels, torch, cross_entropy))
    rows.update(timed("moe_kernels", phase_moe_kernels, torch, grouped_matmul))
    for name, errs in timed("head_dim_sweep", phase_head_dim_sweep, torch, attention, decode,
                            paged_decode, precision).items():
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
        training = timed("training", phase_training, torch, counters, smi, workdir)
        timed("resume", phase_resume, torch, smi, workdir, training)
        timed("generate", phase_generate, torch, counters, workdir)
        moe = timed("moe_training", phase_moe_training, torch, counters, grouped_matmul, smi,
                    os.path.join(tmp, "moe"))
        timed("moe_generate", phase_moe_generate, torch, counters, grouped_matmul,
              os.path.join(tmp, "moe-init"))
        timed("train_config", phase_train_config, torch, counters, smi, tmp)
        bert = timed("bert_glue", phase_bert_glue, torch, counters, smi, tmp)
        timed("cifar10", phase_cifar10, torch, counters, smi, tmp)
        timed("mnist", phase_mnist, torch, counters, smi, tmp)
        imagenet = timed("imagenet", phase_imagenet, torch, counters, smi, tmp, here)

    model_cfg = transformer.gpt2_124m()
    t0 = time.perf_counter()
    model = transformer.GPT2(model_cfg, seed=0).to("cuda")
    log(f"model: GPT-2 124M, {sum(p.numel() for p in model.parameters())} params, "
        f"random init seed 0, f32, built in {time.perf_counter() - t0:.3f} s")
    summaries = timed("serving", phase_serving, torch, model, model_cfg, counters, smi)
    replica = timed("replica", phase_replica, torch, model, model_cfg, counters, smi, here)
    fleet = timed("fleet", phase_fleet, torch, model, model_cfg, counters, smi, here)
    sharded = timed("sharded_serving", phase_sharded_serving, torch, model, model_cfg, decode,
                    paged_decode, precision, smi, here)
    del model
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        mesh = timed("mesh", phase_mesh, torch, here, smi, tmp, imagenet["a"])

    for name in TRAIN_KERNELS:
        # The mesh path: every layout's launches, rank by rank.
        rows[name]["mesh_launches_per_rank"] = mesh["launches_per_rank"][name]
        rows[name]["pipe_launches_per_rank"] = mesh["pipe_launches_per_rank"][name]
    for name in FLASH_KERNELS:
        rows[name]["tensor_core_launches"] = training["launches"][f"{name}_tensor_core"]
        # BERT-base on {model: 2}: each rank's launches over its f32 steps.
        rows[name]["bert_mesh_launches_per_rank"] = mesh["bert_launches_per_rank"][name]
        # BERT's path: its own count (20 steps, and 8 eval batches for the forward).
        rows[name]["bert_glue"] = {**bert_rows[name], "launches": bert["launches"][name],
                                   "launches_per_step": bert["launches_per_step"][name]}
    for name in ("flash_decode", "paged_decode"):
        for v in ("tensor_core", "simt", "split"):
            if f"{name}_{v}" in summaries[0]["launches"]:
                rows[name][f"{v}_launches"] = sum(s["launches"][f"{name}_{v}"] for s in summaries)
    for name in ("flash_decode", "paged_decode"):
        # The sharded path: each rank's launches over the served requests,
        # and the kernel at a rank's shape (6 heads).
        rows[name]["sharded_launches_per_rank"] = sharded["launches_per_rank"][name]
        rows[name]["sharded_rank_shape"] = sharded["kernel_rows"][name]
    rows["flash_decode"].update(
        design="split-KV over CTAs with an in-order merge of (acc, m, l)",
        variant="f32 (and bf16 at D=8): register-tiled SIMT flash_decode_simt_kernel; bf16 "
                "D>=16: mma.sync flash_decode_mma_kernel; merge_splits_kernel when split")
    rows["paged_decode"].update(
        design="grid (head, slot, split), warp-level online softmax over "
               "16-byte lane vectors, in-order merge of the splits",
        variant="paged_decode_kernel, merge_splits_kernel when split")
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
         sum(s["launches"]["flash_decode"] for s in summaries)
         + replica["launches"]["flash_decode"] + fleet["launches"]["flash_decode"]
         + sum(sharded["launches_per_rank"]["flash_decode"])),
        ("paged_decode", PAGED_SOURCE, "tensorflow_examples_tpu/ops/paged_decode.py:61",
         sum(s["launches"]["paged_decode"] for s in summaries)
         + replica["launches"]["paged_decode"] + fleet["launches"]["paged_decode"]
         + sum(sharded["launches_per_rank"]["paged_decode"])),
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
            **{k: row[k] for k in ("float32", "sdpa_fwd_bwd_ms", "sdpa_bwd_ms", "variant",
                                   "library_fwd_bwd_ms", "library",
                                   "all_shapes", "worst_abs_err_all_cases", "design",
                                   "head_dim_sweep_max_abs_err", "tensor_core_launches",
                                   "simt_launches", "split_launches", "bert_glue",
                                   "mesh_launches_per_rank", "pipe_launches_per_rank",
                                   "bert_mesh_launches_per_rank",
                                   "sharded_launches_per_rank", "sharded_rank_shape")
               if k in row},
        })
    log(json.dumps({"phase_seconds": PHASE_SECONDS, "total_s": time.perf_counter() - T_START}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
