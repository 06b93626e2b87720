"""The serving step: bucketed prefill, fixed-shape continuous decode,
speculative verify and chunked prefill, warmed ahead of traffic.

The port of ``tensorflow_examples_tpu/serving/engine.py``. The design is
the reference's:

* **Prefill** pads each prompt to the smallest power-of-two length bucket
  (``prefill_bucket_floor`` up to ``max_len``) and runs batch 1; causal
  masking makes the pad rows inert. Under ``attention="flash"`` its
  attention is ``ops/decode.flash_decode_attention`` with
  ``length = q_len = bucket``: a prefill is the single-length case of
  cache attention. On the paged pool a prefix-cache hit prefills only
  the prompt's tail over the cached context (the extend step, one rung a
  tail bucket), and with ``prefill_chunk_tokens`` a long cold prompt runs
  as block-aligned chunks through the same extend rungs, one chunk a
  batcher iteration (:meth:`InferenceEngine.prefill_open` /
  :meth:`~InferenceEngine.prefill_step`).
* **Decode** runs every one of the ``max_slots`` slots each step (slots
  not decoding ride along at position 0 and write into rows nothing
  reads), over the KV cache cut to the smallest power-of-two bucket
  covering the longest active request. On the paged pool under
  ``attention="paged_flash"`` each layer's attention is the fused
  ``ops/paged_decode`` kernel reading K/V straight through the block
  tables (int8 pools dequantized in the kernel); otherwise the plain
  gather path.
* **Verify** (``spec_decode_k`` > 0) scores each request's launch token
  and its k draft tokens in one forward and commits the longest agreeing
  prefix (``serving/speculative.accept_drafts``). Every row samples with
  the key of its own absolute position, so streams are the same with
  speculation on or off. Its attention is plain PyTorch
  (``kv_cache.varlen_verify_attention``), as the reference's is XLA.
* **Weights** may be quantized at load (``weight_dtype`` int8/fp8,
  ``core/precision``): every matmul weight is read through
  ``materialize`` and every embedding table through ``take_rows``.
* **The KV-page hand-off** (paged pool): a prefill-role replica exports
  a finished prompt's blocks (:meth:`InferenceEngine.export_kv_pages`,
  ``serving/scheduler.py``'s wire format, the reference's layout), and a
  decode-role replica maps them into a slot
  (:meth:`~InferenceEngine.import_kv_pages`) and decodes on, token for
  token a mixed replica's. Pages cross between the two packages.

**The warmed contract.** Every step the engine runs comes from a finite
ladder of rungs (``serve_prefill_L*``, ``serve_decode_K*``,
``serve_extend_T*``, ``serve_verify_K*``), each wrapped in the port's
``CompilationSentinel``; :meth:`~InferenceEngine.warmup` runs every rung
once ahead of traffic and :meth:`~InferenceEngine.post_warmup_recompiles`
counts the rungs that met a new input signature afterwards: 0 in steady
state. On the card each decode and verify rung runs as **one CUDA graph**
(:class:`GraphRung`), captured the first time the rung runs from static
input buffers (tokens, positions, block tables) and replayed with each
later step's inputs copied in: the host launches one graph where it
launched hundreds of kernels. Prefill and extend rungs stay eager
(flash-decode plans from a host length). A failed step or capture raises
:class:`EngineStepError` after reallocating the KV pool; it never falls
back to an eager step. The reference donates the caches to each compiled
step; here K/V writes happen in place on the pool's tensors, which the
captured graphs address, so reallocating drops every graph and each
rung's recapture counts as a recompile.

Sampling: greedy is ``argmax``, token-identical to the reference.
Temperature/top-k sampling is the reference's: ``jax.random.categorical``
over the filtered logits under the key ``fold_in(PRNGKey(seed),
absolute position)``, through the port's bit-compatible threefry
(``core/rng.py``), so a request's tokens do not depend on the batch it
rode in and equal the JAX engine's (up to one-ulp ``log`` differences in
the Gumbel noise, which matter only at a near-tie).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from collections.abc import Mapping
from typing import Sequence

import numpy as np
import torch

from tensorflow_examples_torch.core import collectives as coll
from tensorflow_examples_torch.core import distributed
from tensorflow_examples_torch.core import graphs as graphs_mod
from tensorflow_examples_torch.core import precision as precision_mod
from tensorflow_examples_torch.core import rng
from tensorflow_examples_torch.core.device import resolve_device
from tensorflow_examples_torch.core.mesh import AxisNames
from tensorflow_examples_torch.core.precision import dequantize_rows, quantize_rows
from tensorflow_examples_torch.core.sharding import shard_params, shardings_for_params
from tensorflow_examples_torch.models.convert import flatten_tree, model_from_params
from tensorflow_examples_torch.models.transformer import (
    GPT2,
    GPT2_RULES,
    ParamView,
    TransformerConfig,
    _attn_out,
    _block_mlp,
    _embed_on,
    _layer_norm,
    _lm_head,
    _qkv,
)
from tensorflow_examples_torch.ops.attention import (
    NEG_INF,
    SUPPORTED_HEAD_DIMS,
    attention_reference,
)
from tensorflow_examples_torch.ops.decode import flash_decode_attention
from tensorflow_examples_torch.ops.paged_decode import paged_decode_attention
from tensorflow_examples_torch.parallel.attention import mesh_decode_attention
from tensorflow_examples_torch.serving import kv_cache as kv_mod
from tensorflow_examples_torch.serving import paged_kv, scheduler
from tensorflow_examples_torch.serving.speculative import accept_drafts
from tensorflow_examples_torch.sharding.resolve import resolve_params
from tensorflow_examples_torch.telemetry import registry as registry_mod
from tensorflow_examples_torch.telemetry.compilation import CompilationSentinel
from tensorflow_examples_torch.telemetry.spans import span as host_span
from tensorflow_examples_torch.utils import faults as faults_mod

log = logging.getLogger(__name__)

ATTENTION_IMPLS = ("xla", "flash", "paged_flash")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine and batcher knobs: the reference's fields for one replica,
    with its defaults."""

    max_slots: int = 8           # concurrent requests = decode batch
    prefill_bucket_floor: int = 16
    kv_bucket_floor: int = 64
    attention: str = "xla"       # xla (plain torch) | flash (flash-decode
    #                              kernel for prefill) | paged_flash (the
    #                              flash-decode kernel for prefill and the
    #                              fused paged-decode kernel for decode;
    #                              needs the paged pool)
    cache_dtype: str = ""        # "" -> the params' dtype; else a torch
    #                              dtype name ("float32", "bfloat16")
    weight_dtype: str = ""       # "" | "int8" | "fp8": weight-only
    #                              quantization at load
    #                              (PrecisionConfig.weight_only)
    compile_warmup: int = 1      # expected compiles per sentinel-wrapped rung
    spec_decode_k: int = 0       # drafts verified per decode step; 0 off
    draft: str = "ngram"         # draft source (serving/speculative.py)
    draft_ngram: int = 3         # longest n-gram the drafter matches
    kv_block_size: int = 0       # 0 -> dense pool; else paged, a power of
    #                              two dividing both floors and max_len
    kv_blocks: int = 0           # physical blocks; 0 -> dense worst case
    kv_dtype: str = ""           # "" (cache_dtype) | "int8" | "fp8"
    prefix_cache: bool = True    # reuse immutable full prompt blocks
    role: str = "mixed"          # mixed | prefill | decode: the fleet role
    #                              published on /health. Advisory: every
    #                              role still serves a full /generate;
    #                              a prefill replica's fault schedule
    #                              counts prefills, not decode steps
    prefill_chunk_tokens: int = 0  # > 0: a cold prompt tail longer than
    #                              this prefills in block-aligned chunks,
    #                              one a batcher iteration (paged pool with
    #                              prefix_cache; a multiple of kv_block_size)
    max_batch: int = 0           # admission cap; 0 -> max_slots
    max_queue: int = 64          # bounded queue per SLO class: beyond
    #                              this, load-shed
    max_delay_s: float = 0.002   # idle coalescing window before first prefill
    watchdog_secs: float = 0.0   # 0 disables the serve-loop watchdog
    brownout: bool = False       # the degradation ladder (serving/
    #                              overload.py): shed batch -> cap
    #                              max_new_tokens -> no speculation ->
    #                              shed interactive, with hysteresis
    brownout_queue_hi: int = 0   # queue-depth high watermark; 0 -> 2 * max_slots
    brownout_kv_hi: float = 0.92  # KV-occupancy high watermark
    brownout_ttft_hi_s: float = 0.0  # recent TTFT p95 high watermark; 0 off
    brownout_clear_frac: float = 0.5  # clear watermark = frac * hi
    brownout_hold_s: float = 0.5  # min dwell a rung up, sustained clear a rung down
    brownout_max_new_tokens: int = 8  # the level-2 generation cap
    request_timeout_s: float = 120.0


# --------------------------------------------------------------- forward
#
# The layer math is the model's (``models/transformer.py``), which reads
# every matmul weight through ``core/precision.materialize`` and every
# embedding table through ``take_rows``; f32 like the reference. ``model``
# is a GPT2 module or the engine's parameter view (quantized, or this
# rank's shards), each with a ``cfg``. A sharded view also carries its
# ``mesh`` and the ``model`` psums of its row-parallel products
# (``reduce_attn``, ``reduce_mlp``): each forward sums them before the
# bias, so every rank of the group holds the same activations and logits.


def _reduce(model, part: str):
    return getattr(model, f"reduce_{part}", None)


def _embed_in(model, tokens, positions):
    return _embed_on(model, model.cfg, tokens, positions, getattr(model, "mesh", None))


def _logits(model, x):
    return _lm_head(x, model, model.cfg, getattr(model, "mesh", None))


def _prefill_attend(q, k, v, *, impl: str, mesh=None):
    """Causal self-attention for prefill, [B, L, H, hd] layout (this
    rank's heads on a mesh)."""
    swap = lambda t: t.transpose(1, 2).contiguous()  # [B,L,H,D] -> [B,H,L,D]
    if impl == "flash":
        out = mesh_decode_attention(swap(q), swap(k), swap(v), q.shape[1], mesh=mesh)
    else:
        out = attention_reference(swap(q), swap(k), swap(v), causal=True)
    return out.transpose(1, 2)


def forward_full(model, tokens: torch.Tensor, *, impl: str = "xla"):
    """Full causal forward of ``tokens`` [B, L]: logits [B, L, V] plus the
    per-layer K/V ([num_layers, B, L, H, hd] each) a prefill writes into
    the cache. Also the cacheless reference path."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed_in(model, tokens, positions[None])
    mesh = getattr(model, "mesh", None)
    ks, vs = [], []
    for layer in range(model.cfg.num_layers):
        blk = model.block(layer)
        q, k, v = _qkv(_layer_norm(x, blk.ln_1), blk.attn)
        ks.append(k)
        vs.append(v)
        x = x + _attn_out(_prefill_attend(q, k, v, impl=impl, mesh=mesh), blk.attn,
                          _reduce(model, "attn"))
        x = x + _block_mlp(_layer_norm(x, blk.ln_2), blk, _reduce(model, "mlp"))
    return _logits(model, _layer_norm(x, model.ln_f)), torch.stack(ks), torch.stack(vs)


def _decode_forward(model, k_cache, v_cache, tokens, positions, *, kv_bucket: int):
    """One continuous-decode step over every slot of the dense pool.

    tokens/positions: [S]; each slot's input token and the cache row it
    occupies (= its populated length before the step). Writes K/V in
    place and returns next-token logits [S, V]."""
    x = _embed_in(model, tokens, positions)
    idx = torch.arange(tokens.shape[0], device=tokens.device)
    lengths = positions + 1
    for layer in range(model.cfg.num_layers):
        blk = model.block(layer)
        q, k, v = _qkv(_layer_norm(x, blk.ln_1), blk.attn)  # [S, H, hd]
        k_cache[layer, idx, :, positions, :] = k.to(k_cache.dtype)
        v_cache[layer, idx, :, positions, :] = v.to(v_cache.dtype)
        att = kv_mod.varlen_decode_attention(
            q, k_cache[layer, :, :, :kv_bucket], v_cache[layer, :, :, :kv_bucket],
            lengths,
        )
        x = x + _attn_out(att, blk.attn, _reduce(model, "attn"))
        x = x + _block_mlp(_layer_norm(x, blk.ln_2), blk, _reduce(model, "mlp"))
    return _logits(model, _layer_norm(x, model.ln_f))


def _verify_forward(model, k_cache, v_cache, tokens, positions, *, kv_bucket: int):
    """The speculative verify step on the dense pool: T = k+1 tokens a
    slot in one forward. ``tokens`` [S, T] holds each slot's launch token
    and its drafts; row t lands in cache row ``positions[s] + t`` and
    attends its own populated prefix. Returns logits [S, T, V]; T=1 is
    numerically the decode step.

    A row past ``max_len`` (a short-budget slot padded to the fixed T)
    has no cache row: the reference's scatter drops it. Here it writes
    row ``max_len - 1``'s own K/V to row ``max_len - 1``, so the duplicate
    writes agree; its logits are discarded (acceptance never commits a
    row that did not land)."""
    cfg = model.cfg
    s_n, t_n = tokens.shape
    dev = tokens.device
    pos_grid = positions[:, None] + torch.arange(t_n, device=dev)
    rows = pos_grid.clamp(max=cfg.max_len - 1)
    src = (rows - positions[:, None])[..., None, None]  # the row each write carries
    x = _embed_in(model, tokens, rows)
    idx = torch.arange(s_n, device=dev)[:, None]
    for layer in range(cfg.num_layers):
        blk = model.block(layer)
        q, k, v = _qkv(_layer_norm(x, blk.ln_1), blk.attn)  # [S, T, H, hd]
        k_cache[layer, idx, :, rows, :] = torch.gather(k, 1, src.expand_as(k)).to(k_cache.dtype)
        v_cache[layer, idx, :, rows, :] = torch.gather(v, 1, src.expand_as(v)).to(v_cache.dtype)
        att = kv_mod.varlen_verify_attention(
            q, k_cache[layer, :, :, :kv_bucket], v_cache[layer, :, :, :kv_bucket], positions,
        )
        x = x + _attn_out(att, blk.attn, _reduce(model, "attn"))
        x = x + _block_mlp(_layer_norm(x, blk.ln_2), blk, _reduce(model, "mlp"))
    return _logits(model, _layer_norm(x, model.ln_f))


# ---------------------------------------------------------- paged forward
#
# K/V live in [L, NB, H, BS, D] block pools addressed through per-slot
# block tables. ``kv`` is the pool's tensor tuple: (k, v) or, quantized,
# (k, v, k_scale, v_scale) with per-row scales stored blockwise. The
# store dtype (int8 or fp8) rides on the pool's arrays; fp8 payloads are
# written and gathered as their bytes.


def _raw(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == precision_mod.fp8_dtype() else t


def _take(store: torch.Tensor, idx) -> torch.Tensor:
    """``store[idx]`` through the payload's bytes (fp8-safe)."""
    return _raw(store)[idx].view(store.dtype)


def _put(store: torch.Tensor, index: tuple, value: torch.Tensor) -> None:
    """``store[index] = value`` through the payload's bytes (fp8-safe)."""
    _raw(store)[index] = _raw(value.to(store.dtype))


def _paged_write_prompt(kv, ks, vs, block_ids, *, block_size):
    """Scatter a prefill's K/V ([L, bucket, H, hd]) into the blocks named
    by ``block_ids`` [bucket // BS] (pad entries name the null block)."""
    num_layers, bucket, h, hd = ks.shape
    nb = bucket // block_size

    def to_blocks(x):  # [L, bucket, H, hd] -> [L, nb, H, BS, hd]
        return x.reshape(num_layers, nb, block_size, h, hd).permute(0, 1, 3, 2, 4)

    kb, vb = to_blocks(ks), to_blocks(vs)
    index = (slice(None), block_ids)
    if len(kv) == 4:
        k, v, ksc, vsc = kv
        qk, sk = quantize_rows(kb, k.dtype)
        qv, sv = quantize_rows(vb, v.dtype)
        _put(k, index, qk)
        _put(v, index, qv)
        ksc[index] = sk
        vsc[index] = sv
    else:
        _put(kv[0], index, kb)
        _put(kv[1], index, vb)


def _paged_write_rows(kv, layer, write_blocks, offsets, k, v):
    """A step's per-slot rows (k, v [S, H, hd] or [S, T, H, hd]) into
    block ``write_blocks`` at row ``offsets`` (both [S] or [S, T])."""
    index = (layer, write_blocks, slice(None), offsets)
    if len(kv) == 4:
        kk, vv, ksc, vsc = kv
        qk, sk = quantize_rows(k, kk.dtype)
        qv, sv = quantize_rows(v, vv.dtype)
        _put(kk, index, qk)
        _put(vv, index, qv)
        ksc[index] = sk
        vsc[index] = sv
    else:
        _put(kv[0], index, k)
        _put(kv[1], index, v)


def _paged_gather_dequant(kv, layer, tables, dtype):
    """Quantized gather path: blocks and scales by table, dequantized ->
    (k, v) [S, H, nb*BS, D]."""
    k, v, ksc, vsc = kv
    s, nb = tables.shape
    _, _, h, bs, d = k.shape

    def gather(blocks, scales):
        g = dequantize_rows(_take(blocks[layer], tables), scales[layer][tables], dtype)
        return g.transpose(1, 2).reshape(s, h, nb * bs, d)

    return gather(k, ksc), gather(v, vsc)


def _paged_decode_forward(model, kv, tokens, positions, tables, *,
                          block_size: int, attention: str = "xla"):
    """The paged twin of :func:`_decode_forward`: writes route through
    the block table; attention is the fused kernel under
    ``attention="paged_flash"``, else the plain gather path. ``tables``
    is [S, nb] int32 on the device. Returns logits [S, V]."""
    x = _embed_in(model, tokens, positions)
    lengths = (positions + 1).to(torch.int32)
    slots = torch.arange(tokens.shape[0], device=tokens.device)
    write_blocks = tables[slots, positions // block_size].long()
    offsets = positions % block_size
    fused = attention == "paged_flash"
    for layer in range(model.cfg.num_layers):
        blk = model.block(layer)
        q, k, v = _qkv(_layer_norm(x, blk.ln_1), blk.attn)  # [S, H, hd]
        _paged_write_rows(kv, layer, write_blocks, offsets, k, v)
        if len(kv) == 4:
            if fused:
                att = paged_decode_attention(
                    q.contiguous(), kv[0][layer], kv[1][layer], lengths, tables,
                    k_scale=kv[2][layer], v_scale=kv[3][layer],
                )
            else:
                kk, vv = _paged_gather_dequant(kv, layer, tables.long(), q.dtype)
                att = kv_mod.varlen_decode_attention(q, kk, vv, lengths)
        elif fused:
            att = paged_decode_attention(
                q.contiguous(), kv[0][layer], kv[1][layer], lengths, tables
            )
        else:
            att = kv_mod.varlen_decode_attention(
                q, kv[0][layer], kv[1][layer], lengths, block_tables=tables
            )
        x = x + _attn_out(att, blk.attn, _reduce(model, "attn"))
        x = x + _block_mlp(_layer_norm(x, blk.ln_2), blk, _reduce(model, "mlp"))
    return _logits(model, _layer_norm(x, model.ln_f))


def _paged_verify_forward(model, kv, tokens, positions, tables, *, block_size: int):
    """The paged twin of :func:`_verify_forward`: T rows a slot scattered
    through the block table (a window may cross blocks), attention over
    the slot's gathered view. A row past the slot's allocated blocks or
    the table lands in the null block, whose garbage acceptance never
    commits. Returns logits [S, T, V]."""
    cfg = model.cfg
    t_n = tokens.shape[1]
    nb = tables.shape[1]
    pos_grid = positions[:, None] + torch.arange(t_n, device=tokens.device)
    x = _embed_in(model, tokens, pos_grid.clamp(max=cfg.max_len - 1))
    tab = tables.long()
    blk_idx = (pos_grid // block_size).clamp(max=nb - 1)
    write_blocks = torch.where(pos_grid < nb * block_size, torch.gather(tab, 1, blk_idx), 0)
    offsets = pos_grid % block_size
    for layer in range(cfg.num_layers):
        blk = model.block(layer)
        q, k, v = _qkv(_layer_norm(x, blk.ln_1), blk.attn)  # [S, T, H, hd]
        _paged_write_rows(kv, layer, write_blocks, offsets, k, v)
        if len(kv) == 4:
            kk, vv = _paged_gather_dequant(kv, layer, tab, q.dtype)
            att = kv_mod.varlen_verify_attention(q, kk, vv, positions)
        else:
            att = kv_mod.varlen_verify_attention(
                q, kv[0][layer], kv[1][layer], positions, block_tables=tables
            )
        x = x + _attn_out(att, blk.attn, _reduce(model, "attn"))
        x = x + _block_mlp(_layer_norm(x, blk.ln_2), blk, _reduce(model, "mlp"))
    return _logits(model, _layer_norm(x, model.ln_f))


def _extend_forward(model, kv, ctx_table, tail_ids, tokens, ctx_len: int,
                    *, block_size: int):
    """Prefill on top of a cached context (a prefix-cache hit, or a chunk
    of a chunked prefill): run only the prompt tail ``tokens`` [1, tb] at
    positions ``ctx_len + i``; each tail row attends (a) the cached context
    gathered by ``ctx_table`` [max_blocks], masked to ``ctx_len`` columns,
    and (b) the tail itself, causally. Tail K/V is written into
    ``tail_ids`` [tb // BS] after the last layer. Numerics mirror
    ``varlen_decode_attention``. Returns logits [1, tb, V]."""
    cfg = model.cfg
    dev = tokens.device
    tb = tokens.shape[1]
    hd = cfg.head_dim
    sm_scale = hd ** -0.5
    positions = ctx_len + torch.arange(tb, device=dev)
    # Pad rows past the true tail may index past max_len; clip — they are
    # causally downstream of every real row and discarded.
    x = _embed_in(model, tokens, positions.clamp(max=cfg.max_len - 1)[None])
    quantized = len(kv) == 4
    ctx_cols = ctx_table.shape[0] * block_size
    ctx_ok = torch.arange(ctx_cols, device=dev) < ctx_len
    causal = torch.ones(tb, tb, dtype=torch.bool, device=dev).tril()
    ks, vs = [], []
    for layer in range(cfg.num_layers):
        blk = model.block(layer)
        q, k, v = _qkv(_layer_norm(x, blk.ln_1), blk.attn)  # [1, tb, H, hd]
        ks.append(k[0])
        vs.append(v[0])
        if quantized:
            kc = dequantize_rows(_take(kv[0][layer], ctx_table), kv[2][layer][ctx_table], q.dtype)
            vc = dequantize_rows(_take(kv[1][layer], ctx_table), kv[3][layer][ctx_table], q.dtype)
        else:
            kc = kv[0][layer][ctx_table].to(q.dtype)
            vc = kv[1][layer][ctx_table].to(q.dtype)
        # [nb, H, BS, hd] -> [H, nb*BS, hd]
        kc = kc.transpose(0, 1).reshape(-1, ctx_cols, hd)
        vc = vc.transpose(0, 1).reshape(-1, ctx_cols, hd)
        qh = q.transpose(1, 2).float()  # [1, H, tb, hd]
        s_ctx = torch.einsum("bhtd,hkd->bhtk", qh, kc.float()) * sm_scale
        s_ctx = torch.where(ctx_ok, s_ctx, NEG_INF)
        s_tail = torch.matmul(qh, k.transpose(1, 2).float().transpose(-1, -2)) * sm_scale
        s_tail = torch.where(causal, s_tail, NEG_INF)
        prob = torch.softmax(torch.cat([s_ctx, s_tail], dim=-1), dim=-1)
        p_ctx, p_tail = prob[..., :ctx_cols], prob[..., ctx_cols:]
        out = torch.einsum("bhtk,hkd->bhtd", p_ctx.to(vc.dtype).float(), vc.float())
        out = out + torch.matmul(p_tail.to(v.dtype).float(), v.transpose(1, 2).float())
        att = out.to(q.dtype).transpose(1, 2)
        x = x + _attn_out(att, blk.attn, _reduce(model, "attn"))
        x = x + _block_mlp(_layer_norm(x, blk.ln_2), blk, _reduce(model, "mlp"))
    _paged_write_prompt(kv, torch.stack(ks), torch.stack(vs), tail_ids,
                        block_size=block_size)
    return _logits(model, _layer_norm(x, model.ln_f))


# -------------------------------------------------------------- sampling


def request_key(seed: int, position: int) -> np.ndarray:
    """The per-token sampling key: a pure function of (request seed,
    absolute position), so batched serving and the unbatched reference
    draw the same noise; the JAX engine's ``request_key``."""
    return rng.fold_in(rng.PRNGKey(seed), position)


def _sample_row(logits: torch.Tensor, temp: float, top_k: int, seed: int,
                position: int) -> int:
    """One row's next token: argmax at temperature 0, else a categorical
    draw over the temperature-scaled logits with everything below the
    top-k-th value masked (``top_k > 0``). The sampled branch runs on the
    CPU in float32, the reference's ``_sample_row`` step for step."""
    if temp == 0.0:
        return int(logits.float().argmax())
    scaled = logits.detach().float().cpu() / temp
    if top_k > 0:
        kth = torch.sort(scaled).values[max(scaled.shape[0] - top_k, 0)]
        scaled = torch.where(scaled < kth, NEG_INF, scaled)
    return rng.categorical(request_key(seed, position), scaled)


def top_logprobs(logits: np.ndarray, top_n: int) -> list[dict]:
    """Next-token distribution head: top-n (token, logprob) pairs."""
    x = logits.astype(np.float64)
    logz = np.log(np.sum(np.exp(x - x.max()))) + x.max()
    order = np.argsort(x)[::-1][:top_n]
    return [{"token": int(t), "logprob": float(x[t] - logz)} for t in order]


# ------------------------------------------------------------ CUDA graphs


# The kernel wrappers a captured rung can launch; each counts its
# launches in Python, which a replayed graph does not run.
COUNTED_KERNELS = (paged_decode_attention, flash_decode_attention)


class GraphRung:
    """One decode or verify rung as CUDA graphs, one per input signature.

    The first call under a signature copies its inputs into static device
    buffers, runs ``fn`` once eagerly on a side stream (allocator and
    library warm-up, real launches that the kernel wrappers count), then
    captures ``fn`` into a graph on ``pool``. Each later call copies its
    inputs into the buffers and replays; the returned tensor is the
    graph's static output, valid until the next replay of the rung.

    Launch counting stays honest: the kernel wrappers count in Python,
    which a replay skips, so the launches a capture records are taken
    back out of the counters and added once per replay (``tally``).
    ``graph_cls``/``capture`` are the CUDA graph and its capture context;
    a test hands in stand-ins to check the tally on the CPU."""

    def __init__(self, fn, device, pool=None, *, kernels=None, graph_cls=None, capture=None):
        self._fn = fn
        self._device = device
        self._pool = pool
        self._kernels = COUNTED_KERNELS if kernels is None else tuple(kernels)
        self._graph_cls = graph_cls or torch.cuda.CUDAGraph
        # thread_local: in a fleet of in-process replicas a restarted or
        # added replica captures while the others launch kernels and
        # allocate on their own threads; the global mode would refuse
        # those calls (or invalidate this capture).
        self._capture = capture or (lambda g: torch.cuda.graph(
            g, pool=self._pool, capture_error_mode="thread_local"))
        self._graphs: dict = {}

    def __call__(self, *args):
        sig = tuple((tuple(a.shape), str(a.dtype)) for a in args)
        entry = self._graphs.get(sig)
        if entry is None:
            entry = self._graphs[sig] = self._record(args)
        graph, buffers, out, tally = entry
        for buf, a in zip(buffers, args):
            buf.copy_(torch.as_tensor(a))
        graph.replay()
        graphs_mod.add_tally(tally)
        return out

    def _record(self, args):
        buffers = [torch.as_tensor(np.ascontiguousarray(a)).to(self._device) for a in args]
        if self._device.type == "cuda":
            side = torch.cuda.Stream(self._device)
            side.wait_stream(torch.cuda.current_stream(self._device))
            with torch.cuda.stream(side):
                self._fn(*buffers)
            torch.cuda.current_stream(self._device).wait_stream(side)
        else:
            self._fn(*buffers)
        graph = self._graph_cls()
        out, tally = graphs_mod.capture(self._capture(graph), lambda: self._fn(*buffers),
                                        self._kernels)
        return graph, buffers, out, tally

    def reset(self) -> None:
        """Drop every captured graph (the pool's tensors they address are
        gone); the next call recaptures."""
        self._graphs.clear()

    @property
    def captured(self) -> int:
        return len(self._graphs)

    def tallies(self) -> list[dict]:
        """Each captured graph's launches a replay, ``{"kernel.counter": n}``."""
        return [{f"{fn.__name__}.{name}": n for (fn, name), n in entry[3].items()}
                for entry in self._graphs.values()]


# ---------------------------------------------------------------- engine


class EngineStepError(RuntimeError):
    """A prefill, decode, extend or verify step failed at run time (or a
    rung's CUDA graph failed to capture). The engine has already
    reallocated the KV pool, so every in-flight request's cache is gone:
    the batcher must fail the whole active set, not just this request."""


class ChunkedPrefill:
    """An in-progress chunked prefill: the slot's blocks are allocated
    (prefix reuse applied); ``spans`` is the block-aligned chunk plan and
    ``idx`` the next chunk to run."""

    __slots__ = ("slot", "prompt", "spans", "idx", "seed", "temperature", "top_k")

    def __init__(self, slot, prompt, spans, seed, temperature, top_k):
        self.slot = slot
        self.prompt = prompt
        self.spans = spans
        self.idx = 0
        self.seed = seed
        self.temperature = temperature
        self.top_k = top_k


def _gather_bytes(t: torch.Tensor, axes, mesh, dim: int) -> torch.Tensor:
    """``collectives.all_gather`` of ``t``'s bytes along ``dim``: any
    dtype (fp8, which gloo does not carry, included) crosses as uint8."""
    if t.dtype == torch.uint8:
        return coll.all_gather(t.contiguous(), axes, mesh=mesh, dim=dim)
    return coll.all_gather(t.contiguous().view(torch.uint8), axes, mesh=mesh,
                           dim=dim).view(t.dtype)


def _gather_fsdp(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        if entry == AxisNames.FSDP:
            t = _gather_bytes(t, AxisNames.FSDP, mesh, dim)
    return t


class _FsdpGathered(Mapping):
    """``{name: leaf}`` whose leaves cut over ``fsdp`` are gathered over
    ``fsdp`` when looked up (a ``QuantizedWeight``'s payload and scale
    each along the dims they were cut on): the serving twin of
    ``sharding/layout._Gathered``, not differentiated."""

    def __init__(self, pieces: dict, specs: dict, mesh):
        self._pieces, self._specs, self._mesh = pieces, specs, mesh

    def __getitem__(self, name: str):
        leaf, spec = self._pieces[name], self._specs[name]
        if AxisNames.FSDP not in spec:
            return leaf
        if isinstance(leaf, precision_mod.QuantizedWeight):
            return precision_mod.QuantizedWeight(
                _gather_fsdp(leaf.q, spec, self._mesh),
                _gather_fsdp(leaf.scale, spec[:leaf.scale.dim()], self._mesh))
        return _gather_fsdp(leaf, spec, self._mesh)

    def __iter__(self):
        return iter(self._pieces)

    def __len__(self) -> int:
        return len(self._pieces)


class _ServingParams(ParamView):
    """The engine's weights as a flat ``{"h_0.attn.qkv.kernel": leaf}``
    dict (leaves are tensors or ``QuantizedWeight``s) with the model
    config, readable by the layer math like a :class:`GPT2`. A sharded
    engine's view holds this rank's pieces (``pieces``; looked up through
    :class:`_FsdpGathered` where the rules cut over ``fsdp``), its
    ``mesh`` and the ``model`` psums of the row-parallel products it
    splits."""

    mesh = None
    reduce_attn = None
    reduce_mlp = None

    def __init__(self, cfg: TransformerConfig, params: dict, lookup=None):
        super().__init__(params if lookup is None else lookup)
        self.pieces = params
        self.cfg = cfg


def _cache_dtype(name: str, default: torch.dtype) -> torch.dtype:
    if not name:
        return default
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"cache_dtype={name!r} is not a torch dtype name")
    return dt


class InferenceEngine:
    """Holds the model and the KV pool, runs the warmed rungs.

    ``params`` is a :class:`GPT2` module or a JAX-layout param tree
    (``models/convert.py``); ``precision`` a ``PrecisionConfig``
    (``weight_dtype`` is sugar for the weight-only registry). ``device``
    defaults to ``cuda`` and raises when no GPU is visible; pass
    ``device="cpu"`` for the CPU, where each kernel wrapper takes its
    plain version and no graph is captured. ``cuda_graphs=False`` runs
    the decode and verify rungs eagerly on the card (for comparing the
    two). The device-facing methods are single-threaded by contract: the
    batcher's loop thread is the only caller.

    ``sharding`` (a ``ShardingConfig``, the one a training run keeps as
    ``workdir/sharding.json``) serves the model split over the
    ``model`` axis of a mesh of ranks, one process a rank, the
    reference's sharded engine as SPMD code: every rank builds this
    engine over its pieces of the params (placed by the config's rules,
    ``GPT2_RULES`` when it has none, and quantized on the host first so
    each payload and scale is cut like its weight) and a KV pool of its
    heads (``H / m``, or all ``H`` when the rules leave qkv whole), and
    every rank must make the same calls in the same order
    (``serving/mesh_driver.py`` replays rank 0's). ``param_sharding_digest``
    is the reference's digest of the placement. A leaf the rules cut over
    ``fsdp`` is gathered over ``fsdp`` each time the layer math reads it;
    the KV pool is replicated over ``fsdp``, as over every other axis but
    ``model``. The KV-page hand-off works in every role: the export
    gathers each rank's heads of the pages over the axes that cut qkv's
    heads, so the payload is the reference's ``[L, nb, H, BS, D]``, and the
    import writes this rank's heads of a full payload. A CUDA graph cannot
    hold collectives staged through host memory, so ``cuda_graphs=True``
    on a gloo mesh of CUDA ranks raises ``ValueError``."""

    def __init__(self, model_cfg: TransformerConfig, params, *,
                 cfg: ServeConfig | None = None, registry=None, device=None,
                 precision=None, cuda_graphs: bool = True, sharding=None):
        if model_cfg.moe_experts:
            raise NotImplementedError("serving engine currently covers dense GPT-2 models only")
        self.sharding = sharding
        self.mesh = None
        self.param_sharding_digest = None
        if sharding is None:
            self.device = resolve_device(device)
        else:
            self.device = distributed.local_device(device or "cuda")
            self.mesh = sharding.build_mesh(device=self.device)
            if cuda_graphs and self.device.type == "cuda" and self.mesh.backend == "gloo":
                raise ValueError(
                    "cuda_graphs=True on a gloo mesh: its collectives are staged through host "
                    "memory, which a CUDA graph cannot hold; pass cuda_graphs=False (the "
                    "kernels still run on the card) or give each rank a card of its own (nccl)")
        if self.device.type == "cuda":
            # The reference computes in f32. TF32 matmuls keep ~3 decimal
            # digits, enough to flip greedy tokens away from it.
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model_cfg = model_cfg
        self.cfg = cfg = cfg or ServeConfig()
        if cfg.attention not in ATTENTION_IMPLS:
            raise ValueError(f"ServeConfig.attention={cfg.attention!r} not in {ATTENTION_IMPLS}")
        # Prefill runs the full-prompt causal forward, through the
        # flash-decode kernel under both kernel routes (under
        # "paged_flash" the reference's prefill is XLA; here the kernel
        # takes it, so a prefill-role replica's pages come from the
        # kernel); the paged kernel is the per-slot decode step's.
        self._prefill_attn = "flash" if cfg.attention in ("flash", "paged_flash") else "xla"
        # This stack's replica index in a fleet (0 standalone): the key
        # the serve fault engine (utils/faults.py) targets.
        self.replica_id = 0
        self.precision = precision
        if self.precision is None and cfg.weight_dtype:
            self.precision = precision_mod.PrecisionConfig.weight_only(
                cfg.weight_dtype, kv_dtype=cfg.kv_dtype)
        self.kv_dtype = cfg.kv_dtype or (self.precision.kv_dtype if self.precision else "")
        self.paged = cfg.kv_block_size > 0
        if cfg.attention == "paged_flash" and not self.paged:
            raise ValueError("attention='paged_flash' is the fused paged-decode "
                             "kernel — it requires the paged pool (set kv_block_size)")
        if cfg.attention == "paged_flash" and self.kv_dtype == "fp8":
            raise ValueError("attention='paged_flash' dequantizes int8 in-kernel; fp8 KV "
                             "serves through the gather path (attention='xla')")
        if self.kv_dtype and not self.paged:
            raise ValueError("kv_dtype (quantized KV) requires the paged pool — "
                             "set kv_block_size")
        if cfg.role not in scheduler.ROLES:
            raise ValueError(f"role={cfg.role!r} not in ('mixed', 'prefill', 'decode')")
        if cfg.prefill_chunk_tokens < 0:
            raise ValueError(f"prefill_chunk_tokens={cfg.prefill_chunk_tokens} must be >= 0")
        if cfg.prefill_chunk_tokens:
            if not self.paged or not cfg.prefix_cache:
                raise ValueError("prefill_chunk_tokens requires the paged pool with "
                                 "prefix_cache=True (a chunk runs on the extend rungs)")
            if cfg.prefill_chunk_tokens % cfg.kv_block_size:
                raise ValueError(f"prefill_chunk_tokens={cfg.prefill_chunk_tokens} must be a "
                                 f"multiple of kv_block_size={cfg.kv_block_size} (chunk "
                                 "boundaries write whole blocks)")
        if cfg.spec_decode_k < 0:
            raise ValueError(f"spec_decode_k={cfg.spec_decode_k} must be >= 0")
        if cfg.spec_decode_k + 1 > cfg.prefill_bucket_floor:
            # Parked slots write their discarded verify rows at positions
            # [0, k+1); any later prefill overwrites at least the smallest
            # bucket, which must cover them.
            raise ValueError(f"spec_decode_k={cfg.spec_decode_k} + 1 must not exceed "
                             f"prefill_bucket_floor={cfg.prefill_bucket_floor}")
        if (self.device.type == "cuda" and cfg.attention != "xla"
                and model_cfg.head_dim not in SUPPORTED_HEAD_DIMS):
            raise ValueError(f"attention={cfg.attention!r} kernels take head_dim in "
                             f"{SUPPORTED_HEAD_DIMS}, the model has {model_cfg.head_dim}")
        self._head_axes = ()
        self.model = self._load(model_cfg, params)
        # The heads this rank's qkv projection makes: its KV pool's.
        self.local_heads = int(ParamView(self._param_tree()).block(0).attn.qkv.kernel.shape[2])
        self.registry = registry if registry is not None else registry_mod.default_registry()
        self.sentinel = CompilationSentinel(warmup=cfg.compile_warmup, registry=self.registry)
        self._precision_stats = precision_mod.tree_precision_stats(self._param_tree())
        self.quantized_weights = self._precision_stats["quantized_params"] > 0
        for key in ("weight_bits", "param_bytes", "param_bytes_f32", "quantized_params"):
            self.registry.gauge(f"precision/{key}").set(self._precision_stats[key])
        wte = self.model.wte.embedding
        param_dtype = (torch.float32 if isinstance(wte, precision_mod.QuantizedWeight)
                       else wte.dtype)
        pool_kw = dict(
            num_layers=model_cfg.num_layers, num_slots=cfg.max_slots,
            num_heads=self.local_heads, max_len=model_cfg.max_len,
            head_dim=model_cfg.head_dim, dtype=_cache_dtype(cfg.cache_dtype, param_dtype),
            device=self.device, registry=self.registry,
        )
        if self.paged:
            bs = cfg.kv_block_size
            for name, val in (("prefill_bucket_floor", cfg.prefill_bucket_floor),
                              ("kv_bucket_floor", cfg.kv_bucket_floor),
                              ("max_len", model_cfg.max_len)):
                if val % bs:
                    raise ValueError(f"kv_block_size={bs} must divide {name}={val} "
                                     "(every bucket is a whole number of blocks)")
            self.pool = paged_kv.PagedKVPool(
                block_size=bs, num_blocks=cfg.kv_blocks, kv_dtype=self.kv_dtype,
                prefix_cache=cfg.prefix_cache, **pool_kw,
            )
        else:
            self.pool = kv_mod.KVCachePool(**pool_kw)
        self.prefill_ladder = kv_mod.bucket_ladder(cfg.prefill_bucket_floor, model_cfg.max_len)
        self.kv_ladder = kv_mod.bucket_ladder(cfg.kv_bucket_floor, model_cfg.max_len)
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self._graph_pool = torch.cuda.graph_pool_handle() if self.cuda_graphs else None
        self._graph_rungs: dict[str, GraphRung] = {}
        self._build_rungs()
        self.warmed = False

    def _load(self, model_cfg: TransformerConfig, params):
        """The weights on the device: the GPT2 module as given, or, under
        a precision registry, the tree quantized on the CPU first; under
        ``sharding`` this rank's pieces of that tree."""
        if self.precision is None and self.sharding is None:
            if isinstance(params, GPT2):
                model = params.to(self.device)
            else:
                model = model_from_params(model_cfg, params, device=self.device)
            return model.requires_grad_(False).eval()
        if isinstance(params, GPT2):
            tree = {k.replace(".", "/"): t.detach() for k, t in params.state_dict().items()}
        else:
            tree = flatten_tree(params)
        if self.precision is not None:
            flat = precision_mod.quantize_tree(tree, self.precision)
        else:
            flat = {path: torch.as_tensor(leaf) for path, leaf in tree.items()}
        flat = {path.replace("/", "."): leaf for path, leaf in flat.items()}
        if self.sharding is None:
            return _ServingParams(model_cfg, {n: leaf.to(self.device) for n, leaf in flat.items()})
        rules = self.sharding.sharding_rules(default=GPT2_RULES)
        self.param_sharding_digest = resolve_params(flat, self.mesh, rules).digest()
        specs = shardings_for_params(flat, self.mesh, rules)
        for name, spec in specs.items():
            if any(isinstance(e, tuple) and AxisNames.FSDP in e for e in spec):
                raise ValueError(f"{name}: fsdp must shard a dim alone, got {spec}")
        # The axes that cut qkv's heads: the KV pool's, and the hand-off's gather.
        head_entry = (specs["h_0.attn.qkv.kernel"] + (None,) * 3)[2]
        self._head_axes = (() if head_entry is None else
                           (head_entry,) if isinstance(head_entry, str) else tuple(head_entry))
        pieces = {n: leaf.to(self.device) for n, leaf in shard_params(flat, self.mesh,
                                                                      rules).items()}
        fsdp = any(AxisNames.FSDP in spec for spec in specs.values())
        view = _ServingParams(model_cfg, pieces,
                              _FsdpGathered(pieces, specs, self.mesh) if fsdp else None)
        view.mesh = self.mesh
        blk = ParamView(pieces).block(0)  # shapes on the model axis: fsdp cuts other dims
        heads, proj_rows = blk.attn.qkv.kernel.shape[2], blk.attn.proj.kernel.shape[0]
        fc_cols, proj_in = blk.mlp_fc.kernel.shape[1], blk.mlp_proj.kernel.shape[0]
        if heads != proj_rows or fc_cols != proj_in:
            raise ValueError(
                f"the sharding rules split qkv into {heads} heads but proj into {proj_rows} "
                f"rows, or mlp_fc into {fc_cols} columns but mlp_proj into {proj_in} rows: a "
                "row-parallel product must take its column-parallel input's split")
        psum = functools.partial(coll.psum, axis=AxisNames.MODEL, mesh=self.mesh)
        view.reduce_attn = psum if heads < model_cfg.num_heads else None
        view.reduce_mlp = psum if proj_in < model_cfg.ff_dim else None
        return view

    @property
    def mesh_shape(self) -> dict | None:
        """Axis -> size of a sharded engine's mesh (None unsharded): with
        ``param_sharding_digest``, the reference's ``SHARDING_KEYS``."""
        return dict(self.mesh.shape) if self.mesh is not None else None

    def _param_tree(self) -> dict:
        if isinstance(self.model, GPT2):
            return self.model.state_dict()
        return self.model.pieces

    # ------------------------------------------------------------ rungs

    def _build_rungs(self) -> None:
        cfg, wrap = self.cfg, self.sentinel.wrap
        paged = self.paged
        prefill = self._paged_prefill_rung if paged else self._prefill_rung
        decode = self._paged_decode_rung if paged else self._decode_rung
        verify = self._paged_verify_rung if paged else self._verify_rung
        self._prefill_fns = {lb: wrap(prefill, f"serve_prefill_L{lb}")
                             for lb in self.prefill_ladder}
        self._decode_fns = {kb: wrap(self._graphed(decode, kb, f"serve_decode_K{kb}"),
                                     f"serve_decode_K{kb}") for kb in self.kv_ladder}
        # One extend rung a tail bucket; the cached context rides in as
        # the slot's whole block table, masked to its true length.
        self._extend_fns = ({tb: wrap(self._extend_rung, f"serve_extend_T{tb}")
                             for tb in self.prefill_ladder}
                            if paged and cfg.prefix_cache else {})
        self._verify_fns = ({kb: wrap(self._graphed(verify, kb, f"serve_verify_K{kb}"),
                                      f"serve_verify_K{kb}") for kb in self.kv_ladder}
                            if cfg.spec_decode_k > 0 else {})

    def _graphed(self, fn, bucket: int, name: str):
        step = lambda *args: fn(bucket, *args)
        if not self.cuda_graphs:
            return step
        rung = self._graph_rungs[name] = GraphRung(step, self.device, self._graph_pool)
        return rung

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _prefill_rung(self, slot: int, tokens, length: int) -> torch.Tensor:
        """Dense prefill: the slot's rows [0, bucket) and the last true
        row's logits."""
        bucket = tokens.shape[1]
        logits, ks, vs = forward_full(self.model, self._t(tokens), impl=self._prefill_attn)
        # [L, 1, bucket, H, hd] -> the slot's [L, H, bucket, hd] rows.
        self.pool.k[:, slot, :, :bucket] = ks[:, 0].transpose(1, 2).to(self.pool.k.dtype)
        self.pool.v[:, slot, :, :bucket] = vs[:, 0].transpose(1, 2).to(self.pool.v.dtype)
        return logits[0, length - 1]

    def _paged_prefill_rung(self, block_ids, tokens, length: int) -> torch.Tensor:
        logits, ks, vs = forward_full(self.model, self._t(tokens), impl=self._prefill_attn)
        _paged_write_prompt(self.pool.kv_state(), ks[:, 0], vs[:, 0], self._t(block_ids),
                            block_size=self.cfg.kv_block_size)
        return logits[0, length - 1]

    def _extend_rung(self, ctx_table, tail_ids, tokens, ctx_len: int, tail_len: int):
        logits = _extend_forward(self.model, self.pool.kv_state(), self._t(ctx_table),
                                 self._t(tail_ids), self._t(tokens), ctx_len,
                                 block_size=self.cfg.kv_block_size)
        return logits[0, tail_len - 1]

    def _decode_rung(self, bucket, tokens, positions):
        return _decode_forward(self.model, self.pool.k, self.pool.v, self._t(tokens),
                               self._t(positions), kv_bucket=bucket)

    def _paged_decode_rung(self, bucket, tokens, positions, tables):
        return _paged_decode_forward(self.model, self.pool.kv_state(), self._t(tokens),
                                     self._t(positions), self._t(tables),
                                     block_size=self.cfg.kv_block_size,
                                     attention=self.cfg.attention)

    def _verify_rung(self, bucket, tokens, positions):
        return _verify_forward(self.model, self.pool.k, self.pool.v, self._t(tokens),
                               self._t(positions), kv_bucket=bucket)

    def _paged_verify_rung(self, bucket, tokens, positions, tables):
        return _paged_verify_forward(self.model, self.pool.kv_state(), self._t(tokens),
                                     self._t(positions), self._t(tables),
                                     block_size=self.cfg.kv_block_size)

    def _run_compiled(self, kind: str, fn, *args):
        """Run one rung. On any failure the KV pool is reallocated (with
        it every captured graph, whose recapture counts as a recompile)
        and :class:`EngineStepError` raises: the one place the
        step-failure contract lives. The step holds ``LAUNCH_LOCK`` so
        another replica's capture in this process cannot count it."""
        try:
            with host_span(f"engine_{kind}_dispatch"), graphs_mod.LAUNCH_LOCK:
                return fn(*args)
        except Exception as e:
            self.pool.reallocate()
            for name, rung in self._graph_rungs.items():
                rung.reset()
                self.sentinel.invalidate(name)
            raise EngineStepError(f"compiled {kind} step failed (KV caches reallocated): "
                                  f"{type(e).__name__}: {e}") from e

    # --------------------------------------------------------- lifecycle

    @torch.no_grad()
    def warmup(self) -> dict[str, int]:
        """Run every rung of the ladder once ahead of traffic (on the card
        this captures each decode and verify rung's graph). Returns the
        per-rung compile counts; any later compile is a recompile that
        :meth:`post_warmup_recompiles` counts."""
        s, t_n = self.cfg.max_slots, self.cfg.spec_decode_k + 1
        z = lambda *shape, dt=np.int64: np.zeros(shape, dt)

        def run(fn, *args):
            # Each rung under LAUNCH_LOCK, as a served step runs: another
            # replica's capture in this process must not count these.
            with graphs_mod.LAUNCH_LOCK:
                fn(*args)

        if self.paged:
            bs = self.cfg.kv_block_size
            for lb, fn in self._prefill_fns.items():
                run(fn, z(lb // bs), z(1, lb), 1)
            for kb, fn in self._decode_fns.items():
                run(fn, z(s), z(s), z(s, kb // bs, dt=np.int32))
            for tb, fn in self._extend_fns.items():
                run(fn, z(self.pool.max_blocks_per_slot), z(tb // bs), z(1, tb), bs, 1)
            for kb, fn in self._verify_fns.items():
                run(fn, z(s, t_n), z(s), z(s, kb // bs, dt=np.int32))
        else:
            for lb, fn in self._prefill_fns.items():
                run(fn, 0, z(1, lb), 1)
            for fn in self._decode_fns.values():
                run(fn, z(s), z(s))
            for fn in self._verify_fns.values():
                run(fn, z(s, t_n), z(s))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.pool.reset()
        self.warmed = True
        counts = self.sentinel.compile_counts()
        log.info("serving engine warm: %d rungs (%s)", sum(counts.values()),
                 ", ".join(sorted(counts)))
        return counts

    def expected_compiles(self) -> int:
        return (len(self.prefill_ladder) + len(self.kv_ladder)
                + len(self._extend_fns) + len(self._verify_fns))

    def post_warmup_recompiles(self) -> int:
        """Compiles beyond each rung's warmup allowance: 0 in steady state."""
        return self.sentinel.post_warmup_recompiles()

    def graph_tallies(self) -> dict[str, list[dict]]:
        """Each captured rung's launches a replay (empty off the card)."""
        return {name: rung.tallies() for name, rung in self._graph_rungs.items() if rung.captured}

    # ------------------------------------------------ precision accounting

    def precision_stats(self) -> dict | None:
        """The serving line's precision keys (``weight_bits``,
        ``param_bytes``, ``param_bytes_f32``, ``quantized_params``) when
        the weights are quantized, else None."""
        return dict(self._precision_stats) if self.quantized_weights else None

    def byte_breakdown(self) -> dict:
        """Device bytes: ``params_bytes`` as stored (quantized leaves at one
        byte an element plus their f32 row scales), ``params_bytes_f32``
        (the same tree at 4 bytes an element), ``weight_bits`` and the KV
        pool's committed ``kv_cache_bytes``."""
        return {
            "params_bytes": precision_mod.tree_bytes(self._param_tree()),
            "weight_bits": self._precision_stats["weight_bits"],
            "params_bytes_f32": self._precision_stats["param_bytes_f32"],
            "kv_cache_bytes": int(self.pool.used_bytes()),
        }

    # ------------------------------------------------------ request ops

    def _prefill_fault_tick(self, slot: int) -> None:
        """The serve fault hook of a prefill-role replica, whose unit of
        work is the prefill: its fault schedule counts prefills (a chaos
        run can kill it mid hand-off). Other roles count decode steps."""
        if self.cfg.role != "prefill":
            return
        feng = faults_mod.serve_active()
        if feng is not None:
            feng.decode_step(self.replica_id, [slot])

    def _decode_fault_tick(self, entries) -> None:
        """The serve fault hook of a decode or verify step, before any
        device work: it may sleep (``slowrep``), raise a forced
        ``BlockExhausted`` (``kvexhaust``) or kill the replica's transport
        and raise ``InjectedCrash`` (``crash``)."""
        feng = faults_mod.serve_active()
        if feng is not None:
            feng.decode_step(self.replica_id, [e[0] for e in entries])

    @torch.no_grad()
    def prefill(self, slot: int, prompt: Sequence[int], *, seed: int = 0,
                temperature: float = 0.0, top_k: int = 0):
        """Run a prompt into ``slot``; returns (first generated token,
        last-position logits as numpy). The paged pool claims exactly the
        blocks the prompt needs (``BlockExhausted`` propagates before any
        device work) and, on a prefix-cache hit, prefills only the tail."""
        n = len(prompt)
        if n < 1:
            raise ValueError("empty prompt")
        if n > self.model_cfg.max_len:
            raise ValueError(f"prompt length {n} exceeds max_len {self.model_cfg.max_len}")
        self._prefill_fault_tick(slot)
        if self.paged:
            last = self._paged_prefill(slot, prompt)
        else:
            bucket = kv_mod.pick_bucket(self.prefill_ladder, n)
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :n] = prompt
            last = self._run_compiled("prefill", self._prefill_fns[bucket], slot, tokens, n)
        tok = _sample_row(last, temperature, top_k, seed, n)
        self.pool.lengths[slot] = n
        self.registry.counter("serving/prefill_tokens").inc(n)
        return int(tok), last.cpu().numpy()

    def _paged_prefill(self, slot, prompt) -> torch.Tensor:
        n = len(prompt)
        bs = self.cfg.kv_block_size
        ctx, _ = self.pool.claim_prompt_blocks(slot, prompt)
        total_blocks = -(-n // bs)
        if ctx == 0:
            bucket = kv_mod.pick_bucket(self.prefill_ladder, n)
            ids = np.zeros((bucket // bs,), np.int64)
            ids[:total_blocks] = self.pool.block_tables[slot, :total_blocks]
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :n] = prompt
            last = self._run_compiled("prefill", self._prefill_fns[bucket], ids, tokens, n)
        else:
            last = self._extend(slot, prompt, ctx, n)
            self.registry.counter("serving/prefix_reused_tokens").inc(ctx)
        self.pool.insert_prefix(slot, prompt)
        return last

    def _extend(self, slot, prompt, start: int, end: int) -> torch.Tensor:
        """Prefill ``prompt[start:end]`` (``start`` block-aligned) over the
        slot's cached rows [0, start) through the extend rung."""
        bs = self.cfg.kv_block_size
        tail = end - start
        tb = kv_mod.pick_bucket(self.prefill_ladder, tail)
        first_block, last_block = start // bs, -(-end // bs)
        tail_ids = np.zeros((tb // bs,), np.int64)
        tail_ids[:last_block - first_block] = self.pool.block_tables[slot, first_block:last_block]
        tokens = np.zeros((1, tb), np.int64)
        tokens[0, :tail] = prompt[start:end]
        return self._run_compiled(
            "prefill", self._extend_fns[tb],
            self.pool.block_tables[slot].astype(np.int64), tail_ids, tokens, start, tail,
        )

    # ------------------------------------------------ chunked prefill

    def prefill_open(self, slot: int, prompt: Sequence[int], *, seed: int = 0,
                     temperature: float = 0.0, top_k: int = 0) -> ChunkedPrefill | None:
        """Open a chunked prefill when ``prefill_chunk_tokens`` > 0 and the
        prompt is longer than a chunk: claims the slot's blocks (reused
        prefix blocks first; ``BlockExhausted`` before any device work)
        and returns the :class:`ChunkedPrefill` that :meth:`prefill_step`
        runs. None: the prompt needs no chunking (use :meth:`prefill`)."""
        chunk = self.cfg.prefill_chunk_tokens
        n = len(prompt)
        if chunk <= 0 or not self._extend_fns or n <= chunk:
            return None
        if n > self.model_cfg.max_len:
            raise ValueError(f"prompt length {n} exceeds max_len {self.model_cfg.max_len}")
        self._prefill_fault_tick(slot)
        ctx, _ = self.pool.claim_prompt_blocks(slot, prompt)
        if ctx:
            self.registry.counter("serving/prefix_reused_tokens").inc(ctx)
        spans = scheduler.plan_chunks(n, ctx, chunk, self.cfg.kv_block_size)
        if len(spans) > 1:
            # A one-span plan (the cold tail fits a chunk) is not a
            # chunked admission: the batcher runs it inline.
            self.registry.counter("serving/chunked_prefills").inc()
        return ChunkedPrefill(slot, [int(t) for t in prompt], spans, seed, temperature, top_k)

    @torch.no_grad()
    def prefill_step(self, state: ChunkedPrefill):
        """Run one chunk through its extend rung (the chunk attends the
        context written so far, masked to its true length, and itself
        causally). Returns ``(done, first_token, last_logits)``, the last
        two None until the final chunk, whose sampling key is
        ``request_key(seed, n)``, the unchunked prefill's."""
        slot, prompt = state.slot, state.prompt
        start, end = state.spans[state.idx]
        last = self._extend(slot, prompt, start, end)
        state.idx += 1
        self.registry.counter("serving/prefill_chunks").inc()
        if state.idx < len(state.spans):
            return False, None, None
        n = len(prompt)
        tok = _sample_row(last, state.temperature, state.top_k, state.seed, n)
        self.pool.lengths[slot] = n
        self.pool.insert_prefix(slot, prompt)
        self.registry.counter("serving/prefill_tokens").inc(n)
        return True, int(tok), last.cpu().numpy()

    # ------------------------------------------------- KV page hand-off

    def _page_geometry(self) -> dict:
        return dict(block_size=self.cfg.kv_block_size, num_layers=self.model_cfg.num_layers,
                    num_heads=self.model_cfg.num_heads, head_dim=self.model_cfg.head_dim,
                    kv_bits=self.pool.kv_bits)

    def _page_tensors(self) -> dict:
        names = ("k", "v", "k_scale", "v_scale")
        return dict(zip(names, self.pool.kv_state()))

    def _sharded_heads(self) -> bool:
        """Whether this rank's pool holds a slice of the heads (the rules
        cut qkv's heads); else every rank holds them all."""
        return self.local_heads < self.model_cfg.num_heads

    @torch.no_grad()
    def export_kv_pages(self, slot: int, prompt: Sequence[int], *, skip_tokens: int = 0) -> dict:
        """The slot's finished prompt KV blocks as the prefill->decode
        hand-off payload (``scheduler.encode_pages``, quantization scales
        included), in the reference's layout ``[L, nb, H, BS, D]``, so a
        JAX replica imports it too. The importer's decode continues from
        the same cache, so the handed-off stream equals a mixed replica's.

        ``skip_tokens`` is the delta hand-off: the importer already caches
        that many leading prompt tokens, so the full blocks they cover
        stay off the wire (``start_block``). Floored to a block multiple
        and capped so the last (partial) block always ships.

        On a mesh every rank takes part: each rank's heads of the pages
        (and the int8 scales) are gathered over the axes that cut qkv's
        heads, in the order ``shard_params`` cut them (ranks that differ
        only on other axes hold the same pages and gather in their own
        group), so every rank returns the same whole-H payload."""
        if not self.paged:
            raise ValueError("KV page export requires the paged pool (set kv_block_size)")
        if skip_tokens < 0:
            raise ValueError(f"skip_tokens={skip_tokens} must be >= 0")
        n = len(prompt)
        bs = self.cfg.kv_block_size
        nb = -(-n // bs)
        skip = min(int(skip_tokens) // bs, (n - 1) // bs)
        idx = self._t(self.pool.block_tables[slot, skip:nb].astype(np.int64))
        arrays = {name: _take(t, (slice(None), idx)) for name, t in self._page_tensors().items()}
        if self._sharded_heads():
            arrays = {name: _gather_bytes(a, self._head_axes, self.mesh, 2)
                      for name, a in arrays.items()}
        meta = dict(self._page_geometry(), length=n, start_block=skip)
        self.registry.counter("serving/kv_pages_exported").inc(nb - skip)
        if skip:
            self.registry.counter("serving/kv_pages_delta_skipped").inc(skip)
        return scheduler.encode_pages(meta, arrays)

    def check_pages(self, payload, prompt: Sequence[int]) -> tuple[dict, dict]:
        """Decode a hand-off payload and check it against this engine:
        geometry (the model's whole ``H`` on a mesh too), length, shapes
        and dtypes. Returns ``(meta, arrays)``; a mismatch is a
        ``ValueError`` (400 upstream), never a silently wrong cache."""
        if not self.paged:
            raise ValueError("KV page import requires the paged pool (set kv_block_size)")
        meta, arrays = scheduler.decode_pages(payload)
        for key, want in self._page_geometry().items():
            if meta[key] != want:
                raise ValueError(f"pages geometry mismatch: {key}={meta[key]} but "
                                 f"this replica serves {key}={want}")
        n = meta["length"]
        if n != len(prompt):
            raise ValueError(f"pages cover {n} tokens but the prompt has {len(prompt)}")
        if n > self.model_cfg.max_len:
            raise ValueError(f"pages length {n} exceeds max_len {self.model_cfg.max_len}")
        bs = self.cfg.kv_block_size
        nb = -(-n // bs)
        start = meta.get("start_block", 0)
        if start >= nb:
            raise ValueError(f"pages start_block={start} but the prompt spans only {nb} blocks")
        kv_shape = (meta["num_layers"], nb - start, meta["num_heads"], bs, meta["head_dim"])
        tensors = self._page_tensors()
        for name in tensors:
            want_shape = kv_shape if name in ("k", "v") else kv_shape[:-1]
            arr = arrays.get(name)
            if arr is None:
                raise ValueError(f"pages payload is missing {name!r}")
            if tuple(arr.shape) != want_shape:
                raise ValueError(f"pages array {name!r} has shape {tuple(arr.shape)}, "
                                 f"expected {want_shape}")
        for name, t in tensors.items():
            # kv_bits catches a width mismatch; this catches the kind (f16
            # pages into a bf16 pool would be value-cast, silently wrong).
            if arrays[name].dtype != t.dtype:
                raise ValueError(f"pages dtype mismatch: {name!r} is "
                                 f"{scheduler.wire_dtype(arrays[name].dtype)} but this "
                                 f"replica's cache stores {scheduler.wire_dtype(t.dtype)}")
        return meta, {name: arrays[name] for name in tensors}

    def head_slice(self, rank: int | None = None) -> slice:
        """The heads of a whole-H page array that ``rank``'s pool holds
        (this rank's by default): ``[i * H/m, (i + 1) * H/m)`` with ``i``
        the rank's index over the axes that cut qkv's heads."""
        if not self._sharded_heads():
            return slice(None)
        i = self.mesh.axis_index(self._head_axes, rank=rank)
        return slice(i * self.local_heads, (i + 1) * self.local_heads)

    @torch.no_grad()
    def import_kv_pages(self, slot: int, payload, prompt: Sequence[int]) -> None:
        """Map a hand-off payload into ``slot``: :meth:`check_pages`, then
        :meth:`map_pages` of this rank's heads. On a mesh every rank must
        make the call with the whole payload; ``serving/mesh_driver.py``
        instead checks it on rank 0 and sends each rank its heads."""
        meta, arrays = self.check_pages(payload, prompt)
        heads = self.head_slice()
        self.map_pages(slot, meta, {name: a[:, :, heads] for name, a in arrays.items()}, prompt)

    @torch.no_grad()
    def map_pages(self, slot: int, meta: dict, arrays: dict, prompt: Sequence[int]) -> None:
        """Map checked pages (``arrays``: this rank's heads) into
        ``slot``: claim the prompt's blocks (leading blocks this pool
        already caches are mapped, not written; ``BlockExhausted`` comes
        before any write), write the rest in place, set the slot's length
        and publish the prompt into the local prefix cache. A delta
        payload whose skipped blocks this pool's prefix cache does not
        cover is refused loudly. Every rank's host state moves alike."""
        n, bs = meta["length"], self.cfg.kv_block_size
        nb = -(-n // bs)
        start = meta.get("start_block", 0)
        ctx, fresh = self.pool.claim_prompt_blocks(slot, prompt)
        if ctx < start * bs:
            raise ValueError(f"delta pages start at block {start} but this replica's prefix "
                             f"cache covers only {ctx} of {start * bs} skipped tokens — "
                             "re-send full pages")
        if fresh:
            col = nb - len(fresh) - start  # payload column of fresh[0]
            self.pool.write_blocks(fresh, {name: a[:, col:] for name, a in arrays.items()})
        self.pool.lengths[slot] = n
        self.pool.insert_prefix(slot, prompt)
        self.registry.counter("serving/kv_pages_imported").inc(len(fresh))
        if ctx:
            self.registry.counter("serving/prefix_reused_tokens").inc(ctx)

    # ------------------------------------------------------- decode steps

    def _grow(self, slots, want) -> dict[int, int]:
        """Grow each slot's block table to cover position ``want[slot]``
        before the device step, falling back to the slot's own position
        (``want`` maps slot -> (wanted, needed)); returns each slot's
        covered rows. Raises ``BlockExhausted`` naming the slots that could
        not back even their needed row: only they fail."""
        exhausted, covered = [], {}
        for slot in slots:
            wanted, needed = want[slot]
            try:
                self.pool.ensure_position(slot, wanted)
            except paged_kv.BlockExhausted:
                try:
                    self.pool.ensure_position(slot, needed)
                except paged_kv.BlockExhausted:
                    exhausted.append(slot)
                    continue
            covered[slot] = self.pool.covered_positions(slot)
        if exhausted:
            raise paged_kv.BlockExhausted(
                f"KV block pool exhausted mid-decode for slot(s) {exhausted}; "
                "pool is serving at capacity", slots=tuple(exhausted),
            )
        return covered

    def _tables(self, slots, bucket: int) -> np.ndarray:
        """The step's block tables cut to ``bucket``, with every slot not
        stepping pointed at the null block: a parked slot's discarded
        write must not land in the blocks of a request mid chunked
        prefill."""
        tables = np.zeros((self.cfg.max_slots, bucket // self.cfg.kv_block_size), np.int32)
        rows = list(slots)
        tables[rows] = self.pool.block_tables[rows, :tables.shape[1]]
        return tables

    @torch.no_grad()
    def decode(self, entries: Sequence[tuple[int, int, int, float, int]]):
        """One continuous-decode step. ``entries``: (slot, input_token,
        seed, temperature, top_k) per active request; each input token
        sits at cache row ``pool.lengths[slot]``. Returns {slot: token}."""
        if not entries:
            return {}
        self._decode_fault_tick(entries)
        s = self.cfg.max_slots
        tokens = np.zeros((s,), np.int64)
        positions = np.zeros((s,), np.int64)
        for slot, token, _, _, _ in entries:
            tokens[slot] = token
            positions[slot] = int(self.pool.lengths[slot])
        bucket = kv_mod.pick_bucket(self.kv_ladder, int(positions.max(initial=0)) + 1)
        slots = [e[0] for e in entries]
        if self.paged:
            self._grow(slots, {slot: (int(positions[slot]),) * 2 for slot in slots})
            args = (tokens, positions, self._tables(slots, bucket))
        else:
            args = (tokens, positions)
        logits = self._run_compiled("decode", self._decode_fns[bucket], *args)
        out = logits.float().argmax(-1)
        for slot, _, seed, temp, top_k in entries:
            if temp > 0.0:
                # The sampled token lands at sequence index position + 1.
                out[slot] = _sample_row(logits[slot], temp, top_k, seed,
                                        int(positions[slot]) + 1)
        out = out.cpu().numpy()  # the step's one device -> host sync
        for slot in slots:
            self.pool.lengths[slot] += 1
        self.registry.counter("serving/decode_steps").inc()
        self.registry.counter("serving/decode_tokens").inc(len(entries))
        return {slot: int(out[slot]) for slot in slots}

    @torch.no_grad()
    def verify(self, entries):
        """One speculative decode step: score each request's launch token
        and its draft tokens in one verify forward and commit the longest
        agreeing prefix.

        ``entries``: (slot, input_token, draft_tokens, seed, temperature,
        top_k) per request; the input token sits at cache row
        ``pool.lengths[slot]``, the drafts at the rows after it. Returns
        {slot: committed tokens}, at least one a request (the token a plain
        decode step would have produced) and one more per accepted draft
        (``speculative.accept_drafts``). Row t of a request samples with
        the key of position ``pos + t + 1``, as a decode step there would;
        rejected rows are overwritten by later steps before they are read."""
        if not entries:
            return {}
        if not self._verify_fns:
            raise RuntimeError("verify() requires spec_decode_k > 0 (no verify rungs)")
        self._decode_fault_tick(entries)
        s = self.cfg.max_slots
        t_n = self.cfg.spec_decode_k + 1
        max_len = self.model_cfg.max_len
        tokens = np.zeros((s, t_n), np.int64)
        positions = np.zeros((s,), np.int64)
        slots, drafts_by_slot, limits = [], {}, {}
        for slot, token, drafts, _, _, _ in entries:
            pos = int(self.pool.lengths[slot])
            drafts = [int(d) for d in drafts][:self.cfg.spec_decode_k]
            tokens[slot, 0] = token
            tokens[slot, 1:1 + len(drafts)] = drafts
            positions[slot] = pos
            slots.append(slot)
            drafts_by_slot[slot] = drafts
            # Committed rows must have landed in the cache.
            limits[slot] = max_len - pos
        bucket = kv_mod.pick_bucket(self.kv_ladder,
                                    min(int(positions.max(initial=0)) + t_n, max_len))
        if self.paged:
            covered = self._grow(slots, {
                slot: (min(int(positions[slot]) + t_n - 1, max_len - 1), int(positions[slot]))
                for slot in slots})
            for slot in slots:
                limits[slot] = min(limits[slot], covered[slot] - int(positions[slot]))
            args = (tokens, positions, self._tables(slots, bucket))
        else:
            args = (tokens, positions)
        logits = self._run_compiled("verify", self._verify_fns[bucket], *args)
        greedy = logits.float().argmax(-1).cpu().numpy()  # [S, T]
        committed: dict[int, list[int]] = {}
        total = drafted = accepted = 0
        for slot, _, _, seed, temp, top_k in entries:
            drafts, pos = drafts_by_slot[slot], int(positions[slot])
            if temp > 0.0:
                # Sample row by row, only as far as the drafts agree:
                # acceptance never reads a row past the first rejection.
                sampled = []
                for t in range(t_n):
                    sampled.append(_sample_row(logits[slot, t], temp, top_k, seed, pos + t + 1))
                    if t >= len(drafts) or drafts[t] != sampled[t]:
                        break
            else:
                sampled = greedy[slot]
            toks = accept_drafts(drafts, sampled, limit=limits[slot])
            committed[slot] = toks
            self.pool.lengths[slot] += len(toks)
            total += len(toks)
            drafted += len(drafts)
            accepted += len(toks) - 1
        reg = self.registry
        reg.counter("serving/decode_steps").inc()
        reg.counter("serving/decode_tokens").inc(total)
        reg.counter("serving/spec_steps").inc()
        reg.counter("serving/spec_request_steps").inc(len(slots))
        reg.counter("serving/spec_drafted_total").inc(drafted)
        reg.counter("serving/spec_accepted_total").inc(accepted)
        return committed

    # ------------------------------------------------------- references

    @torch.no_grad()
    def reference_logits(self, tokens: Sequence[int]) -> torch.Tensor:
        """Last-position logits [V] of a cacheless plain forward of
        ``tokens`` (no buckets, no cache, no kernel; quantized weights
        dequantized as the serving path reads them)."""
        logits, _, _ = forward_full(self.model, self._t(np.asarray([list(tokens)], np.int64)),
                                    impl="xla")
        return logits[0, -1]

    def reference_generate(self, prompt: Sequence[int], *, max_new: int,
                           seed: int = 0, temperature: float = 0.0,
                           top_k: int = 0, eos_id: int | None = None) -> list[int]:
        """The unbatched, cacheless replay of one request: a full forward
        of the whole prefix per emitted token, sampling with the same
        (seed, position) noise. It shares no batching, bucketing or cache
        machinery with the serving path, which is what makes comparing
        the two meaningful."""
        toks = [int(t) for t in prompt]
        out: list[int] = []
        for _ in range(max_new):
            nxt = int(_sample_row(self.reference_logits(toks), temperature, top_k,
                                  seed, len(toks)))
            out.append(nxt)
            toks.append(nxt)
            if eos_id is not None and nxt == eos_id:
                break
        return out

    def reference_classify(self, prompt: Sequence[int], *, top_n: int = 5):
        return top_logprobs(self.reference_logits(prompt).cpu().numpy(), top_n)
