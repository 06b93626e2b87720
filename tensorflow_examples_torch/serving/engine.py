"""The serving step: bucketed prefill and fixed-shape continuous decode.

The port of ``tensorflow_examples_tpu/serving/engine.py``. The design is
the reference's:

* **Prefill** pads each prompt to the smallest power-of-two length bucket
  (``prefill_bucket_floor`` up to ``max_len``) and runs batch 1; causal
  masking makes the pad rows inert. Under ``attention="flash"`` its
  attention is ``ops/decode.flash_decode_attention`` with
  ``length = q_len = bucket``: a prefill is the single-length case of
  cache attention.
* **Decode** runs every one of the ``max_slots`` slots each step (slots
  not decoding ride along at position 0), over the KV cache cut to the
  smallest power-of-two bucket covering the longest active request. On
  the paged pool under ``attention="paged_flash"`` each layer's attention
  is the fused ``ops/paged_decode`` kernel reading K/V straight through
  the block tables (int8 pools dequantized in the kernel); otherwise the
  plain gather path.

PyTorch runs eagerly, so the reference's ahead-of-time ladder warmup and
recompile sentinel have no counterpart; the ladders stay because they
bound the work a step does. The reference donates the caches to each
compiled step and takes them back; here K/V writes happen in place
(``index_put_``) on the pool's tensors.

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
from typing import Sequence

import numpy as np
import torch

from tensorflow_examples_torch.core import rng
from tensorflow_examples_torch.core.device import resolve_device
from tensorflow_examples_torch.core.precision import (
    dequantize_int8_rows,
    quantize_int8_rows,
)
from tensorflow_examples_torch.models.convert import model_from_params
from tensorflow_examples_torch.models.transformer import (
    GPT2,
    TransformerConfig,
    _attn_out,
    _block_mlp,
    _embed,
    _layer_norm,
    _qkv,
)
from tensorflow_examples_torch.ops.attention import (
    NEG_INF,
    SUPPORTED_HEAD_DIMS,
    attention_reference,
)
from tensorflow_examples_torch.ops.decode import flash_decode_attention
from tensorflow_examples_torch.ops.paged_decode import paged_decode_attention
from tensorflow_examples_torch.serving import kv_cache as kv_mod
from tensorflow_examples_torch.serving import paged_kv
from tensorflow_examples_torch.telemetry import registry as registry_mod

ATTENTION_IMPLS = ("xla", "flash", "paged_flash")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine and batcher knobs (the reference's fields this port uses)."""

    max_slots: int = 8           # concurrent requests = decode batch
    prefill_bucket_floor: int = 16
    kv_bucket_floor: int = 64
    attention: str = "xla"       # xla (plain torch) | flash (flash-decode
    #                              kernel for prefill) | paged_flash (fused
    #                              paged-decode kernel; needs the paged pool)
    kv_block_size: int = 0       # 0 -> dense pool; else paged, a power of
    #                              two dividing both floors and max_len
    kv_blocks: int = 0           # physical blocks; 0 -> dense worst case
    kv_dtype: str = ""           # "" (params dtype) | "int8"
    prefix_cache: bool = True    # reuse immutable full prompt blocks
    max_batch: int = 0           # admission cap; 0 -> max_slots
    max_queue: int = 64          # bounded queue: beyond this, load-shed
    max_delay_s: float = 0.002   # idle coalescing window before first prefill
    request_timeout_s: float = 120.0


# --------------------------------------------------------------- forward
#
# The layer math is the model's (``models/transformer.py``); f32 like the
# reference.


def _prefill_attend(q, k, v, *, impl: str):
    """Causal self-attention for prefill, [B, L, H, hd] layout."""
    swap = lambda t: t.transpose(1, 2).contiguous()  # [B,L,H,D] -> [B,H,L,D]
    if impl == "flash":
        out = flash_decode_attention(swap(q), swap(k), swap(v), q.shape[1])
    else:
        out = attention_reference(swap(q), swap(k), swap(v), causal=True)
    return out.transpose(1, 2)


def forward_full(model: GPT2, tokens: torch.Tensor, *, impl: str = "xla"):
    """Full causal forward of ``tokens`` [B, L]: logits [B, L, V] plus the
    per-layer K/V ([num_layers, B, L, H, hd] each) a prefill writes into
    the cache. Also the cacheless reference path."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(model, tokens, positions[None])
    ks, vs = [], []
    for layer in range(model.cfg.num_layers):
        blk = model.block(layer)
        q, k, v = _qkv(_layer_norm(x, blk.ln_1), blk.attn)
        ks.append(k)
        vs.append(v)
        x = x + _attn_out(_prefill_attend(q, k, v, impl=impl), blk.attn)
        x = x + _block_mlp(_layer_norm(x, blk.ln_2), blk)
    x = _layer_norm(x, model.ln_f)
    return x @ model.wte.embedding.T, torch.stack(ks), torch.stack(vs)


def _decode_forward(model: GPT2, k_cache, v_cache, tokens, positions, *,
                    kv_bucket: int):
    """One continuous-decode step over every slot of the dense pool.

    tokens/positions: [S]; each slot's input token and the cache row it
    occupies (= its populated length before the step). Writes K/V in
    place and returns next-token logits [S, V]."""
    x = _embed(model, tokens, positions)
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
        x = x + _attn_out(att, blk.attn)
        x = x + _block_mlp(_layer_norm(x, blk.ln_2), blk)
    x = _layer_norm(x, model.ln_f)
    return x @ model.wte.embedding.T


# ---------------------------------------------------------- paged forward
#
# K/V live in [L, NB, H, BS, D] block pools addressed through per-slot
# block tables. ``kv`` is the pool's tensor tuple: (k, v) or, int8,
# (k, v, k_scale, v_scale) with per-row scales stored blockwise.


def _paged_write_prompt(kv, ks, vs, block_ids, *, block_size):
    """Scatter a prefill's K/V ([L, bucket, H, hd]) into the blocks named
    by ``block_ids`` [bucket // BS] (pad entries name the null block)."""
    num_layers, bucket, h, hd = ks.shape
    nb = bucket // block_size

    def to_blocks(x):  # [L, bucket, H, hd] -> [L, nb, H, BS, hd]
        return x.reshape(num_layers, nb, block_size, h, hd).permute(0, 1, 3, 2, 4)

    kb, vb = to_blocks(ks), to_blocks(vs)
    if len(kv) == 4:
        k, v, ksc, vsc = kv
        qk, sk = quantize_int8_rows(kb)
        qv, sv = quantize_int8_rows(vb)
        k[:, block_ids] = qk
        v[:, block_ids] = qv
        ksc[:, block_ids] = sk
        vsc[:, block_ids] = sv
    else:
        k, v = kv
        k[:, block_ids] = kb.to(k.dtype)
        v[:, block_ids] = vb.to(v.dtype)


def _paged_write_rows(kv, layer, write_blocks, offsets, k, v):
    """One decode step's per-slot rows ([S, H, hd]) into block
    ``write_blocks[s]`` at row ``offsets[s]``."""
    if len(kv) == 4:
        kk, vv, ksc, vsc = kv
        qk, sk = quantize_int8_rows(k)
        qv, sv = quantize_int8_rows(v)
        kk[layer, write_blocks, :, offsets, :] = qk
        vv[layer, write_blocks, :, offsets, :] = qv
        ksc[layer, write_blocks, :, offsets] = sk
        vsc[layer, write_blocks, :, offsets] = sv
    else:
        kk, vv = kv
        kk[layer, write_blocks, :, offsets, :] = k.to(kk.dtype)
        vv[layer, write_blocks, :, offsets, :] = v.to(vv.dtype)


def _paged_gather_dequant(kv, layer, tables, dtype):
    """int8 gather path: blocks and scales by table, dequantized ->
    (k, v) [S, H, nb*BS, D]."""
    k, v, ksc, vsc = kv
    s, nb = tables.shape
    _, _, h, bs, d = k.shape

    def gather(blocks, scales):
        g = dequantize_int8_rows(blocks[layer][tables], scales[layer][tables], dtype)
        return g.transpose(1, 2).reshape(s, h, nb * bs, d)

    return gather(k, ksc), gather(v, vsc)


def _paged_decode_forward(model: GPT2, kv, tokens, positions, tables, *,
                          block_size: int, attention: str = "xla"):
    """The paged twin of :func:`_decode_forward`: writes route through
    the block table; attention is the fused kernel under
    ``attention="paged_flash"``, else the plain gather path. ``tables``
    is [S, nb] int32 on the device. Returns logits [S, V]."""
    x = _embed(model, tokens, positions)
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
        x = x + _attn_out(att, blk.attn)
        x = x + _block_mlp(_layer_norm(x, blk.ln_2), blk)
    x = _layer_norm(x, model.ln_f)
    return x @ model.wte.embedding.T


def _extend_forward(model: GPT2, kv, ctx_table, tail_ids, tokens, ctx_len: int,
                    *, block_size: int):
    """Prefill on top of a cached context (the prefix-hit path): run only
    the prompt tail ``tokens`` [1, tb] at positions ``ctx_len + i``; each
    tail row attends (a) the cached context gathered by ``ctx_table``
    [max_blocks], masked to ``ctx_len`` columns, and (b) the tail itself,
    causally. Tail K/V is written into ``tail_ids`` [tb // BS] after the
    last layer. Numerics mirror ``varlen_decode_attention``. Returns
    logits [1, tb, V]."""
    cfg = model.cfg
    dev = tokens.device
    tb = tokens.shape[1]
    hd = cfg.head_dim
    sm_scale = hd ** -0.5
    positions = ctx_len + torch.arange(tb, device=dev)
    # Pad rows past the true tail may index past max_len; clip — they are
    # causally downstream of every real row and discarded.
    x = _embed(model, tokens, positions.clamp(max=cfg.max_len - 1)[None])
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
            kc = dequantize_int8_rows(kv[0][layer][ctx_table], kv[2][layer][ctx_table], q.dtype)
            vc = dequantize_int8_rows(kv[1][layer][ctx_table], kv[3][layer][ctx_table], q.dtype)
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
        x = x + _attn_out(att, blk.attn)
        x = x + _block_mlp(_layer_norm(x, blk.ln_2), blk)
    x = _layer_norm(x, model.ln_f)
    _paged_write_prompt(kv, torch.stack(ks), torch.stack(vs), tail_ids,
                        block_size=block_size)
    return x @ model.wte.embedding.T


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


# ---------------------------------------------------------------- engine


class InferenceEngine:
    """Holds the model and the KV pool, runs prefill and decode steps.

    ``params`` is a :class:`GPT2` module or a JAX-layout param tree
    (``models/convert.py``). ``device`` defaults to ``cuda`` and raises
    when no GPU is visible; pass ``device="cpu"`` for the CPU, where each
    kernel wrapper takes its plain version. ``prefill``/``decode`` are
    single-threaded by contract: the batcher's loop thread is the only
    caller."""

    def __init__(self, model_cfg: TransformerConfig, params, *,
                 cfg: ServeConfig | None = None, registry=None, device=None):
        if model_cfg.moe_experts:
            raise NotImplementedError("serving engine currently covers dense GPT-2 models only")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # The reference computes in f32. TF32 matmuls keep ~3 decimal
            # digits, enough to flip greedy tokens away from it.
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model_cfg = model_cfg
        self.cfg = cfg = cfg or ServeConfig()
        if cfg.attention not in ATTENTION_IMPLS:
            raise ValueError(f"ServeConfig.attention={cfg.attention!r} not in {ATTENTION_IMPLS}")
        # Prefill always runs the full-prompt causal forward; the paged
        # kernel exists only for the per-slot decode step.
        self._prefill_attn = "flash" if cfg.attention == "flash" else "xla"
        self.paged = cfg.kv_block_size > 0
        if cfg.attention == "paged_flash" and not self.paged:
            raise ValueError("attention='paged_flash' is the fused paged-decode "
                             "kernel — it requires the paged pool (set kv_block_size)")
        if cfg.kv_dtype and not self.paged:
            raise ValueError("kv_dtype (quantized KV) requires the paged pool — "
                             "set kv_block_size")
        if (self.device.type == "cuda" and cfg.attention != "xla"
                and model_cfg.head_dim not in SUPPORTED_HEAD_DIMS):
            raise ValueError(f"attention={cfg.attention!r} kernels take head_dim in "
                             f"{SUPPORTED_HEAD_DIMS}, the model has {model_cfg.head_dim}")
        if isinstance(params, GPT2):
            model = params.to(self.device)
        else:
            model = model_from_params(model_cfg, params, device=self.device)
        self.model = model.requires_grad_(False).eval()
        self.registry = registry if registry is not None else registry_mod.default_registry()
        pool_kw = dict(
            num_layers=model_cfg.num_layers, num_slots=cfg.max_slots,
            num_heads=model_cfg.num_heads, max_len=model_cfg.max_len,
            head_dim=model_cfg.head_dim, dtype=self.model.wte.embedding.dtype,
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
                block_size=bs, num_blocks=cfg.kv_blocks, kv_dtype=cfg.kv_dtype,
                prefix_cache=cfg.prefix_cache, **pool_kw,
            )
        else:
            self.pool = kv_mod.KVCachePool(**pool_kw)
        self.prefill_ladder = kv_mod.bucket_ladder(cfg.prefill_bucket_floor, model_cfg.max_len)
        self.kv_ladder = kv_mod.bucket_ladder(cfg.kv_bucket_floor, model_cfg.max_len)

    def _tokens(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

    # ------------------------------------------------------ request ops

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
        if self.paged:
            last = self._paged_prefill(slot, prompt)
        else:
            bucket = kv_mod.pick_bucket(self.prefill_ladder, n)
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :n] = prompt
            logits, ks, vs = forward_full(self.model, self._tokens(tokens),
                                          impl=self._prefill_attn)
            # [L, 1, bucket, H, hd] -> the slot's [L, H, bucket, hd] rows.
            self.pool.k[:, slot, :, :bucket] = ks[:, 0].transpose(1, 2).to(self.pool.k.dtype)
            self.pool.v[:, slot, :, :bucket] = vs[:, 0].transpose(1, 2).to(self.pool.v.dtype)
            last = logits[0, n - 1]
        tok = _sample_row(last, temperature, top_k, seed, n)
        self.pool.lengths[slot] = n
        self.registry.counter("serving/prefill_tokens").inc(n)
        return int(tok), last.cpu().numpy()

    def _paged_prefill(self, slot, prompt) -> torch.Tensor:
        n = len(prompt)
        bs = self.cfg.kv_block_size
        ctx, _ = self.pool.claim_prompt_blocks(slot, prompt)
        total_blocks = -(-n // bs)
        kv = self.pool.kv_state()
        if ctx == 0:
            bucket = kv_mod.pick_bucket(self.prefill_ladder, n)
            ids = np.zeros((bucket // bs,), np.int64)
            ids[:total_blocks] = self.pool.block_tables[slot, :total_blocks]
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :n] = prompt
            logits, ks, vs = forward_full(self.model, self._tokens(tokens),
                                          impl=self._prefill_attn)
            _paged_write_prompt(kv, ks[:, 0], vs[:, 0], self._tokens(ids), block_size=bs)
            last = logits[0, n - 1]
        else:
            tail = n - ctx
            tb = kv_mod.pick_bucket(self.prefill_ladder, tail)
            tail_ids = np.zeros((tb // bs,), np.int64)
            tail_ids[:total_blocks - ctx // bs] = self.pool.block_tables[slot, ctx // bs:total_blocks]
            tokens = np.zeros((1, tb), np.int64)
            tokens[0, :tail] = prompt[ctx:]
            logits = _extend_forward(
                self.model, kv, self._tokens(self.pool.block_tables[slot]),
                self._tokens(tail_ids), self._tokens(tokens), ctx, block_size=bs,
            )
            last = logits[0, tail - 1]
            self.registry.counter("serving/prefix_reused_tokens").inc(ctx)
        self.pool.insert_prefix(slot, prompt)
        return last

    @torch.no_grad()
    def decode(self, entries: Sequence[tuple[int, int, int, float, int]]):
        """One continuous-decode step. ``entries``: (slot, input_token,
        seed, temperature, top_k) per active request; each input token
        sits at cache row ``pool.lengths[slot]``. Returns {slot: token}."""
        if not entries:
            return {}
        s = self.cfg.max_slots
        tokens = np.zeros((s,), np.int64)
        positions = np.zeros((s,), np.int64)
        for slot, token, _, _, _ in entries:
            tokens[slot] = token
            positions[slot] = int(self.pool.lengths[slot])
        bucket = kv_mod.pick_bucket(self.kv_ladder, int(positions.max(initial=0)) + 1)
        tok_t, pos_t = self._tokens(tokens), self._tokens(positions)
        if self.paged:
            # Grow block tables BEFORE the device step: only the requests
            # that could not grow fail; the rest keep serving.
            exhausted = []
            for slot, *_ in entries:
                try:
                    self.pool.ensure_position(slot, int(positions[slot]))
                except paged_kv.BlockExhausted:
                    exhausted.append(slot)
            if exhausted:
                raise paged_kv.BlockExhausted(
                    f"KV block pool exhausted mid-decode for slot(s) {exhausted}; "
                    "pool is serving at capacity", slots=tuple(exhausted),
                )
            bs = self.cfg.kv_block_size
            tables = torch.as_tensor(
                np.ascontiguousarray(self.pool.block_tables[:, :bucket // bs]),
                device=self.device,
            )
            logits = _paged_decode_forward(
                self.model, self.pool.kv_state(), tok_t, pos_t, tables,
                block_size=bs, attention=self.cfg.attention,
            )
        else:
            logits = _decode_forward(self.model, self.pool.k, self.pool.v,
                                     tok_t, pos_t, kv_bucket=bucket)
        out = logits.float().argmax(-1)
        for slot, _, seed, temp, top_k in entries:
            if temp > 0.0:
                # The sampled token lands at sequence index position + 1.
                out[slot] = _sample_row(logits[slot], temp, top_k, seed,
                                        int(positions[slot]) + 1)
        out = out.cpu().numpy()  # the step's one device -> host sync
        for slot, *_ in entries:
            self.pool.lengths[slot] += 1
        self.registry.counter("serving/decode_steps").inc()
        self.registry.counter("serving/decode_tokens").inc(len(entries))
        return {slot: int(out[slot]) for slot, *_ in entries}

    # ------------------------------------------------------- references

    @torch.no_grad()
    def reference_logits(self, tokens: Sequence[int]) -> torch.Tensor:
        """Last-position logits [V] of a cacheless plain forward of
        ``tokens`` (no buckets, no cache, no kernel)."""
        logits, _, _ = forward_full(self.model, self._tokens([list(tokens)]), impl="xla")
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
