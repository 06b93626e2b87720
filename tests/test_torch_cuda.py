"""The port's CUDA kernels against their plain PyTorch versions, on the
card (PyTorch/CUDA port).

Every test here carries the ``cuda`` marker and skips where no GPU is
visible. The file imports no jax, so it also runs on a machine without
it; ``tests/conftest.py`` does import jax, hence on the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances are the JAX suite's for the same kernels: atol 2e-5 for f32
flash-decode and flash forward, 2e-2 for bf16, 5e-4 for f32 flash
gradients (bf16: 5e-2 of the largest gradient, since the tensor-core
backward rounds p and ds to bf16 for its products), 2e-6 for paged
decode (fp32 and int8), the same at every
head_dim the attention kernels take; for the fused
cross-entropy kernels 1e-5 (f32) and 2e-2 (bf16) on the NLL and lse,
and on dlogits 1e-6 (f32) or one bf16 ulp, 8e-3 relative, of each
value (bf16); for the grouped-matmul kernels and the MoE bias gathers'
segmented sum (``group_row_sum``) 1e-4 of the largest value (f32), plus
one bf16 rounding of each value (bf16).
"""

import time

import numpy as np
import pytest
import torch

from tensorflow_examples_torch.core import precision
from tensorflow_examples_torch.ops import (
    attention, cross_entropy, decode, grouped_matmul, paged_decode)

pytestmark = pytest.mark.cuda
HEAD_DIMS = attention.SUPPORTED_HEAD_DIMS
UNSUPPORTED_HEAD_DIM = 48


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _randn(rng, shape, dev, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("q_len,max_len,length", [(100, 100, 100), (1, 1024, 300), (70, 512, 200)])
def test_flash_decode_matches_plain(dev, dtype, atol, q_len, max_len, length):
    rng = np.random.default_rng(q_len + length)
    q = _randn(rng, (2, 12, q_len, 64), dev, dtype)
    k, v = (_randn(rng, (2, 12, max_len, 64), dev, dtype) for _ in range(2))
    before = decode.flash_decode_attention.launches
    out = decode.flash_decode_attention(q, k, v, length)
    assert decode.flash_decode_attention.launches == before + 1
    ref = decode.decode_attention_reference(q, k, v, length)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_matches_plain(dev, quantized):
    rng = np.random.default_rng(7)
    lengths = torch.tensor([0, 1, 16, 17, 40], dtype=torch.int32, device=dev)
    tables = torch.tensor([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 4, 0], [5, 6, 7]],
                          dtype=torch.int32, device=dev)
    q = _randn(rng, (5, 12, 64), dev)
    kb, vb = (_randn(rng, (8, 12, 16, 64), dev) for _ in range(2))
    kw = {}
    if quantized:
        (kb, ks), (vb, vs) = precision.quantize_int8_rows(kb), precision.quantize_int8_rows(vb)
        kw = {"k_scale": ks, "v_scale": vs}
    out = paged_decode.paged_decode_attention(q, kb, vb, lengths, tables, **kw)
    ref = paged_decode.paged_decode_reference(q, kb, vb, lengths, tables, **kw)
    torch.testing.assert_close(out[1:], ref[1:], atol=2e-6, rtol=2e-6)
    assert float(out[0].abs().max()) == 0.0  # an empty slot writes zeros


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_flash_decode_matches_plain_at_every_head_dim(dev, dtype, atol, head_dim):
    rng = np.random.default_rng(head_dim)
    q = _randn(rng, (2, 3, 70, head_dim), dev, dtype)
    k, v = (_randn(rng, (2, 3, 300, head_dim), dev, dtype) for _ in range(2))
    out = decode.flash_decode_attention(q, k, v, 200)
    ref = decode.decode_attention_reference(q, k, v, 200)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("head_dim,block_size", [(d, 16) for d in HEAD_DIMS] + [(128, 64)])
def test_paged_decode_matches_plain_at_every_head_dim(dev, quantized, head_dim, block_size):
    """Block 64 at head_dim 128: two blocks a split."""
    rng = np.random.default_rng(head_dim + block_size)
    lengths = torch.tensor([0, 1, block_size, 3 * block_size - 5], dtype=torch.int32, device=dev)
    tables = torch.tensor([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 4, 5]], dtype=torch.int32,
                          device=dev)
    q = _randn(rng, (4, 3, head_dim), dev)
    kb, vb = (_randn(rng, (6, 3, block_size, head_dim), dev) for _ in range(2))
    kw = {}
    if quantized:
        (kb, ks), (vb, vs) = precision.quantize_int8_rows(kb), precision.quantize_int8_rows(vb)
        kw = {"k_scale": ks, "v_scale": vs}
    out = paged_decode.paged_decode_attention(q, kb, vb, lengths, tables, **kw)
    ref = paged_decode.paged_decode_reference(q, kb, vb, lengths, tables, **kw)
    torch.testing.assert_close(out[1:], ref[1:], atol=2e-6, rtol=2e-6)
    assert float(out[0].abs().max()) == 0.0


def test_kernels_refuse_what_they_cannot_launch(dev):
    q = torch.zeros(1, 2, 4, UNSUPPORTED_HEAD_DIM, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        decode.flash_decode_attention(q, q, q, 4)
    q = torch.zeros(1, 2, 4, 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        decode.flash_decode_attention(q, q.transpose(2, 3).contiguous().transpose(2, 3), q, 4)


def _decode_counts():
    fn = decode.flash_decode_attention
    return fn.launches, fn.tensor_core_launches, fn.simt_launches, fn.split_launches


# Shapes where the plan splits the KV walk: generate's q_len=1 steps into
# a longer cache, and a short bucket over a long cache.
DECODE_SPLIT_CASES = [(1, 1024, 300), (1, 1024, 1024), (16, 1024, 1024)]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("q_len,max_len,length", DECODE_SPLIT_CASES)
def test_flash_decode_split_route_matches_plain(dev, dtype, atol, q_len, max_len, length):
    """The split route: one launch counted as a split, on the variant
    the plan names, equal to the plain version; the cache past `length`
    is NaN and must never be read."""
    rng = np.random.default_rng(length + q_len)
    q = _randn(rng, (1, 12, q_len, 64), dev, dtype)
    k, v = (_randn(rng, (1, 12, max_len, 64), dev, dtype) for _ in range(2))
    k[:, :, length:] = float("nan")
    v[:, :, length:] = float("nan")
    plan = decode.decode_plan(dtype, q_len, length, max_len, 12, 64)
    assert plan.splits > 1
    n, tc, simt, split = _decode_counts()
    out = decode.flash_decode_attention(q, k, v, length)
    tensor_cores = plan.route == "tensor_core"
    assert _decode_counts() == (n + 1, tc + tensor_cores, simt + (not tensor_cores), split + 1)
    assert tensor_cores == (dtype == torch.bfloat16)
    ref = decode.decode_attention_reference(q, k[:, :, :length], v[:, :, :length], length)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("q_len", [64, 100, 512])
def test_flash_decode_bf16_takes_the_tensor_cores(dev, q_len, head_dim):
    """bf16 at q_len >= 64 runs on the tensor cores from head_dim 16 (SIMT
    at 8, under the mma's k16 depth), at every head_dim within 2e-2."""
    rng = np.random.default_rng(q_len + head_dim)
    q, k, v = (_randn(rng, (1, 12, q_len, head_dim), dev, torch.bfloat16) for _ in range(3))
    n, tc, simt, split = _decode_counts()
    out = decode.flash_decode_attention(q, k, v, q_len)
    tensor_cores = head_dim >= 16
    plan = decode.decode_plan(torch.bfloat16, q_len, q_len, q_len, 12, head_dim)
    assert _decode_counts() == (n + 1, tc + tensor_cores, simt + (not tensor_cores),
                                split + (plan.splits > 1))
    ref = decode.decode_attention_reference(q, k, v, q_len)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_len,max_len,length",
                         [(1, 1024, 300), (512, 512, 512), (1024, 1024, 1024)])
def test_flash_decode_reruns_are_bit_identical(dev, dtype, q_len, max_len, length):
    """No atomics on either route, split or not: the same inputs give the
    same bits on every call."""
    rng = np.random.default_rng(q_len)
    q = _randn(rng, (1, 12, q_len, 64), dev, dtype)
    k, v = (_randn(rng, (1, 12, max_len, 64), dev, dtype) for _ in range(2))
    first = decode.flash_decode_attention(q, k, v, length)
    for _ in range(3):
        assert torch.equal(first, decode.flash_decode_attention(q, k, v, length))


def _full_pool(dev, quantized, s=8, h=12, bs=16, nb=64, seed=11):
    """Every slot at nb * bs rows, blocks in a shuffled order, block 0 unused."""
    rng = np.random.default_rng(seed)
    tables = torch.from_numpy(rng.permutation(s * nb).reshape(s, nb) + 1).int().to(dev)
    lengths = torch.full((s,), nb * bs, dtype=torch.int32, device=dev)
    q = _randn(rng, (s, h, 64), dev)
    kb, vb = (_randn(rng, (s * nb + 1, h, bs, 64), dev) for _ in range(2))
    kw = {}
    if quantized:
        (kb, ks), (vb, vs) = precision.quantize_int8_rows(kb), precision.quantize_int8_rows(vb)
        kw = {"k_scale": ks, "v_scale": vs}
    return q, kb, vb, lengths, tables, kw


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_full_cache_splits_and_matches_plain(dev, quantized):
    """Every slot at 1024 rows: the table's 64 blocks go to 8 splits, and
    one launch is counted as a split."""
    q, kb, vb, lengths, tables, kw = _full_pool(dev, quantized)
    assert paged_decode.paged_plan(16, 64) == (8, 8)
    fn = paged_decode.paged_decode_attention
    n, split = fn.launches, fn.split_launches
    out = fn(q, kb, vb, lengths, tables, **kw)
    assert (fn.launches, fn.split_launches) == (n + 1, split + 1)
    ref = paged_decode.paged_decode_reference(q, kb, vb, lengths, tables, **kw)
    torch.testing.assert_close(out, ref, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_reruns_are_bit_identical(dev, quantized):
    q, kb, vb, lengths, tables, kw = _full_pool(dev, quantized, seed=12)
    lengths[:4] = torch.tensor([0, 1, 129, 700], dtype=torch.int32, device=dev)
    first = paged_decode.paged_decode_attention(q, kb, vb, lengths, tables, **kw)
    assert float(first[0].abs().max()) == 0.0
    for _ in range(3):
        assert torch.equal(first, paged_decode.paged_decode_attention(q, kb, vb, lengths, tables,
                                                                      **kw))


@pytest.mark.parametrize("attention_impl,kernel", [("flash", "flash_decode"),
                                                   ("paged_flash", "paged_decode")])
@pytest.mark.parametrize("head_dim", [*HEAD_DIMS, UNSUPPORTED_HEAD_DIM])
def test_engine_serves_every_supported_head_dim(dev, attention_impl, kernel, head_dim):
    """A two-layer model of two heads of head_dim D through the serving
    engine's kernel path: the greedy stream equals the cacheless plain
    replay; an unsupported head_dim is refused when the engine is built."""
    from tensorflow_examples_torch.models import transformer
    from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig

    cfg = transformer.TransformerConfig(vocab_size=64, max_len=128, num_layers=2, num_heads=2,
                                        d_model=2 * head_dim, dropout=0.0)
    model = transformer.GPT2(cfg, seed=head_dim)
    serve_cfg = ServeConfig(max_slots=2, attention=attention_impl,
                            kv_block_size=16 if attention_impl == "paged_flash" else 0)
    if head_dim not in HEAD_DIMS:
        with pytest.raises(ValueError, match="head_dim"):
            InferenceEngine(cfg, model, cfg=serve_cfg)
        return
    engine = InferenceEngine(cfg, model, cfg=serve_cfg)
    counter = {"flash_decode": decode.flash_decode_attention,
               "paged_decode": paged_decode.paged_decode_attention}[kernel]
    before = counter.launches
    prompt = [int(t) for t in np.random.default_rng(head_dim).integers(0, 64, 21)]
    tok, logits = engine.prefill(0, prompt)
    np.testing.assert_allclose(logits, engine.reference_logits(prompt).cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    toks = [tok]
    for _ in range(7):
        toks.append(engine.decode([(0, toks[-1], 0, 0.0, 0)])[0])
    assert counter.launches > before
    assert toks == engine.reference_generate(prompt, max_new=8)


# ------------------------------------------------- flash attention (training)

FLASH_CASES = [  # (seq_q, seq_kv, causal, key bias)
    (128, 128, True, None),
    (128, 128, False, None),
    (100, 260, True, None),        # seq_q < seq_kv, neither a tile multiple
    (77, 77, True, None),
    (96, 160, False, -1e9),        # masked keys through the bias
    (64, 192, True, attention.NEG_INF),
]


def _flash_inputs(dev, dtype, seq_q, seq_kv, bias, seed=0, head_dim=64):
    rng = np.random.default_rng(seed)
    b, h = 2, 3
    q = _randn(rng, (b * h, seq_q, head_dim), dev, dtype)
    k, v, do = (_randn(rng, (b * h, n, head_dim), dev, dtype) for n in (seq_kv, seq_kv, seq_q))
    kb = None
    if bias is not None:
        kb = torch.zeros(b, seq_kv, device=dev)
        kb[0, seq_kv // 3:] = bias
    dlse = _randn(rng, (b * h, seq_q), dev)
    return h, q, k, v, do, kb, dlse


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("seq_q,seq_kv,causal,bias", FLASH_CASES)
def test_flash_kernels_match_plain(dev, dtype, atol, seq_q, seq_kv, causal, bias):
    _check_flash_kernels(dev, dtype, atol, seq_q, seq_kv, causal, bias, head_dim=64)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("seq_q,seq_kv,causal,bias", [(100, 260, True, None),
                                                      (96, 160, False, -1e9)])
def test_flash_kernels_match_plain_at_every_head_dim(dev, dtype, atol, head_dim, seq_q, seq_kv,
                                                     causal, bias):
    _check_flash_kernels(dev, dtype, atol, seq_q, seq_kv, causal, bias, head_dim=head_dim)


def _check_flash_kernels(dev, dtype, atol, seq_q, seq_kv, causal, bias, *, head_dim):
    h, q, k, v, do, kb, dlse = _flash_inputs(dev, dtype, seq_q, seq_kv, bias, head_dim=head_dim)
    sm_scale = head_dim ** -0.5
    kw = dict(heads=h, causal=causal)
    counts = [f.launches for f in (attention.flash_fwd, attention.flash_bwd_dkv,
                                   attention.flash_bwd_dq)]
    o, lse = attention.flash_fwd(q, k, v, kb, **kw)
    o_ref, lse_ref = attention.flash_fwd_plain(q, k, v, kb, sm_scale=sm_scale, **kw)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=atol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, dlse, kb)
    dk, dv = attention.flash_bwd_dkv(*args, **kw)
    dq = attention.flash_bwd_dq(*args, **kw)
    ref = (*attention.flash_bwd_dkv_plain(*args, sm_scale=sm_scale, **kw),
           attention.flash_bwd_dq_plain(*args, sm_scale=sm_scale, **kw))
    grad_tol = 5e-4 if dtype == torch.float32 else 5e-2
    for name, a, b in zip(("dk", "dv", "dq"), (dk, dv, dq), ref):
        scale = max(float(b.float().abs().max()), 1.0)
        torch.testing.assert_close(a.float() / scale, b.float() / scale, atol=grad_tol,
                                   rtol=grad_tol, msg=name)
    assert [f.launches for f in (attention.flash_fwd, attention.flash_bwd_dkv,
                                 attention.flash_bwd_dq)] == [c + 1 for c in counts]


def test_flash_attention_grads_match_autograd_reference(dev):
    rng = np.random.default_rng(3)
    q, k, v = (_randn(rng, (2, 3, 200, 64), dev).requires_grad_() for _ in range(3))
    g = [torch.autograd.grad((f(q, k, v) ** 2).sum(), (q, k, v))
         for f in (attention.flash_attention, attention.attention_reference)]
    for a, b in zip(*g):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-4)


def test_flash_row_with_no_visible_key_is_zero(dev):
    """Below the public check (causal needs seq_q <= seq_kv): rows that
    see no key write 0 and lse ~ -1e30, never NaN."""
    rng = np.random.default_rng(5)
    q = _randn(rng, (2, 80, 64), dev)
    k, v = _randn(rng, (2, 30, 64), dev), _randn(rng, (2, 30, 64), dev)
    o, lse = attention.flash_fwd(q, k, v, causal=True)
    assert torch.isfinite(o).all() and float(o[:, :50].abs().max()) == 0.0
    assert float(lse[:, :50].max()) <= -1e29
    o_ref, _ = attention.flash_fwd_plain(q, k, v, None, heads=1, causal=True, sm_scale=0.125)
    torch.testing.assert_close(o, o_ref, atol=2e-5, rtol=2e-5)


def test_flash_bf16_row_with_no_visible_key_is_zero(dev):
    """The tensor-core forward: rows that see no key write 0 and lse
    ~ -1e30, never NaN."""
    rng = np.random.default_rng(6)
    q = _randn(rng, (2, 80, 64), dev, torch.bfloat16)
    k, v = (_randn(rng, (2, 30, 64), dev, torch.bfloat16) for _ in range(2))
    o, lse = attention.flash_fwd(q, k, v, causal=True)
    assert torch.isfinite(o.float()).all() and float(o[:, :50].float().abs().max()) == 0.0
    assert float(lse[:, :50].max()) <= -1e29
    o_ref, lse_ref = attention.flash_fwd_plain(q, k, v, None, heads=1, causal=True,
                                               sm_scale=0.125)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse[:, 50:], lse_ref[:, 50:], atol=1e-4, rtol=1e-5)


FLASH_KERNELS = (attention.flash_fwd, attention.flash_bwd_dkv, attention.flash_bwd_dq)
TENSOR_CORE_HEAD_DIMS = [d for d in HEAD_DIMS if attention.uses_tensor_cores(torch.bfloat16, d)]


def _variant_counts():
    return [(f.tensor_core_launches, f.simt_launches) for f in FLASH_KERNELS]


@pytest.mark.parametrize("head_dim", TENSOR_CORE_HEAD_DIMS)
@pytest.mark.parametrize("seq_q,seq_kv,causal,bias", FLASH_CASES)
def test_tensor_core_backward_matches_plain(dev, head_dim, seq_q, seq_kv, causal, bias):
    """bf16 dK/dV and dQ on the tensor cores at every head_dim they take,
    over every flash case, within 5e-2 of the largest gradient (p and ds
    are rounded to bf16 for their products); all three launches take the
    tensor-core variant."""
    before = _variant_counts()
    _check_flash_kernels(dev, torch.bfloat16, 2e-2, seq_q, seq_kv, causal, bias,
                         head_dim=head_dim)
    assert _variant_counts() == [(tc + 1, simt) for tc, simt in before]


@pytest.mark.parametrize("head_dim", TENSOR_CORE_HEAD_DIMS)
def test_tensor_core_backward_row_with_no_visible_key(dev, head_dim):
    """Below the public check (causal with seq_q 80 > seq_kv 30): query
    rows 0-49 see no key, so their dQ is exactly 0 and they add nothing to
    dK and dV; every value is finite and the rest matches the plain
    versions."""
    rng = np.random.default_rng(head_dim + 5)
    q, do = (_randn(rng, (2, 80, head_dim), dev, torch.bfloat16) for _ in range(2))
    k, v = (_randn(rng, (2, 30, head_dim), dev, torch.bfloat16) for _ in range(2))
    dlse = _randn(rng, (2, 80), dev)
    o, lse = attention.flash_fwd(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, dlse, None)
    kw = dict(heads=1, causal=True, sm_scale=head_dim ** -0.5)
    dk, dv = attention.flash_bwd_dkv(*args, **kw)
    dq = attention.flash_bwd_dq(*args, **kw)
    assert all(torch.isfinite(t.float()).all() for t in (dk, dv, dq))
    assert float(dq[:, :50].float().abs().max()) == 0.0
    ref = (*attention.flash_bwd_dkv_plain(*args, **kw), attention.flash_bwd_dq_plain(*args, **kw))
    for name, a, b in zip(("dk", "dv", "dq"), (dk, dv, dq), ref):
        scale = max(float(b.float().abs().max()), 1.0)
        torch.testing.assert_close(a.float() / scale, b.float() / scale, atol=5e-2, rtol=5e-2,
                                   msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_flash_variant_follows_dtype_and_head_dim(dev, dtype, head_dim):
    """bf16 at head_dim 16-128 takes the tensor-core variant of all three
    flash kernels; f32, and bf16 at head_dim 8, the SIMT one."""
    tensor_cores = dtype == torch.bfloat16 and head_dim >= 16
    assert attention.uses_tensor_cores(dtype, head_dim) == tensor_cores
    h, q, k, v, do, kb, dlse = _flash_inputs(dev, dtype, 100, 260, None, head_dim=head_dim)
    before = _variant_counts()
    o, lse = attention.flash_fwd(q, k, v, heads=h)
    delta = (do.float() * o.float()).sum(-1)
    attention.flash_bwd_dkv(q, k, v, do, lse, delta, dlse, heads=h)
    attention.flash_bwd_dq(q, k, v, do, lse, delta, dlse, heads=h)
    assert _variant_counts() == [(tc + tensor_cores, simt + (not tensor_cores))
                                 for tc, simt in before]


@pytest.mark.parametrize("head_dim", TENSOR_CORE_HEAD_DIMS)
def test_tensor_core_backward_reruns_are_bit_identical(dev, head_dim):
    """One writer per output element and no atomics: the same inputs give
    the same dK, dV and dQ bits on every call."""
    h, q, k, v, do, kb, dlse = _flash_inputs(dev, torch.bfloat16, 777, 777, -1e9, seed=4,
                                             head_dim=head_dim)
    o, lse = attention.flash_fwd(q, k, v, kb, heads=h)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, dlse, kb)
    first = (*attention.flash_bwd_dkv(*args, heads=h), attention.flash_bwd_dq(*args, heads=h))
    for _ in range(3):
        again = (*attention.flash_bwd_dkv(*args, heads=h), attention.flash_bwd_dq(*args, heads=h))
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# The ring's hops at GPT-2's seq 1024 over 2 context ranks, each with
# the merge's nonzero lse cotangent: the contiguous ring's 512 x 512
# diagonal and non-causal hop, zigzag's 256 x 256 diagonals, both chunks'
# 512 queries over one 256 chunk, the late chunk over 512 keys.
RING_HOPS = [(512, 512, True), (512, 512, False), (256, 256, True), (512, 256, False),
             (256, 512, False)]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("seq_q,seq_kv,causal", RING_HOPS)
def test_flash_backward_with_a_ring_dlse_matches_plain(dev, dtype, atol, seq_q, seq_kv, causal):
    _check_flash_kernels(dev, dtype, atol, seq_q, seq_kv, causal, None, head_dim=64)


def _ring_on_one_card(rank: int, dtype_name: str, impl: str) -> dict:
    from tensorflow_examples_torch.core.mesh import MeshConfig, create_mesh
    from tensorflow_examples_torch.parallel.attention import mesh_attention

    dtype = getattr(torch, dtype_name)
    mesh = create_mesh(MeshConfig(data=1, context=2), device=torch.device("cuda"))
    rng = np.random.default_rng(17)
    full = [_randn(rng, (2, 12, 1024, 64), torch.device("cuda"), dtype) for _ in range(3)]
    s = 512
    local = [t[:, :, rank * s:(rank + 1) * s].contiguous().requires_grad_(True) for t in full]
    before = [f.launches for f in FLASH_KERNELS]
    out = mesh_attention(*local, mesh=mesh, causal=True, impl=impl)
    grads = torch.autograd.grad(out.float().square().sum(), local)
    launched = [f.launches - b for f, b in zip(FLASH_KERNELS, before)]
    leaves = [t.detach().requires_grad_(True) for t in full]
    ref = attention.flash_attention(*leaves, causal=True)
    ref_grads = torch.autograd.grad(ref.float().square().sum(), leaves)
    sl = slice(rank * s, (rank + 1) * s)
    errs = {"out": float((out.float() - ref[:, :, sl].float()).abs().max()),
            "ref_max": float(ref.float().abs().max())}
    for name, g, r in zip("qkv", grads, ref_grads):
        errs[f"d{name}"] = float((g.float() - r[:, :, sl].float()).abs().max())
        errs[f"d{name}_max"] = float(r.float().abs().max())
    return {"errs": errs, "launched": launched,
            "backend": torch.distributed.get_backend()}


@pytest.mark.parametrize("dtype_name,impl", [("float32", "ring"), ("bfloat16", "ring"),
                                             ("bfloat16", "ulysses")])
def test_two_rank_context_attention_on_one_card_matches_flash(dev, tmp_path, dtype_name, impl):
    """Two ranks share the card over gloo (host-staged collectives): the
    zigzag ring (and Ulysses) of GPT-2's attention, [2, 12, 1024, 64]
    split over 2 context ranks, against the flash kernels on the whole
    sequence, output and the gradients of sum(out**2)."""
    from tensorflow_examples_torch.core import distributed

    ranks = distributed.run_world(_ring_on_one_card, 2, dtype_name, impl, device="cuda",
                                  timeout_s=240, store_dir=str(tmp_path))
    fwd_tol, grad_tol = (2e-5, 5e-4) if dtype_name == "float32" else (2e-2, 5e-2)
    for r in ranks:
        assert r["backend"] == "gloo"
        e = r["errs"]
        assert e["out"] <= fwd_tol * max(e["ref_max"], 1.0), e
        for name in ("dq", "dk", "dv"):
            assert e[name] <= grad_tol * max(e[f"{name}_max"], 1.0), (name, e)
        # zigzag: 3 forward launches at hop 0 and 1 at hop 1; Ulysses: 1
        assert r["launched"][0] == (4 if impl == "ring" else 1), r["launched"]
        assert min(r["launched"]) >= 1


def _graphs_under_gloo(rank: int) -> str:
    from tensorflow_examples_torch.sharding import ShardingConfig
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import gpt2

    cfg = gpt2.Gpt2Config(vocab_size=64, seq_len=16, num_layers=1, num_heads=2, d_model=32,
                          global_batch_size=4, train_steps=2, steps_per_launch=2, log_every=2,
                          eval_every=0, checkpoint_every=0, telemetry_sinks="")
    sc = ShardingConfig(mesh={"data": 2})
    mesh = sc.build_mesh()
    trainer = Trainer(gpt2.make_task(cfg), cfg, mesh=mesh, sharding=sc)
    try:
        trainer.fit(iter([]))
    except ValueError as e:
        return str(e)
    return "no error"


def test_k_step_graphs_refuse_gloo_on_the_card(dev, tmp_path):
    """Two ranks on one card run gloo, whose collectives go through host
    memory: a CUDA graph of k steps cannot hold them, and fit says so."""
    from tensorflow_examples_torch.core import distributed

    for msg in distributed.run_world(_graphs_under_gloo, 2, device="cuda", timeout_s=240,
                                     store_dir=str(tmp_path)):
        assert "gloo" in msg and "steps_per_launch=2" in msg, msg


def _pipe_config():
    from tensorflow_examples_torch.workloads import gpt2

    cfg = gpt2.Gpt2Config(vocab_size=512, seq_len=128, num_layers=2, num_heads=4, d_model=256,
                          dropout=0.0, precision="f32", global_batch_size=8, train_steps=2,
                          warmup_steps=1, learning_rate=1e-3, log_every=1, eval_every=0,
                          checkpoint_every=0, telemetry_sinks="", watchdog_secs=0)
    rng = np.random.default_rng(3)
    return cfg, [{"tokens": rng.integers(0, 512, (8, 129)).astype(np.int32)} for _ in range(2)]


def _pipe_step_on_one_card(rank: int) -> dict:
    from tensorflow_examples_torch.sharding import ShardingConfig
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import gpt2

    cfg, batches = _pipe_config()
    kernels = FLASH_KERNELS + (cross_entropy.ce_fwd, cross_entropy.ce_bwd)
    sc = ShardingConfig(mesh={"pipe": 2})
    mesh = sc.build_mesh()
    trainer = Trainer(gpt2.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc)
    before = [f.launches for f in kernels]
    losses = [float(trainer.train_step(b)["loss"]) for b in batches]
    launched = [f.launches - b for f, b in zip(kernels, before)]
    whole = trainer.layout.gather_state({"params": trainer.state.params})["params"]
    return {"losses": losses, "launched": launched, "backend": torch.distributed.get_backend(),
            "params": {k: v.cpu().numpy() for k, v in whole.items()} if rank == 0 else None}


def test_two_rank_pipeline_step_on_one_card_matches_one_rank(dev, tmp_path):
    """Two ranks share the card over gloo as two pipeline stages: two
    f32 1F1B steps (4 microbatches, the flash and fused CE kernels inside
    the schedule) against the same steps on one rank from the same seeded
    init; losses rtol 1e-5, the updated parameters within 1e-5."""
    from tensorflow_examples_torch.core import distributed
    from tensorflow_examples_torch.models import transformer
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import gpt2

    ranks = distributed.run_world(_pipe_step_on_one_card, 2, device="cuda", timeout_s=240,
                                  store_dir=str(tmp_path))
    cfg, batches = _pipe_config()
    one = Trainer(gpt2.make_task(cfg), cfg)
    one_losses = [float(one.train_step(b)["loss"]) for b in batches]
    stacked = transformer.stack_params_for_pipeline(one.state.params, cfg.num_layers)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], one_losses, rtol=1e-5)
    for k, v in stacked.items():
        np.testing.assert_allclose(ranks[0]["params"][k], v.cpu().numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
    # Each stage's layer a step: 4 forward ticks, recomputed in 4 backward
    # ticks; the CE on the last stage only.
    assert ranks[0]["launched"] == [16, 8, 8, 0, 0], ranks[0]["launched"]
    assert ranks[1]["launched"] == [16, 8, 8, 16, 8], ranks[1]["launched"]
    assert all(r["backend"] == "gloo" for r in ranks)


def _ep_on_one_card(rank: int) -> dict:
    from tensorflow_examples_torch.core.mesh import MeshConfig, create_mesh
    from tensorflow_examples_torch.parallel import moe

    dev = torch.device("cuda")
    mesh = create_mesh(MeshConfig(data=1, model=2), device=dev)
    rng = np.random.default_rng(9)
    e, d, ff = 8, 256, 512
    args = [_randn(rng, shape, dev) * scale for shape, scale in (
        ((d, e), 0.5), ((e, d, ff), 0.05), ((e, ff), 0.01), ((e, ff, d), 0.05), ((e, d), 0.01),
        ((4, 256, d), 1.0))]
    local = [args[0], *(a[rank * e // 2:(rank + 1) * e // 2] for a in args[1:5]), args[5]]
    leaves = [a.clone().requires_grad_(True) for a in local]
    out, aux, drop = moe.moe_ffn_ep(*leaves, mesh=mesh, capacity_factor=8.0, top_k=2)
    grads = torch.autograd.grad(out.square().mean() + aux, leaves)
    ref_leaves = [a.clone().requires_grad_(True) for a in args]
    ref, ref_aux, ref_drop = moe.moe_ffn(*ref_leaves, capacity_factor=8.0, top_k=2,
                                         impl="grouped")
    ref_grads = torch.autograd.grad(ref.square().mean() + ref_aux, ref_leaves)
    sl = slice(rank * e // 2, (rank + 1) * e // 2)
    errs = {"out": float((out - ref).abs().max()), "aux": abs(float(aux) - float(ref_aux)),
            "drop": float(drop), "ref_drop": float(ref_drop)}
    for i, name in enumerate(("gate", "w_in", "b_in", "w_out", "b_out", "x")):
        r = ref_grads[i][sl] if 0 < i < 5 else ref_grads[i]
        errs[name] = float((grads[i] - r).abs().max()) / max(float(r.abs().max()), 1e-30)
    return errs


def test_two_rank_expert_parallel_moe_on_one_card_matches_moe_ffn(dev, tmp_path):
    """``moe_ffn_ep`` over ``{model: 2}`` on one card (gloo, each rank 4
    of 8 experts, tokens split over the two ranks, all-to-all staged
    through host memory) against ``moe_ffn``'s grouped kernels at a
    capacity that drops nothing: outputs atol 2e-5, the aux loss rtol
    1e-5, gradients 1e-4 of their largest value."""
    from tensorflow_examples_torch.core import distributed

    for errs in distributed.run_world(_ep_on_one_card, 2, device="cuda", timeout_s=240,
                                      store_dir=str(tmp_path)):
        assert errs["out"] <= 2e-5 and errs["aux"] <= 1e-5, errs
        assert errs["drop"] == 0.0 and errs["ref_drop"] == 0.0, errs
        assert all(errs[n] <= 1e-4 for n in ("gate", "w_in", "b_in", "w_out", "b_out", "x")), \
            errs


def _workload_configs() -> dict:
    """ResNet-20 (CIFAR-10, batch 16) and a narrow BERT (2 layers, 4
    heads of 32, seq 64, batch 8, flash attention), f32, dropout 0, with
    3 seeded batches each."""
    from tensorflow_examples_torch.workloads import bert_glue, cifar10

    common = dict(precision="f32", train_steps=3, warmup_steps=1, log_every=1, eval_every=0,
                  checkpoint_every=0, telemetry_sinks="", watchdog_secs=0)
    rng = np.random.default_rng(5)
    resnet = cifar10.Cifar10Config(global_batch_size=16, augment=False, **common)
    images = [{"image": rng.standard_normal((16, 32, 32, 3), dtype=np.float32),
               "label": rng.integers(0, 10, 16).astype(np.int32)} for _ in range(3)]
    bert = bert_glue.BertGlueConfig(seq_len=64, vocab_size=120, num_layers=2, num_heads=4,
                                    d_model=128, d_ff=256, dropout=0.0, attention="flash",
                                    global_batch_size=8, learning_rate=1e-3, **common)
    lengths = rng.integers(8, 65, 8)
    mask = (np.arange(64)[None] < lengths[:, None]).astype(np.int32)
    texts = [{"tokens": rng.integers(100, 120, (8, 64)).astype(np.int32) * mask,
              "attention_mask": mask, "token_type_ids": np.zeros((8, 64), np.int32),
              "label": rng.integers(0, 2, 8).astype(np.int32)} for _ in range(3)]
    return {"resnet20": (cifar10, resnet, {"data": 2}, images),
            "bert": (bert_glue, bert, {"model": 2}, texts)}


def _workload_steps(module, cfg, mesh_kw, batches) -> dict:
    from tensorflow_examples_torch.sharding import ShardingConfig
    from tensorflow_examples_torch.train.loop import Trainer

    sc = ShardingConfig(mesh=mesh_kw)
    mesh = sc.build_mesh()
    trainer = Trainer(module.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc)
    before = [f.launches for f in FLASH_KERNELS]
    losses = [float(trainer.train_step(b)["loss"]) for b in batches]
    stats = trainer.state.model_state.get("batch_stats", {})
    return {"losses": losses, "launched": [f.launches - b for f, b in zip(FLASH_KERNELS, before)],
            "batch_stats": {k: v.cpu().numpy() for k, v in stats.items()}}


def _workloads_on_one_card(rank: int) -> dict:
    return {name: _workload_steps(*spec) for name, spec in _workload_configs().items()}


def test_resnet_data2_and_bert_flash_model2_on_one_card_match_one_rank(dev, tmp_path):
    """Two ranks share the card over gloo: ResNet-20 on ``{data: 2}``
    (each BatchNorm's moments summed over the ranks, forward and
    backward) and BERT with the flash kernels on ``{model: 2}`` (2 heads
    a rank, the key bias of a ragged padding mask), 3 f32 steps each
    against the same steps on one rank from the same seeded init: losses
    rtol 1e-4, ResNet-20's statistics equal on the ranks and within rtol
    1e-4 (atol 1e-6) of one rank's, each flash kernel launched once a
    layer a step on every rank."""
    from tensorflow_examples_torch.core import distributed

    ranks = distributed.run_world(_workloads_on_one_card, 2, device="cuda", timeout_s=240,
                                  store_dir=str(tmp_path))
    for name, (module, cfg, _, batches) in _workload_configs().items():
        one = _workload_steps(module, cfg, {"data": 1}, batches)
        got = [r[name] for r in ranks]
        assert got[0]["losses"] == got[1]["losses"], name
        np.testing.assert_allclose(got[0]["losses"], one["losses"], rtol=1e-4, err_msg=name)
        for k, v in one["batch_stats"].items():
            np.testing.assert_array_equal(got[1]["batch_stats"][k], got[0]["batch_stats"][k])
            np.testing.assert_allclose(got[0]["batch_stats"][k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        want = [cfg.num_layers * 3] * 3 if name == "bert" else [0, 0, 0]
        assert all(r["launched"] == want for r in got) and one["launched"] == want, name


def test_flash_kernels_refuse_what_they_cannot_launch(dev):
    q = torch.zeros(2, 16, UNSUPPORTED_HEAD_DIM, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_fwd(q, q, q)
    q = torch.zeros(3, 16, 64, device=dev)
    with pytest.raises(ValueError, match="multiple of heads"):
        attention.flash_fwd(q, q, q, heads=2)


# ------------------------------------------------------ fused cross-entropy

CE_CASES = [  # (n, vocab)
    (64, 1000),
    (32, 4099),      # odd vocab: every other bf16 row starts 2-byte aligned
    (1, 50257),
    (16, 50257),
]


def _ce_inputs(dev, dtype, n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    logits = _randn(rng, (n, vocab), dev, dtype) * 3
    labels = torch.from_numpy(rng.integers(0, vocab, n)).to(dev)
    labels[0] = -1
    if n > 2:
        labels[1] = vocab
        logits[2] = attention.NEG_INF  # a row of all -1e30
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    return logits, labels, g


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,vocab", CE_CASES)
def test_ce_kernels_match_plain(dev, dtype, atol, n, vocab):
    logits, labels, g = _ce_inputs(dev, dtype, n, vocab)
    before = (cross_entropy.ce_fwd.launches, cross_entropy.ce_bwd.launches)
    nll, lse = cross_entropy.ce_fwd(logits, labels)
    nll_ref, lse_ref = cross_entropy.ce_fwd_plain(logits, labels)
    torch.testing.assert_close(nll, nll_ref, atol=atol, rtol=1e-5)
    torch.testing.assert_close(lse, lse_ref, atol=atol, rtol=1e-5)
    d = cross_entropy.ce_bwd(logits, labels, lse_ref, g)
    d_ref = cross_entropy.ce_bwd_plain(logits, labels, lse_ref, g)
    assert d.dtype == dtype
    # bf16: both sides round one f32 value, so they differ by at most
    # one bf16 ulp of each element (2^-7 relative).
    d_atol, d_rtol = (1e-6, 1e-6) if dtype == torch.float32 else (1e-7, 8e-3)
    torch.testing.assert_close(d.float(), d_ref.float(), atol=d_atol, rtol=d_rtol)
    assert (cross_entropy.ce_fwd.launches, cross_entropy.ce_bwd.launches) == (
        before[0] + 1, before[1] + 1)


def test_fused_ce_autograd_matches_reference(dev):
    """Through the autograd Function, with the expanded stride-0
    cotangent a mean gives, against autograd of the plain reference."""
    logits, labels, _ = _ce_inputs(dev, torch.float32, 48, 4099, seed=1)
    grads = []
    for fused in (True, False):
        x = logits.clone().requires_grad_()
        loss = cross_entropy.cross_entropy_per_example(x, labels, fused=fused).mean()
        grads.append((loss, torch.autograd.grad(loss, x)[0]))
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=1e-6, rtol=1e-5)


def test_ce_kernels_refuse_what_they_cannot_launch(dev):
    with pytest.raises(ValueError, match="dtype"):
        cross_entropy.ce_fwd(torch.zeros(2, 8, device=dev, dtype=torch.float16),
                             torch.zeros(2, dtype=torch.long, device=dev))
    with pytest.raises(ValueError, match="CUDA"):
        cross_entropy.ce_fwd(torch.zeros(2, 8, device=dev), torch.zeros(2, dtype=torch.long))


# ------------------------------------------------ grouped matmul (MoE)

GMM_CASES = [
    (2, 768, 3072, (0, 1, 0, 0, 0, 0, 1, 0)),            # one decode token, top-2
    (1554, 100, 36, (300, 0, 254, 500, 0, 200, 300, 0)),  # not a tile multiple
    (1025, 64, 96, (1, 512, 0, 511, 1, 0, 0, 0)),         # one-row groups
    (300, 36, 100, (0, 300, 0)),                          # one group, empty first and last
    (700, 48, 40, (100, 200)),                            # rows past the last group
]


def _gmm_close(out, ref, dtype):
    """f32: within 1e-4 of max |ref|; bf16: plus one bf16 rounding of each
    element (8e-3 |ref|), since the two sides sum in different orders."""
    scale = float(ref.float().abs().max())
    rtol = 8e-3 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-4 * scale, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,sizes", GMM_CASES)
def test_grouped_matmul_kernels_match_plain(dev, dtype, m, k, n, sizes):
    rng = np.random.default_rng(m + k)
    g = len(sizes)
    lhs, grad = _randn(rng, (m, k), dev, dtype), _randn(rng, (m, n), dev, dtype)
    rhs = _randn(rng, (g, k, n), dev, dtype)
    sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
    before = (grouped_matmul.gmm.launches, grouped_matmul.tgmm.launches)
    out = grouped_matmul.gmm(lhs, rhs, sz)
    assert out.dtype == dtype and out.shape == (m, n)
    _gmm_close(out, grouped_matmul.gmm_plain(lhs, rhs, sz), dtype)
    _gmm_close(grouped_matmul.gmm(grad, rhs, sz, transpose_rhs=True),
               grouped_matmul.gmm_plain(grad, rhs, sz, transpose_rhs=True), dtype)
    assert not out[sum(sizes):].float().any()  # rows past the last group
    ref = grouped_matmul.tgmm_plain(lhs.T, grad, sz)
    for lhs_t in (lhs.T, lhs.T.contiguous()):  # read in place, and a contiguous copy
        dw = grouped_matmul.tgmm(lhs_t, grad, sz)
        assert dw.shape == (g, k, n)
        _gmm_close(dw, ref, dtype)
        for i, size in enumerate(sizes):
            if size == 0:
                assert not dw[i].float().any()  # an empty group: exact zeros
    assert (grouped_matmul.gmm.launches, grouped_matmul.tgmm.launches) == (
        before[0] + 2, before[1] + 2)


def test_grouped_matmul_grads_match_plain(dev):
    """The autograd Function on the card (gmm, gmm transposed and tgmm)
    against autograd of the plain per-group products."""
    rng = np.random.default_rng(3)
    sizes = torch.tensor([40, 0, 300, 7, 0, 165], dtype=torch.int32, device=dev)
    lhs, rhs = _randn(rng, (512, 96), dev), _randn(rng, (6, 96, 80), dev)
    grad = _randn(rng, (512, 80), dev)
    out = []
    for fn in (grouped_matmul.grouped_matmul, grouped_matmul.gmm_plain):
        a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
        y = fn(a, b, sizes)
        out.append((y, *torch.autograd.grad(y, (a, b), grad)))
    for got, want in zip(*out):
        _gmm_close(got, want, torch.float32)


def test_grouped_matmul_kernels_refuse_what_they_cannot_launch(dev):
    sizes = torch.tensor([2, 2], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        grouped_matmul.gmm(torch.zeros(4, 8, device=dev), torch.zeros(2, 8, 8, device=dev,
                                                                      dtype=torch.bfloat16), sizes)
    with pytest.raises(ValueError, match="CUDA"):
        grouped_matmul.gmm(torch.zeros(4, 8, device=dev), torch.zeros(2, 8, 8, device=dev),
                           sizes.cpu())
    with pytest.raises(ValueError, match="do not fit"):
        grouped_matmul.tgmm(torch.zeros(8, 4, device=dev), torch.zeros(5, 8, device=dev), sizes)


MOE_SIZES = (5000, 3000, 2500, 2000, 1800, 1084, 1000, 0)  # skewed routing over 8 experts


@pytest.mark.parametrize("k,n", [(768, 3072), (3072, 768)])
def test_tensor_core_gmm_matches_plain_at_the_moe_shapes(dev, k, n):
    """The MoE step's two expert products and their transpose_rhs
    backward, bf16, through the tensor-core kernel."""
    rng = np.random.default_rng(k)
    m, g = sum(MOE_SIZES) + 384, len(MOE_SIZES)  # rows past the last group too
    lhs, grad = _randn(rng, (m, k), dev, torch.bfloat16), _randn(rng, (m, n), dev, torch.bfloat16)
    rhs = _randn(rng, (g, k, n), dev, torch.bfloat16)
    sz = torch.tensor(MOE_SIZES, dtype=torch.int32, device=dev)
    before = grouped_matmul.gmm.tensor_core_launches, grouped_matmul.gmm.simt_launches
    out = grouped_matmul.gmm(lhs, rhs, sz)
    _gmm_close(out, grouped_matmul.gmm_plain(lhs, rhs, sz), torch.bfloat16)
    assert not out[sum(MOE_SIZES):].float().any()
    _gmm_close(grouped_matmul.gmm(grad, rhs, sz, transpose_rhs=True),
               grouped_matmul.gmm_plain(grad, rhs, sz, transpose_rhs=True), torch.bfloat16)
    assert (grouped_matmul.gmm.tensor_core_launches, grouped_matmul.gmm.simt_launches) == (
        before[0] + 2, before[1])


@pytest.mark.parametrize("dtype,k,n,tensor_cores", [
    (torch.bfloat16, 768, 3072, True),
    (torch.bfloat16, 100, 36, False),   # k and n not multiples of 8
    (torch.float32, 768, 3072, False),  # f32 stays on the SIMT kernel
])
def test_gmm_variant_follows_dtype_and_shape(dev, dtype, k, n, tensor_cores):
    rng = np.random.default_rng(n)
    sizes = (40, 0, 300, 7)
    lhs, rhs = _randn(rng, (400, k), dev, dtype), _randn(rng, (4, k, n), dev, dtype)
    sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
    assert grouped_matmul.uses_tensor_cores(lhs, rhs, n) == tensor_cores
    before = grouped_matmul.gmm.tensor_core_launches, grouped_matmul.gmm.simt_launches
    _gmm_close(grouped_matmul.gmm(lhs, rhs, sz), grouped_matmul.gmm_plain(lhs, rhs, sz), dtype)
    assert (grouped_matmul.gmm.tensor_core_launches, grouped_matmul.gmm.simt_launches) == (
        before[0] + tensor_cores, before[1] + (not tensor_cores))


TGMM_CASES = [  # (k, n, sizes, rows past the last group)
    (768, 3072, MOE_SIZES, 0),
    (3072, 768, MOE_SIZES, 0),
    (768, 3072, (0, 0, 0, 16384, 0, 0, 0, 0), 0),    # every row in one group: split in 4
    (256, 128, (4099, 5003, 0, 4101), 5),            # chunk bounds off the 8-row grid
    (64, 96, (1, 0, 300, 7, 0), 12),                 # one-row group, empty ones
]


@pytest.mark.parametrize("k,n,sizes,past", TGMM_CASES)
def test_tensor_core_tgmm_matches_plain(dev, k, n, sizes, past):
    """bf16 tgmm on the tensor cores through ``lhs.T`` (the backward's
    view) and a contiguous ``lhs_t``, against the plain version; empty
    groups are exact zeros and rows past the last group count nowhere."""
    rng = np.random.default_rng(k + n + past)
    m, g = sum(sizes) + past, len(sizes)
    lhs = _randn(rng, (m, k), dev, torch.bfloat16)
    grad = _randn(rng, (m, n), dev, torch.bfloat16)
    sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
    ref = grouped_matmul.tgmm_plain(lhs.T, grad, sz)
    assert m % 8 == 0  # a contiguous [k, m] takes the tensor cores too
    for lhs_t in (lhs.T, lhs.T.contiguous()):
        before = grouped_matmul.tgmm.tensor_core_launches, grouped_matmul.tgmm.simt_launches
        dw = grouped_matmul.tgmm(lhs_t, grad, sz)
        assert (grouped_matmul.tgmm.tensor_core_launches, grouped_matmul.tgmm.simt_launches) == (
            before[0] + 1, before[1])
        assert dw.dtype == torch.bfloat16 and dw.shape == (g, k, n)
        _gmm_close(dw, ref, torch.bfloat16)
        for i, size in enumerate(sizes):
            if size == 0:
                assert not dw[i].float().any()


@pytest.mark.parametrize("dtype,k,n,tensor_cores", [
    (torch.bfloat16, 768, 3072, True),
    (torch.bfloat16, 100, 36, False),   # k and n not multiples of 8
    (torch.float32, 768, 3072, False),  # f32 stays on the SIMT kernel
])
def test_tgmm_variant_follows_dtype_and_shape(dev, dtype, k, n, tensor_cores):
    rng = np.random.default_rng(k + 1)
    sizes = (40, 0, 300, 7)
    lhs, grad = _randn(rng, (400, k), dev, dtype), _randn(rng, (400, n), dev, dtype)
    sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
    assert grouped_matmul.tgmm_uses_tensor_cores(lhs.T, grad) == tensor_cores
    before = grouped_matmul.tgmm.tensor_core_launches, grouped_matmul.tgmm.simt_launches
    _gmm_close(grouped_matmul.tgmm(lhs.T, grad, sz), grouped_matmul.tgmm_plain(lhs.T, grad, sz),
               dtype)
    assert (grouped_matmul.tgmm.tensor_core_launches, grouped_matmul.tgmm.simt_launches) == (
        before[0] + tensor_cores, before[1] + (not tensor_cores))


def test_tgmm_and_group_row_sum_reruns_are_bit_identical(dev):
    """No atomics: a split tgmm and a group_row_sum give the same bits on
    every call."""
    rng = np.random.default_rng(11)
    sizes = torch.tensor((0, 9000, 0, 7384), dtype=torch.int32, device=dev)
    lhs = _randn(rng, (16384, 256), dev, torch.bfloat16)
    grad = _randn(rng, (16384, 384), dev, torch.bfloat16)
    first = grouped_matmul.tgmm(lhs.T, grad, sizes), grouped_matmul.group_row_sum(grad, sizes)
    for _ in range(3):
        again = grouped_matmul.tgmm(lhs.T, grad, sizes), grouped_matmul.group_row_sum(grad, sizes)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


ROW_SUM_CASES = [  # (m, n, sizes)
    (16384, 768, MOE_SIZES),
    (16384, 3072, MOE_SIZES),
    (1000, 100, (0, 1, 500, 0, 399)),      # n not a multiple of 8, rows past the groups
    (64, 8, (64,)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,sizes", ROW_SUM_CASES)
def test_group_row_sum_matches_plain(dev, dtype, m, n, sizes):
    rng = np.random.default_rng(m + n)
    x = _randn(rng, (m, n), dev, dtype)
    sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
    before = grouped_matmul.group_row_sum.launches
    out = grouped_matmul.group_row_sum(x, sz)
    assert grouped_matmul.group_row_sum.launches == before + 1
    assert out.dtype == dtype and out.shape == (len(sizes), n)
    _gmm_close(out, grouped_matmul.group_row_sum_plain(x, sz), dtype)
    for i, size in enumerate(sizes):
        if size == 0:
            assert not out[i].float().any()


def test_bias_gather_grad_matches_autograd_of_the_index(dev):
    """The MoE bias gather's backward (``group_row_sum``) against
    autograd of ``b[srt_eid]`` (PyTorch's scatter-add)."""
    from tensorflow_examples_torch.parallel import moe

    rng = np.random.default_rng(2)
    sizes = torch.tensor((700, 0, 1300, 48), dtype=torch.int32, device=dev)
    ids = torch.repeat_interleave(torch.arange(4, device=dev), sizes.long())
    b = _randn(rng, (4, 200), dev)
    grad = _randn(rng, (ids.shape[0], 200), dev)
    grads = []
    for take in (lambda v: moe._take_group_rows(v, ids, sizes), lambda v: v[ids]):
        leaf = b.clone().requires_grad_()
        y = take(leaf)
        grads.append((y, *torch.autograd.grad(y, leaf, grad)))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0, atol=0)
    _gmm_close(grads[0][1], grads[1][1], torch.float32)


# ------------------------------------------- serving rungs as CUDA graphs


def _graph_engine(**kw):
    from tensorflow_examples_torch.models import transformer
    from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig

    cfg = transformer.TransformerConfig(vocab_size=96, max_len=128, num_layers=2, num_heads=2,
                                        d_model=128, dropout=0.0)
    serve = dict(max_slots=4, prefill_bucket_floor=16, kv_bucket_floor=32, spec_decode_k=3)
    serve.update(kw)
    return InferenceEngine(cfg, transformer.GPT2(cfg, seed=7), cfg=ServeConfig(**serve))


GRAPH_CONFIGS = {
    "dense_flash": dict(attention="flash"),
    "paged_flash_int8": dict(attention="paged_flash", kv_block_size=16, kv_dtype="int8"),
    "paged_fp8_weights_int8": dict(kv_block_size=16, kv_dtype="fp8", weight_dtype="int8"),
}


@pytest.mark.parametrize("name", sorted(GRAPH_CONFIGS))
def test_replayed_rungs_equal_eager_steps(dev, name):
    """A decode and a verify rung replayed from their CUDA graphs give
    logits bit-identical to the same step run eagerly on the same inputs
    and cache (the step rewrites the rows it writes with the same bits)."""
    engine = _graph_engine(**GRAPH_CONFIGS[name])
    engine.warmup()
    assert engine.cuda_graphs and engine.post_warmup_recompiles() == 0
    rng = np.random.default_rng(3)
    slots, toks = [], []
    for n in (5, 19, 40):
        slot = engine.pool.alloc()
        slots.append(slot)
        toks.append(engine.prefill(slot, [int(t) for t in rng.integers(0, 96, n)])[0])
    for _ in range(3):
        out = engine.decode([(s, t, 0, 0.0, 0) for s, t in zip(slots, toks)])
        toks = [out[s] for s in slots]
    s_n, t_n = engine.cfg.max_slots, engine.cfg.spec_decode_k + 1
    positions = np.zeros(s_n, np.int64)
    positions[slots] = engine.pool.lengths[slots]
    kb = 64
    paged = engine.paged
    if paged:
        for s in slots:
            engine.pool.ensure_position(s, int(positions[s]) + t_n - 1)
        tables = engine._tables(slots, kb)
    tokens = np.zeros(s_n, np.int64)
    tokens[slots] = toks
    args = (tokens, positions) + ((tables,) if paged else ())
    replayed = engine._decode_fns[kb](*args).clone()
    eager = (engine._paged_decode_rung if paged else engine._decode_rung)(kb, *args)
    assert torch.equal(replayed, eager)
    vtokens = np.zeros((s_n, t_n), np.int64)
    vtokens[slots] = rng.integers(0, 96, (len(slots), t_n))
    vargs = (vtokens, positions) + ((tables,) if paged else ())
    replayed = engine._verify_fns[kb](*vargs).clone()
    eager = (engine._paged_verify_rung if paged else engine._verify_rung)(kb, *vargs)
    assert torch.equal(replayed, eager)
    assert engine.post_warmup_recompiles() == 0
    for s in slots:
        engine.pool.free(s)


def test_graph_launch_tally_equals_the_profiler_count(dev):
    """The paged kernel's launches counted from graph replays equal the
    kernels a profiler window sees in those replays. The window waits
    50 ms before the first replay: the profiler drops kernels timestamped
    before its trace starts, and the card's timestamps can read a few ms
    earlier than the host's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine = _graph_engine(attention="paged_flash", kv_block_size=16, spec_decode_k=0)
    engine.warmup()
    slot = engine.pool.alloc()
    tok, _ = engine.prefill(slot, list(range(1, 30)))
    engine.decode([(slot, tok, 0, 0.0, 0)])  # the rung's graph is warm
    counter = paged_decode.paged_decode_attention
    before = counter.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(5):
            tok = engine.decode([(slot, tok, 0, 0.0, 0)])[slot]
        torch.cuda.synchronize()
    seen = sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "paged_decode_kernel" in e.key)
    assert counter.launches - before == 5 * engine.model_cfg.num_layers
    assert seen == counter.launches - before
    engine.pool.free(slot)



@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_page_handoff_between_engines_on_the_card(dev, kv_dtype):
    """A prefill-role engine's exported pages, shipped as JSON and
    imported by a warmed decode-role engine (its decode rungs CUDA graphs
    over the pool the import writes in place), decode to the tokens of a
    mixed engine serving the whole request, greedy and sampled, full and
    delta; the prefill launched flash-decode and the decode steps the
    paged kernel."""
    import json

    from tensorflow_examples_torch.serving import scheduler

    kw = dict(attention="paged_flash", kv_block_size=16, kv_dtype=kv_dtype, spec_decode_k=0)
    pre, dec, mixed = (_graph_engine(role=role, **kw) for role in ("prefill", "decode", "mixed"))
    for engine in (pre, dec, mixed):
        engine.warmup()
    rng = np.random.default_rng(5)
    prefix = [int(t) for t in rng.integers(0, 96, 48)]

    def decode_from(engine, slot, first, sampling):
        toks = [first]
        while len(toks) < 12:
            toks.append(engine.decode([(slot, toks[-1], *sampling)])[slot])
        engine.pool.free(slot)
        return toks

    for i, tail in enumerate(([3, 1, 4], [9, 2, 6, 5, 3, 5])):
        prompt = prefix + tail
        sampling = (i, 0.8, 20) if i else (0, 0.0, 0)
        kwargs = dict(seed=sampling[0], temperature=sampling[1], top_k=sampling[2])
        slot = mixed.pool.alloc()
        want = decode_from(mixed, slot, mixed.prefill(slot, prompt, **kwargs)[0], sampling)
        flash_before = decode.flash_decode_attention.launches
        slot = pre.pool.alloc()
        first, _ = pre.prefill(slot, prompt, **kwargs)
        digest = frozenset(dec.pool.prefix_digest()["keys"])
        skip = scheduler.affinity_blocks(scheduler.prompt_chain_keys(prompt, 16), digest) * 16
        payload = json.loads(json.dumps(pre.export_kv_pages(slot, prompt, skip_tokens=skip)))
        pre.pool.free(slot)
        assert payload.get("start_block", 0) == (0, 3)[i]
        if i == 0:
            assert decode.flash_decode_attention.launches > flash_before
        paged_before = paged_decode.paged_decode_attention.launches
        slot = dec.pool.alloc()
        dec.import_kv_pages(slot, payload, prompt)
        assert decode_from(dec, slot, first, sampling) == want
        assert paged_decode.paged_decode_attention.launches - paged_before == \
            11 * dec.model_cfg.num_layers
    for engine in (pre, dec, mixed):
        assert engine.post_warmup_recompiles() == 0


# ------------------------------------------------- k train steps as one graph


def _train_cfg(**kw):
    from tensorflow_examples_torch.workloads import gpt2

    base = dict(vocab_size=96, seq_len=64, num_layers=2, num_heads=2, d_model=64,
                global_batch_size=4, train_steps=8, warmup_steps=2, learning_rate=3e-3,
                log_every=2, eval_every=0, checkpoint_every=0, telemetry_sinks="",
                precision="bf16", dropout=0.1)
    base.update(kw)
    return gpt2.Gpt2Config(**base)


def _fit(cfg, steps, workdir=""):
    from tensorflow_examples_torch.data.memory import train_iterator
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import gpt2

    cfg = cfg.replace(workdir=workdir)
    ds, _ = gpt2.datasets(cfg)
    trainer = Trainer(gpt2.make_task(cfg), cfg)
    trainer.fit(lambda s: train_iterator(ds, cfg.global_batch_size, seed=0, start_step=s),
                num_steps=steps)
    return trainer


@pytest.mark.parametrize("moe", [False, True])
def test_graph_of_two_steps_equals_two_eager_steps(dev, moe):
    """steps_per_launch=2 on the card: one CUDA graph of 2 steps, replayed,
    gives the eager steps' losses and parameters bit for bit, dropout and
    (MoE) router jitter included: the masks and the jitter are the eager
    steps' own, different at every step."""
    kw = dict(moe_experts=4, moe_top_k=2, moe_impl="grouped") if moe else {}
    eager = _fit(_train_cfg(**kw), 8)
    graph = _fit(_train_cfg(steps_per_launch=2, **kw), 8)
    assert graph.bundled_step(2).captured == 1
    assert [h["loss"] for h in graph.history] == [h["loss"] for h in eager.history]
    for name, p in eager.state.params.items():
        assert torch.equal(p, graph.state.params[name]), name


def test_graph_masks_differ_across_replays(dev):
    """The graph's generators of one launch are seeded per step: each step
    draws another mask, and a replay at another step draws other masks."""
    from tensorflow_examples_torch.core import rng

    trainer = _fit(_train_cfg(steps_per_launch=2), 4)
    noises = trainer.bundled_step(2)._noises
    draws = []
    for step in (4, 6):
        for i, noise in enumerate(noises):
            draws.append(noise.stage(trainer.step_key(step + i)).dropout_uniform(1, (16,), dev))
    assert len({d.cpu().numpy().tobytes() for d in draws}) == 4
    eager = rng.StepNoise(trainer.step_key(4)).dropout_uniform(1, (16,), dev)
    assert torch.equal(draws[0], eager)


def test_rollback_refreshes_the_graph_state(dev):
    """A state that is not the graph's own (a restored checkpoint, a
    rollback) is copied into its static buffers before the next replay:
    a trainer at step 8 handed a step-4 state trains on from step 4 as
    the uninterrupted run does."""
    from tensorflow_examples_torch.data.memory import train_iterator
    from tensorflow_examples_torch.workloads import gpt2

    cfg = _train_cfg(steps_per_launch=2)
    whole = _fit(cfg, 8)
    trainer = _fit(cfg, 8)
    trainer.state = _fit(cfg.replace(steps_per_launch=1), 4).state  # foreign, step 4
    ds, _ = gpt2.datasets(cfg)
    trainer.fit(lambda s: train_iterator(ds, 4, seed=0, start_step=s), num_steps=8)
    assert trainer.state.step == 8 and trainer.bundled_step(2).captured == 1
    for name, p in whole.state.params.items():
        assert torch.equal(p, trainer.state.params[name]), name


def test_prefetched_batches_equal_host_batches(dev):
    """Pinned staging and the side-stream copy deliver the host batches
    unchanged, bundles included."""
    from tensorflow_examples_torch.data.prefetch import bundle_batches, device_prefetch

    rng = np.random.default_rng(0)
    host = [{"tokens": rng.integers(0, 1000, (4, 65)).astype(np.int32),
             "scale": rng.standard_normal(4).astype(np.float32)} for _ in range(8)]
    for k in (1, 2):
        src = iter(host) if k == 1 else bundle_batches(iter(host), k)
        got = list(device_prefetch(src, dev, depth=3))
        want = host if k == 1 else list(bundle_batches(iter(host), k))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert all(g[key].is_cuda and np.array_equal(g[key].cpu().numpy(), w[key])
                       for key in w)


# ------------------------------------------- BERT GLUE and the image workloads

BERT_SHAPE = (32, 12, 128, 64)  # BERT-base GLUE's attention: batch, heads, sequence, head_dim


def _bert_bias(dev, case, b, s, rng):
    """The f32 key bias of a padding mask: lengths in [8, s] (``ragged``)
    or none masked (``no padding``)."""
    if case == "no padding":
        return torch.zeros(b, s, device=dev)
    lengths = torch.from_numpy(rng.integers(8, s + 1, b))
    return torch.where(torch.arange(s)[None] < lengths[:, None], 0.0, attention.NEG_INF).to(dev)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", ["ragged", "no padding"])
def test_flash_kernels_at_the_bert_shape(dev, dtype, atol, case):
    """BERT's route: non-causal at S 128 with a key bias, bf16 on the
    tensor cores and f32 SIMT; each kernel against its plain version at
    the flash tolerances, and a rerun gives the same bits."""
    rng = np.random.default_rng(31)
    b, h, s, d = BERT_SHAPE
    q, k, v, do = (_randn(rng, (b * h, s, d), dev, dtype) for _ in range(4))
    kb = _bert_bias(dev, case, b, s, rng)
    dlse = torch.zeros(b * h, s, device=dev)
    kw = dict(heads=h, causal=False, sm_scale=d ** -0.5)
    before = _variant_counts()
    o, lse = attention.flash_fwd(q, k, v, kb, **kw)
    o_ref, lse_ref = attention.flash_fwd_plain(q, k, v, kb, **kw)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=atol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, dlse, kb)
    got = (*attention.flash_bwd_dkv(*args, **kw), attention.flash_bwd_dq(*args, **kw))
    tc = attention.uses_tensor_cores(dtype, d)
    assert tc == (dtype == torch.bfloat16)
    assert _variant_counts() == [(t + tc, si + (not tc)) for t, si in before]
    ref = (*attention.flash_bwd_dkv_plain(*args, **kw), attention.flash_bwd_dq_plain(*args, **kw))
    grad_tol = 5e-4 if dtype == torch.float32 else 5e-2
    for name, a, r in zip(("dk", "dv", "dq"), got, ref):
        scale = max(float(r.float().abs().max()), 1.0)
        torch.testing.assert_close(a.float() / scale, r.float() / scale, atol=grad_tol,
                                   rtol=grad_tol, msg=name)
    again = (*attention.flash_fwd(q, k, v, kb, **kw), *attention.flash_bwd_dkv(*args, **kw),
             attention.flash_bwd_dq(*args, **kw))
    assert all(torch.equal(x, y) for x, y in zip((o, lse, *got), again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bert_flash_path_matches_the_plain_path(dev, dtype):
    """A 2-layer BERT at head_dim 64 and S 128 on ragged masks: logits and
    every gradient of the flash path against the plain softmax path (f32:
    the JAX suite's 2e-4 and 5e-4; bf16: 5e-2 of each largest value), with
    12 launches of each kernel's variant by the dtype's rule."""
    from tensorflow_examples_torch.models import bert
    from tensorflow_examples_torch.models.transformer import ParamView

    rng = np.random.default_rng(5)
    base = dict(vocab_size=300, max_len=128, num_layers=2, num_heads=2, d_model=128, d_ff=256,
                dropout=0.0)
    model = bert.BertClassifier(bert.BertConfig(**base), 2, seed=1, device=dev)
    tokens = torch.from_numpy(rng.integers(1, 300, (8, 128))).to(dev)
    mask = (_bert_bias(dev, "ragged", 8, 128, rng) == 0).int()
    out = {}
    for impl in ("xla", "flash"):
        leaves = {k: p.detach().to(dtype).requires_grad_() for k, p in model.named_parameters()}
        before = _variant_counts()
        logits = bert.forward(bert.BertConfig(**base, attention=impl), ParamView(leaves), tokens,
                              mask)
        grads = torch.autograd.grad((logits ** 2).sum(), list(leaves.values()))
        counts = [(t - t0, s - s0) for (t, s), (t0, s0) in zip(_variant_counts(), before)]
        out[impl] = (logits, dict(zip(leaves, grads)), counts)
    tc = dtype == torch.bfloat16
    assert out["xla"][2] == [(0, 0)] * 3
    assert out["flash"][2] == [(2 * tc, 2 * (not tc))] * 3
    if dtype == torch.float32:
        torch.testing.assert_close(out["flash"][0], out["xla"][0], atol=2e-4, rtol=2e-4)
    for name, g in out["xla"][1].items():
        a = out["flash"][1][name].float()
        tol = 5e-4 if dtype == torch.float32 else 5e-2
        scale = max(float(g.float().abs().max()), 1e-30) if dtype == torch.bfloat16 else 1.0
        torch.testing.assert_close(a / scale, g.float() / scale, atol=tol, rtol=tol, msg=name)


def test_resnet_graph_of_two_steps_equals_two_eager_steps(dev):
    """CIFAR-10 ResNet-20 at steps_per_launch=2 (one CUDA graph of 2
    steps, BatchNorm statistics carried in its static buffers) against
    eager steps, cuDNN deterministic: the same losses, parameters and
    running statistics, bit for bit."""
    from tensorflow_examples_torch.data.memory import train_iterator
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import cifar10

    cfg = cifar10.Cifar10Config(global_batch_size=16, train_steps=6, warmup_steps=2,
                                log_every=2, eval_every=0, checkpoint_every=0,
                                telemetry_sinks="")
    ds = cifar10.datasets(cfg)[0]
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = []
        for k in (1, 2):
            trainer = Trainer(cifar10.make_task(cfg), cfg.replace(steps_per_launch=k))
            trainer.fit(lambda s: train_iterator(ds, 16, seed=0, start_step=s,
                                                 augment=cifar10.train_augment(cfg)),
                        num_steps=6)
            runs.append(trainer)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    eager, graph = runs
    assert graph.bundled_step(2).captured == 1
    assert [h["loss"] for h in graph.history] == [h["loss"] for h in eager.history]
    for name, p in eager.state.params.items():
        assert torch.equal(p, graph.state.params[name]), name
    for name, t in eager.state.model_state["batch_stats"].items():
        assert t.dtype == torch.float32
        assert torch.equal(t, graph.state.model_state["batch_stats"][name]), name


# ------------------------------------------------ the fleet on the card


def _fleet_engine():
    return _graph_engine(attention="paged_flash", kv_block_size=16, spec_decode_k=0,
                         max_slots=8)


def _post(url, body):
    from tensorflow_examples_torch.serving.router import post_json

    return post_json(url, body, 120)


def test_router_over_paged_replicas_on_the_card(dev):
    """The port's router over two warmed in-process paged replicas: every
    routed stream equals the same request sent straight to a replica, and
    the routed requests launched the paged kernel (from the decode rungs'
    graph replays) and flash-decode (the prefills)."""
    from tensorflow_examples_torch.serving.batcher import ContinuousBatcher
    from tensorflow_examples_torch.serving.frontend import ServingFrontend
    from tensorflow_examples_torch.serving.router import Router, RouterFrontend

    stacks = []
    for _ in range(2):
        engine = _fleet_engine()
        engine.warmup()
        batcher = ContinuousBatcher(engine).start()
        stacks.append((batcher, ServingFrontend(batcher).start()))
    router = Router([f.url("") for _, f in stacks]).start()
    front = RouterFrontend(router).start()
    rng = np.random.default_rng(11)
    bodies = [{"prompt": [int(t) for t in rng.integers(0, 96, n)], "max_new_tokens": 16,
               "seed": i, **({"temperature": 0.8, "top_k": 20} if i % 2 else {})}
              for i, n in enumerate((5, 17, 40, 70, 9, 33))]
    try:
        paged0 = paged_decode.paged_decode_attention.launches
        flash0 = decode.flash_decode_attention.launches
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
            routed = list(pool.map(lambda b: _post(front.url("/generate"), b), bodies))
        assert paged_decode.paged_decode_attention.launches > paged0
        assert decode.flash_decode_attention.launches > flash0
        for body, (status, reply) in zip(bodies, routed):
            assert status == 200
            assert reply["tokens"] == _post(stacks[0][1].url("/generate"), body)[1]["tokens"]
        counts = router.registry.counter_values()
        assert counts["router/dispatched_total"] == len(bodies)
        for batcher, _ in stacks:
            assert batcher.engine.post_warmup_recompiles() == 0
    finally:
        front.close()
        router.close()
        for batcher, frontend in stacks:
            frontend.close()
            batcher.close()


def test_in_process_restart_under_traffic_on_the_card(dev):
    """``crash@1:3`` kills a replica of a two-replica ``ChaosFleet``; the
    supervisor restarts it in this process, capturing its decode rungs as
    CUDA graphs while live traffic runs on the other replica. Every
    request completes with its direct tokens, the restarted engine's
    graph tallies equal the survivor's (no launch of the other replica
    landed in them), and nothing recompiles."""
    import threading

    from tensorflow_examples_torch.serving.chaos import ChaosFleet
    from tensorflow_examples_torch.serving.router import RouterConfig, RouterFrontend
    from tensorflow_examples_torch.utils import faults

    fault = faults.serve_install("crash@1:3")
    fleet = ChaosFleet([_fleet_engine] * 2, router_cfg=RouterConfig(
        probe_interval_s=0.1, retry_budget_s=60.0, max_retries=4, eject_after=1,
        eject_cooldown_s=1.0), supervisor_kw=dict(poll_s=0.05, health_stall_s=5.0,
                                                   warm_timeout_s=120.0))
    try:
        fleet.start()
        front = RouterFrontend(fleet.router).start()
        rng = np.random.default_rng(12)
        bodies = [{"prompt": [int(t) for t in rng.integers(0, 96, 10 + 3 * i)],
                   "max_new_tokens": 24, "seed": i} for i in range(8)]
        during, stop = [], threading.Event()

        def traffic(k):
            while not stop.is_set():
                during.append((k % 8, _post(front.url("/generate"), bodies[k % 8])))
                k += 2

        feeders = [threading.Thread(target=traffic, args=(k,), daemon=True) for k in (0, 1)]
        for t in feeders:
            t.start()
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
            crashed = list(pool.map(lambda b: _post(front.url("/generate"), b), bodies))
        assert fleet.await_fleet_green(2, timeout_s=120)
        stop.set()
        for t in feeders:
            t.join(120)
        assert ("crash", 1, 3) in fault.fired
        events = [e for u, e in fleet.supervisor.events if u == fleet.replicas[1].url]
        assert events[:3] == ["detected", "restarted", "readmitted"]
        direct = [_post(fleet.replicas[0].url + "/generate", b)[1]["tokens"] for b in bodies]
        assert [r["tokens"] for _, r in crashed] == direct
        assert during and all(r[0] == 200 and r[1]["tokens"] == direct[k] for k, r in during)
        survivor, restarted = (rep.engine for rep in fleet.replicas)
        assert restarted.graph_tallies() == survivor.graph_tallies()
        assert survivor.post_warmup_recompiles() == restarted.post_warmup_recompiles() == 0
        front.close()
    finally:
        faults.serve_clear()
        fleet.close()


def _imagenet_cfg(**kw):
    from tensorflow_examples_torch.workloads import imagenet

    return imagenet.ImagenetConfig(global_batch_size=8, train_steps=10, warmup_steps=5,
                                   eval_every=0, checkpoint_every=0, telemetry_sinks="", **kw)


def test_resnet50_step_on_the_card_matches_the_cpu_step(dev):
    """One ResNet-50 step at 224 px, batch 8, bf16 (the ImageNet
    workload's defaults otherwise), on the card and on the CPU from the
    same seeded weights and batch: loss, gradient norm and every running
    statistic agree at bf16 tolerance (2e-2 relative; statistics 2e-2 of
    each tensor's largest value)."""
    from tensorflow_examples_torch.data import imagenet as imagenet_data
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import imagenet

    batch = next(imagenet_data.synthetic_train_iter(8, seed=3))
    out = {}
    for device in ("cuda", "cpu"):
        cfg = _imagenet_cfg(device=device)
        trainer = Trainer(imagenet.make_task(cfg), cfg)
        metrics = trainer.train_step(batch)
        out[device] = ({k: float(v) for k, v in metrics.items()},
                       {k: t.float().cpu() for k, t in
                        trainer.state.model_state["batch_stats"].items()})
    (gpu, gpu_stats), (cpu, cpu_stats) = out["cuda"], out["cpu"]
    assert np.isfinite(gpu["loss"]) and gpu["bad_step"] == 0.0
    np.testing.assert_allclose(gpu["loss"], cpu["loss"], rtol=2e-2)
    np.testing.assert_allclose(gpu["grad_norm"], cpu["grad_norm"], rtol=2e-2)
    assert gpu_stats.keys() == cpu_stats.keys() and len(gpu_stats) == 106
    for k, t in cpu_stats.items():
        torch.testing.assert_close(gpu_stats[k], t, rtol=0,
                                   atol=2e-2 * max(float(t.abs().max()), 1e-6), msg=k)


def test_resnet50_step_fed_by_the_ports_jpeg_decode(dev, tmp_path, monkeypatch):
    """One ResNet-50 step on the card (224 px, batch 8, bf16) from a batch
    the port's JPEG stage decodes from shards of
    ``tests/data/imagenet_fixture.tfrecord`` with 2 decode workers: the
    decoder builds on this machine and links no libjpeg, the batch equals
    the inline decode's bit for bit, the loss is finite and every running
    statistic moves."""
    import os
    import subprocess

    from tensorflow_examples_torch import native
    from tensorflow_examples_torch.data import sources
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import imagenet

    monkeypatch.setenv("TFE_TPU_CACHE_DIR", str(tmp_path / "cache"))
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "imagenet_fixture.tfrecord")
    recs = list(sources.iter_tfrecord_records(fixture, verify_crc=True))
    root = tmp_path / "shards"
    root.mkdir()
    sources.write_tfrecord(str(root / "train-00000-of-00001"), recs[:16])
    cfg = _imagenet_cfg(data_dir=str(root), input_workers=2)
    it = imagenet.make_train_iter(cfg, 0)
    batch = next(it)
    it.close()
    inline = next(imagenet.make_train_iter(cfg.replace(input_workers=0), 0))
    assert native.available("jpeg"), native.build_errors
    needed = subprocess.run(["ldd", native.jpeg_library_path()], capture_output=True,
                            text=True).stdout
    assert "libjpeg" not in needed, needed
    assert batch["image"].shape == (8, 224, 224, 3)
    for k in batch:
        np.testing.assert_array_equal(batch[k], inline[k], err_msg=k)
    trainer = Trainer(imagenet.make_task(cfg), cfg)
    before = {k: t.clone() for k, t in trainer.state.model_state["batch_stats"].items()}
    metrics = trainer.train_step(batch)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["bad_step"]) == 0.0
    after = trainer.state.model_state["batch_stats"]
    assert all(not torch.equal(after[k], t) for k, t in before.items())


# ------------------------------------------------ sharded serving, one card

SHARDED_MODEL = dict(vocab_size=211, max_len=64, num_layers=2, num_heads=4, d_model=64)
SHARDED_CONFIGS = {"dense_flash": dict(attention="flash"),
                   "paged_flash_int8": dict(attention="paged_flash", kv_block_size=8,
                                            kv_dtype="int8")}
SHARDED_PROMPTS = ((5, 0.0), (17, 0.0), (30, 0.9), (3, 0.0))  # (prompt length, temperature)


def _sharded_requests():
    from tensorflow_examples_torch.serving.batcher import Request

    rng = np.random.default_rng(11)
    return [Request(prompt=[int(t) for t in rng.integers(0, 211, n)], max_new_tokens=8,
                    seed=i, temperature=temp) for i, (n, temp) in enumerate(SHARDED_PROMPTS)]


def _sharded_engine_on(device, sharding, kw, **extra):
    from tensorflow_examples_torch.models import transformer
    from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
    from tensorflow_examples_torch.telemetry.registry import MetricsRegistry

    cfg = transformer.TransformerConfig(**SHARDED_MODEL)
    return InferenceEngine(cfg, transformer.GPT2(cfg, seed=3), device=device, sharding=sharding,
                           registry=MetricsRegistry(),
                           cfg=ServeConfig(max_slots=4, prefill_bucket_floor=16,
                                           kv_bucket_floor=32, **kw), **extra)


def _serve_streams(engine) -> list:
    from tensorflow_examples_torch.serving.batcher import ContinuousBatcher

    batcher = ContinuousBatcher(engine).start()
    try:
        return [f.result(timeout=120).tokens for f in
                [batcher.submit(r) for r in _sharded_requests()]]
    finally:
        batcher.close()


def _sharded_serving_on_one_card(rank: int) -> dict:
    from tensorflow_examples_torch.serving.mesh_driver import MeshDriver
    from tensorflow_examples_torch.sharding import ShardingConfig

    sc = ShardingConfig(mesh={"model": 2})
    out = {"backend": torch.distributed.get_backend()}
    try:
        _sharded_engine_on("cuda", sc, {})
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    for name, kw in SHARDED_CONFIGS.items():
        engine = _sharded_engine_on("cuda", sc, kw, cuda_graphs=False)
        driver = MeshDriver()
        before = (decode.flash_decode_attention.launches,
                  paged_decode.paged_decode_attention.launches)
        if rank == 0:
            lead = driver.leader(engine)
            lead.warmup()
            out[name] = {"streams": _serve_streams(lead)}
            driver.stop()
        else:
            out[name] = {"replayed": driver.follow(engine)}
        out[name].update(
            launched=[decode.flash_decode_attention.launches - before[0],
                      paged_decode.paged_decode_attention.launches - before[1]],
            host_state=engine.pool.host_state(), heads=int(engine.pool.k.shape[2]),
            decode_steps=engine.registry.counter_values().get("serving/decode_steps", 0))
    return out


def test_two_rank_sharded_serving_on_one_card_matches_one_rank(dev, tmp_path):
    """A ``{model: 2}`` engine (2 of 4 heads a rank) on two ranks sharing
    the card over gloo: ``cuda_graphs=True`` is refused (host-staged
    collectives); eagerly, rank 0's batcher streams (greedy and sampled,
    dense ``flash`` and ``paged_flash`` int8) equal the one-rank engine's,
    flash-decode and the paged kernel launch on both ranks (the paged one
    once a layer a decode step), and the pools' host state is equal."""
    from tensorflow_examples_torch.core import distributed

    ranks = distributed.run_world(_sharded_serving_on_one_card, 2, device="cuda",
                                  timeout_s=240, store_dir=str(tmp_path))
    assert all(r["backend"] == "gloo" for r in ranks)
    assert all("cuda_graphs=True on a gloo mesh" in r["refused"] for r in ranks)
    for name, kw in SHARDED_CONFIGS.items():
        one = _sharded_engine_on("cuda", None, kw, cuda_graphs=False)
        one.warmup()
        assert ranks[0][name]["streams"] == _serve_streams(one), name
        assert ranks[0][name]["host_state"] == ranks[1][name]["host_state"], name
        assert ranks[0][name]["launched"] == ranks[1][name]["launched"], name
        assert all(r[name]["heads"] == 2 for r in ranks)
        flash, paged = ranks[0][name]["launched"]
        assert flash > 0, name
        if kw["attention"] == "paged_flash":
            layers = SHARDED_MODEL["num_layers"]
            # The warmup's decode rungs and the served decode steps, a layer each.
            assert paged >= layers * ranks[0][name]["decode_steps"] > 0, name


def _prefill_export(engine, req):
    slot = engine.pool.alloc()
    first, _ = engine.prefill(slot, req.prompt, seed=req.seed, temperature=req.temperature,
                              top_k=req.top_k)
    pages = engine.export_kv_pages(slot, req.prompt)
    engine.pool.free(slot)
    return first, pages


def _decode_on(engine, slot, first, req) -> list:
    toks = [first]
    while len(toks) < req.max_new_tokens:
        toks.append(engine.decode([(slot, toks[-1], req.seed, req.temperature, req.top_k)])[slot])
    engine.pool.free(slot)
    return toks


def _import_decode(engine, req, handoff) -> list:
    import json

    first, pages = handoff
    slot = engine.pool.alloc()
    engine.import_kv_pages(slot, json.loads(json.dumps(pages)), req.prompt)
    return _decode_on(engine, slot, first, req)


HANDOFF_KW = dict(attention="paged_flash", kv_block_size=16)


def _handoff_and_fsdp_on_one_card(rank: int, one_rank_pages: dict) -> dict:
    from tensorflow_examples_torch.serving.mesh_driver import MeshDriver
    from tensorflow_examples_torch.sharding import ShardingConfig

    out = {}
    for kv in ("", "int8"):
        for role in ("prefill", "decode"):
            engine = _sharded_engine_on("cuda", ShardingConfig(mesh={"model": 2}),
                                        dict(HANDOFF_KW, kv_dtype=kv, role=role),
                                        cuda_graphs=False)
            driver = MeshDriver()
            before = paged_decode.paged_decode_attention.launches
            if rank == 0:
                lead = driver.leader(engine)
                reqs = _sharded_requests()
                out[(kv, role)] = ([_prefill_export(lead, r) for r in reqs] if role == "prefill"
                                   else [_import_decode(lead, r, p)
                                         for r, p in zip(reqs, one_rank_pages[kv])])
                driver.stop()
            else:
                driver.follow(engine)
            out[(kv, role, "paged")] = paged_decode.paged_decode_attention.launches - before
            out[(kv, role, "host_state")] = engine.pool.host_state()
    engine = _sharded_engine_on("cuda", ShardingConfig(mesh={"fsdp": 2}), HANDOFF_KW,
                                cuda_graphs=False)
    driver = MeshDriver()
    if rank == 0:
        lead = driver.leader(engine)
        lead.warmup()
        out["fsdp"] = _serve_streams(lead)
        driver.stop()
    else:
        driver.follow(engine)
    out["fsdp_host_state"] = engine.pool.host_state()
    return out


def test_sharded_handoff_and_fsdp_serving_on_one_card(dev, tmp_path):
    """Two ranks sharing the card over gloo: a ``{model: 2}`` prefill
    engine's pages (its heads gathered over ``model``) decode on a
    one-rank engine, and a one-rank prefill engine's pages on a ``{model:
    2}`` decode engine (each rank sent its heads), f32 and int8 KV, each
    stream the one-rank mixed engine's and every decode step launching
    the paged kernel once a layer on each rank; ``paged_flash`` on
    ``{fsdp: 2}`` serves the one-rank engine's batcher streams."""
    from tensorflow_examples_torch.core import distributed

    reqs = _sharded_requests()
    layers = SHARDED_MODEL["num_layers"]
    steps = sum(r.max_new_tokens - 1 for r in reqs)
    one_pages = {kv: [_prefill_export(_sharded_engine_on(
        "cuda", None, dict(HANDOFF_KW, kv_dtype=kv, role="prefill"), cuda_graphs=False), r)
        for r in reqs] for kv in ("", "int8")}
    ranks = distributed.run_world(_handoff_and_fsdp_on_one_card, 2, one_pages, device="cuda",
                                  timeout_s=300, store_dir=str(tmp_path))
    for kv in ("", "int8"):
        mixed = _sharded_engine_on("cuda", None, dict(HANDOFF_KW, kv_dtype=kv),
                                   cuda_graphs=False)
        want = []
        for r in reqs:
            slot = mixed.pool.alloc()
            first, _ = mixed.prefill(slot, r.prompt, seed=r.seed, temperature=r.temperature,
                                     top_k=r.top_k)
            want.append(_decode_on(mixed, slot, first, r))
        assert ranks[0][(kv, "decode")] == want, kv
        one_dec = _sharded_engine_on("cuda", None, dict(HANDOFF_KW, kv_dtype=kv, role="decode"),
                                     cuda_graphs=False)
        assert [_import_decode(one_dec, r, p) for r, p in
                zip(reqs, ranks[0][(kv, "prefill")])] == want, kv
        for role in ("prefill", "decode"):
            assert ranks[0][(kv, role, "host_state")] == ranks[1][(kv, role, "host_state")]
            assert all(r[(kv, role, "paged")] == (layers * steps if role == "decode" else 0)
                       for r in ranks), (kv, role)
    one = _sharded_engine_on("cuda", None, HANDOFF_KW, cuda_graphs=False)
    one.warmup()
    assert ranks[0]["fsdp"] == _serve_streams(one)
    assert ranks[0]["fsdp_host_state"] == ranks[1]["fsdp_host_state"]
