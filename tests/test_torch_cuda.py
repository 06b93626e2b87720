"""The port's CUDA kernels against their plain PyTorch versions, on the
card (PyTorch/CUDA port).

Every test here carries the ``cuda`` marker and skips where no GPU is
visible. The file imports no jax, so it also runs on a machine without
it; ``tests/conftest.py`` does import jax, hence on the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances are the JAX suite's for the same kernels: atol 2e-5 for f32
flash-decode and flash forward, 2e-2 for bf16, 5e-4 for f32 flash
gradients, 2e-6 for paged decode (fp32 and int8), the same at every
head_dim the attention kernels take; for the fused
cross-entropy kernels 1e-5 (f32) and 2e-2 (bf16) on the NLL and lse,
and on dlogits 1e-6 (f32) or one bf16 ulp, 8e-3 relative, of each
value (bf16); for the grouped-matmul kernels and the MoE bias gathers'
segmented sum (``group_row_sum``) 1e-4 of the largest value (f32), plus
one bf16 rounding of each value (bf16).
"""

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
    """Block 64 at head_dim 128 takes two staged chunks a block."""
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
