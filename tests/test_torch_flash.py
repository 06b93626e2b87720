"""The port's flash attention against the JAX package's (PyTorch/CUDA port).

The same inputs, made with numpy from a seed, go through the JAX
``flash_attention`` (its Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them on the CPU) and the port's
``flash_attention`` on the CPU, where each kernel wrapper runs its plain
PyTorch version. Mirrors ``TestFlashAttention``: forward f32 and bf16,
causal and not, gradients in f32 and bf16, uneven and cross lengths, the
lse output and its exact cotangent, the key bias and its zero cotangent,
and the ``seq_q > seq_kv`` rejection; plus each plain kernel version
against the JAX kernel function it stands for (``_flash_fwd`` /
``_flash_bwd``).
Tolerances are the JAX suite's: atol 2e-5 (f32 forward), 2e-2 (bf16),
5e-4 (gradients); bf16 gradients: one bf16 rounding (2^-7) of each value
plus 1e-3 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.ops import attention as jax_attention
from tensorflow_examples_torch.ops import attention


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run beside timing-sensitive
    serving tests in other workers and must not starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape_q, shape_kv=None, *, seed=0):
    rng = np.random.default_rng(seed)
    shape_kv = shape_kv or shape_q
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32))


def _torch(*xs, dtype=torch.float32, grad=False):
    return [torch.from_numpy(x).to(dtype).requires_grad_(grad) for x in xs]


def _jax(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


def _grads_both(q, k, v, *, causal, key_bias=None, jax_blocks=None):
    """Grads of sum(o**2) w.r.t. q, k, v: (port, JAX flash)."""
    tq, tk, tv = _torch(q, k, v, grad=True)
    kb = None if key_bias is None else torch.from_numpy(key_bias)
    out = attention.flash_attention(tq, tk, tv, causal=causal, key_bias=kb)
    ours = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    jkb = None if key_bias is None else jnp.asarray(key_bias)
    blocks = jax_blocks or {}
    theirs = jax.grad(
        lambda a, b, c: jnp.sum(jax_attention.flash_attention(
            a, b, c, causal=causal, key_bias=jkb, **blocks) ** 2),
        argnums=(0, 1, 2),
    )(*_jax(q, k, v))
    return ours, theirs


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [128, 256])
def test_forward_matches_jax_flash(causal, seq):
    q, k, v = _inputs((2, 3, seq, 64))
    ours = attention.flash_attention(*_torch(q, k, v), causal=causal)
    theirs = jax_attention.flash_attention(*_jax(q, k, v), causal=causal, block_q=128,
                                           block_kv=128)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5, rtol=2e-5)


def test_forward_bf16():
    q, k, v = _inputs((1, 2, 256, 64), seed=1)
    ours = attention.flash_attention(*_torch(q, k, v, dtype=torch.bfloat16), causal=True)
    theirs = jax_attention.flash_attention(*_jax(q, k, v, dtype=jnp.bfloat16), causal=True)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax_flash(causal):
    q, k, v = _inputs((1, 2, 256, 64), seed=2)
    ours, theirs = _grads_both(q, k, v, causal=causal)
    for a, b, name in zip(ours, theirs, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [256, 200])
def test_gradients_bf16_match_jax_flash(causal, seq):
    """bf16 q, k, v and cotangent: dq, dk, dv through the port's plain
    path against the JAX kernels (interpret mode). Both compute in f32
    from the same bf16 values and round O and each gradient to bf16, in
    sums of different order, so a value may land one bf16 rounding away:
    the tolerance is 2^-7 of each value plus 1e-3 of the largest
    gradient."""
    q, k, v = _inputs((1, 2, seq, 64), seed=13)
    do = np.random.default_rng(14).standard_normal((1, 2, seq, 64)).astype(np.float32)
    tq, tk, tv = _torch(q, k, v, dtype=torch.bfloat16, grad=True)
    out = attention.flash_attention(tq, tk, tv, causal=causal)
    ours = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do).to(torch.bfloat16))
    _, vjp = jax.vjp(lambda a, b, c: jax_attention.flash_attention(a, b, c, causal=causal),
                     *_jax(q, k, v, dtype=jnp.bfloat16))
    theirs = vjp(jnp.asarray(do, jnp.bfloat16))
    for a, b, name in zip(ours, theirs, "qkv"):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, atol=1e-3 * np.abs(b).max(), rtol=2**-7,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("seq", [77, 100, 200])
def test_uneven_lengths(seq):
    """Lengths that are not a tile multiple: the port masks its last
    tile; the JAX kernel runs them as one block."""
    q, k, v = _inputs((1, 2, seq, 64), seed=3)
    ours = attention.flash_attention(*_torch(q, k, v), causal=True)
    theirs = jax_attention.flash_attention(*_jax(q, k, v), causal=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5, rtol=2e-5)
    ours, theirs = _grads_both(q, k, v, causal=True)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4, rtol=5e-4)


def test_cross_attention_lengths():
    """seq_q != seq_kv: the causal diagonal is bottom-right aligned."""
    q, k, v = _inputs((1, 2, 128, 64), (1, 2, 384, 64), seed=5)
    for causal in (True, False):
        ours = attention.flash_attention(*_torch(q, k, v), causal=causal)
        theirs = jax_attention.flash_attention(*_jax(q, k, v), causal=causal, block_q=64,
                                               block_kv=128)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5, rtol=2e-5)
    ours, theirs = _grads_both(q, k, v, causal=True)
    for a, b, name in zip(ours, theirs, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{name}")


def test_with_lse_and_its_cotangent():
    """Both outputs and the grads of a loss that uses the lse, so the
    ``dlse`` term of ``ds = p (dp - delta + dlse)`` is exercised."""
    q, k, v = _inputs((1, 2, 128, 64), (1, 2, 192, 64), seed=6)
    w = np.random.default_rng(7).standard_normal((1, 2, 128)).astype(np.float32)
    tq, tk, tv = _torch(q, k, v, grad=True)
    o, lse = attention.flash_attention_with_lse(tq, tk, tv, causal=True)
    ours = torch.autograd.grad((o ** 2).sum() + (lse * torch.from_numpy(w)).sum(), (tq, tk, tv))

    def loss(a, b, c):
        jo, jlse = jax_attention.flash_attention_with_lse(a, b, c, causal=True)
        return jnp.sum(jo ** 2) + jnp.sum(jlse * w)

    jo, jlse = jax_attention.flash_attention_with_lse(*_jax(q, k, v), causal=True)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), atol=2e-5, rtol=2e-5)
    theirs = jax.grad(loss, argnums=(0, 1, 2))(*_jax(q, k, v))
    for a, b, name in zip(ours, theirs, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_key_bias_matches_jax(causal):
    q, k, v = _inputs((2, 3, 256, 64), seed=8)
    kb = np.zeros((2, 256), np.float32)
    kb[0, -77:] = attention.NEG_INF
    ours = attention.flash_attention(*_torch(q, k, v), causal=causal,
                                     key_bias=torch.from_numpy(kb))
    theirs = jax_attention.flash_attention(*_jax(q, k, v), causal=causal,
                                           key_bias=jnp.asarray(kb), block_q=64, block_kv=64)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5, rtol=2e-5)


def test_key_bias_gradients_and_zero_cotangent():
    q, k, v = _inputs((1, 2, 128, 64), seed=9)
    kb = np.where(np.arange(128) < 100, 0.0, attention.NEG_INF)[None].astype(np.float32)
    ours, theirs = _grads_both(q, k, v, causal=False, key_bias=kb)
    for a, b, name in zip(ours, theirs, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{name}")
    assert float(ours[1][:, :, 100:].abs().max()) == 0.0  # masked keys: no dk
    assert float(ours[2][:, :, 100:].abs().max()) == 0.0  # nor dv
    tq, tk, tv, tkb = _torch(q, k, v, kb, grad=True)
    out = attention.flash_attention(tq, tk, tv, causal=False, key_bias=tkb)
    (g_kb,) = torch.autograd.grad(out.sum(), (tkb,))
    assert torch.equal(g_kb, torch.zeros_like(g_kb))


@pytest.mark.parametrize("fn", [attention.flash_attention, attention.flash_attention_with_lse])
def test_causal_rejects_more_queries_than_keys(fn):
    q, k, v = _torch(*_inputs((1, 1, 64, 64), (1, 1, 32, 64)))
    with pytest.raises(ValueError, match="seq_q"):
        fn(q, k, v, causal=True)
    fn(q, k, v, causal=False)  # non-causal cross lengths are fine


def test_dot_product_attention_dispatches():
    q, k, v = _inputs((1, 2, 64, 64), seed=10)
    tq, tk, tv = _torch(q, k, v)
    flash = attention.dot_product_attention(tq, tk, tv)
    plain = attention.dot_product_attention(tq, tk, tv, use_flash=False)
    torch.testing.assert_close(flash, attention.flash_attention(tq, tk, tv))
    torch.testing.assert_close(plain, attention.attention_reference(tq, tk, tv))
    torch.testing.assert_close(flash, plain, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal,bias", [(True, False), (False, True)])
def test_plain_kernel_versions_match_jax_kernels(causal, bias):
    """Each plain version against the JAX kernel function it stands for,
    on the folded [BH, seq, 64] layout, with a nonzero lse cotangent."""
    _check_plain_kernel_versions(causal, bias, 64)


@pytest.mark.parametrize("head_dim", [8, 16, 128])
@pytest.mark.parametrize("causal,bias", [(True, False), (False, True)])
def test_plain_kernel_versions_match_jax_kernels_at_other_head_dims(causal, bias, head_dim):
    """The same at head_dims the kernels also take: 1/sqrt(D) is no power
    of two at 8 and 128."""
    _check_plain_kernel_versions(causal, bias, head_dim)


def _check_plain_kernel_versions(causal, bias, d):
    b, h, seq_q, seq_kv = 2, 2, 128, 192
    q, k, v = _inputs((b * h, seq_q, d), (b * h, seq_kv, d), seed=11)
    rng = np.random.default_rng(12)
    do = rng.standard_normal((b * h, seq_q, d)).astype(np.float32)
    dlse = rng.standard_normal((b * h, seq_q)).astype(np.float32)
    kb = None
    if bias:
        kb = np.zeros((b, seq_kv), np.float32)
        kb[1, 150:] = -1e9
    scale = d ** -0.5
    jkb = None if kb is None else jnp.asarray(kb)
    jo, jlse = jax_attention._flash_fwd(*_jax(q, k, v), scale, causal, 64, 64, True,
                                        kb=jkb, heads=h)
    jdq, jdk, jdv = jax_attention._flash_bwd(
        scale, causal, 64, 64, True, (*_jax(q, k, v), jo, jlse), jnp.asarray(do),
        jnp.asarray(dlse)[..., None], kb=jkb, heads=h,
    )
    tq, tk, tv, tdo, tdlse = _torch(q, k, v, do, dlse)
    tkb = None if kb is None else torch.from_numpy(kb)
    kw = dict(heads=h, causal=causal, sm_scale=scale)
    o, lse = attention.flash_fwd_plain(tq, tk, tv, tkb, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], atol=2e-5, rtol=2e-5)
    delta = (tdo * o).sum(-1)
    args = (tq, tk, tv, tdo, lse, delta, tdlse, tkb)
    dk, dv = attention.flash_bwd_dkv_plain(*args, **kw)
    dq = attention.flash_bwd_dq_plain(*args, **kw)
    for a, b_, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=5e-4, rtol=5e-4,
                                   err_msg=name)
    # On the CPU the wrappers are the plain versions.
    o2, lse2 = attention.flash_fwd(tq, tk, tv, tkb, **kw)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert torch.equal(attention.flash_bwd_dq(*args, **kw), dq)
