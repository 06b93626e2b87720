"""The port's Mixture-of-Experts slice against the JAX package
(PyTorch/CUDA port).

* ``ops/grouped_matmul.py``: the plain versions of the ``gmm``/``tgmm``
  kernels and the autograd Function's gradients against megablox's
  ``gmm``/``tgmm`` in interpret mode (the TPU kernels the reference runs)
  and against ``lax.ragged_dot``, with empty groups and ``transpose_rhs``;
  f32, atol 1e-5 (sums of at most 48 products of unit normals); the plain
  ``group_row_sum`` and the bias gather ``parallel/moe.py``
  ``_TakeGroupRows`` against ``jnp.take`` and its ``jax.vjp`` with empty
  first, middle and last groups and one-row groups, f32, atol 1e-6; the
  tensor-core ``tgmm``'s partial-sum scratch bound against every split.
* ``parallel/moe.py``: ``moe_ffn`` against the JAX ``moe_ffn`` with the
  same ``impl`` pinned on both sides (the default resolves by device, and
  ``scatter`` drops at capacity where ``grouped`` never drops): outputs,
  aux loss, drop fraction and gradients at the JAX suite's tolerances
  (atol 2e-5 outputs, 5e-4 gradients, ``tests/test_parallel.py``), with
  and without router jitter. The jitter key (``core/rng.fold_in_static``,
  flax's ``_fold_in_static``) and the jitter itself equal jax's bit for
  bit.
* An MoE GPT-2 (2 layers, d 32, 4 experts, top-2, the MoE in ``h_1``) at
  f32 and dropout 0: logits against flax ``Transformer.apply`` at
  ``train=True`` with a dropout rng (so the router jitters), one step's
  loss, ``moe_aux`` and every gradient against ``jax.value_and_grad``, a
  5-step trajectory against the JAX ``Trainer`` at rtol 3e-3, greedy
  ``generate`` against the JAX ``generate``, the param count on the meta
  device against JAX's ``eval_shape`` (the full-width ``moe_bench_config``
  model included), the weight bridge both ways, and the serving engine's
  refusal of MoE models.
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import _fold_in_static
from jax.experimental.pallas.ops.tpu.megablox import ops as megablox

from tensorflow_examples_tpu.data import memory as jax_memory
from tensorflow_examples_tpu.models import transformer as jax_transformer
from tensorflow_examples_tpu.parallel import moe as jax_moe
from tensorflow_examples_tpu.sharding import ShardingConfig
from tensorflow_examples_tpu.train import loop as jax_loop
from tensorflow_examples_tpu.workloads import gpt2 as jax_gpt2
from tensorflow_examples_torch.core import rng
from tensorflow_examples_torch.data import memory
from tensorflow_examples_torch.models import convert, transformer
from tensorflow_examples_torch.ops import grouped_matmul as gm
from tensorflow_examples_torch.parallel import moe
from tensorflow_examples_torch.serving.engine import InferenceEngine
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.workloads import gpt2

# The megablox kernel module (the package's ``gmm`` name is the custom-vjp
# op, which shadows the submodule).
megablox_kernels = importlib.import_module("jax.experimental.pallas.ops.tpu.megablox.gmm")
TILING = (8, 8, 8)  # megablox tiles for the interpret-mode runs (tm divides m)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run beside timing-sensitive
    serving tests in other workers and must not starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------- grouped matmul


SIZES = {
    "skewed": [20, 0, 5, 15, 8],           # an empty group inside
    "empty_ends": [0, 24, 24, 0],          # empty groups first and last
    "one_group": [48],                     # every row in one group
    "single_rows": [1, 0, 46, 1],          # groups of one row
}


def _operands(sizes, k=24, n=40, transpose_rhs=False, seed=0):
    r = np.random.default_rng(seed)
    m, g = sum(sizes), len(sizes)
    lhs = r.standard_normal((m, k)).astype(np.float32)
    rhs = r.standard_normal((g, n, k) if transpose_rhs else (g, k, n)).astype(np.float32)
    grad = r.standard_normal((m, n)).astype(np.float32)
    return lhs, rhs, np.asarray(sizes, np.int32), grad


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("case", sorted(SIZES))
def test_gmm_plain_matches_megablox_and_ragged_dot(case, transpose_rhs):
    lhs, rhs, sizes, _ = _operands(SIZES[case], transpose_rhs=transpose_rhs)
    theirs = megablox.gmm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(sizes), jnp.float32,
                          TILING, None, None, transpose_rhs, True)
    w = np.swapaxes(rhs, 1, 2) if transpose_rhs else rhs
    ragged = jax.lax.ragged_dot(jnp.asarray(lhs), jnp.asarray(w), jnp.asarray(sizes))
    ours = gm.gmm(t(lhs), t(rhs), t(sizes), transpose_rhs=transpose_rhs).numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours, np.asarray(ragged), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", sorted(SIZES))
def test_tgmm_plain_matches_megablox_with_exact_zeros(case):
    lhs, _, sizes, grad = _operands(SIZES[case])
    theirs = np.asarray(megablox_kernels.tgmm(
        jnp.asarray(lhs.T), jnp.asarray(grad), jnp.asarray(sizes), jnp.float32, TILING,
        interpret=True))
    for lhs_t in (t(lhs).T, t(lhs).T.contiguous()):  # the view the backward passes, and a copy
        ours = gm.tgmm(lhs_t, t(grad), t(sizes)).numpy()
        assert ours.shape == (len(sizes), 24, 40)
        np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
        for i, size in enumerate(sizes):
            if size == 0:
                assert not ours[i].any()


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("case", ["skewed", "empty_ends"])
def test_grouped_matmul_grads_match_megablox_vjp(case, transpose_rhs):
    """dlhs through gmm (rhs transposed the other way) and drhs through
    tgmm, as megablox's ``_gmm_bwd``."""
    lhs, rhs, sizes, grad = _operands(SIZES[case], transpose_rhs=transpose_rhs, seed=1)

    def f(a, b):
        out = megablox.gmm(a, b, jnp.asarray(sizes), jnp.float32, TILING, None, None,
                           transpose_rhs, True)
        return jnp.sum(out * grad)

    dl, dr = jax.grad(f, argnums=(0, 1))(jnp.asarray(lhs), jnp.asarray(rhs))
    a, b = t(lhs).requires_grad_(), t(rhs).requires_grad_()
    out = gm.grouped_matmul(a, b, t(sizes), transpose_rhs=transpose_rhs)
    (out * t(grad)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(dl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(dr), atol=1e-5, rtol=0)


def test_gmm_zeroes_rows_past_the_last_group_and_keeps_the_dtype():
    lhs, rhs, _, _ = _operands([10, 10])
    sizes = np.array([6, 4], np.int32)  # 10 of 20 rows covered
    ours = gm.gmm(t(lhs).bfloat16(), t(rhs).bfloat16(), t(sizes))
    assert ours.dtype == torch.bfloat16 and not ours[10:].float().any()
    ragged = jax.lax.ragged_dot(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(sizes))
    np.testing.assert_allclose(gm.gmm(t(lhs), t(rhs), t(sizes)).numpy(), np.asarray(ragged),
                               atol=1e-5, rtol=0)


ROW_SUM_SIZES = {
    "empty_first": [0, 7, 3, 5],
    "empty_middle": [4, 0, 0, 9],
    "empty_last": [6, 2, 8, 0],
    "one_row": [1, 10, 1, 3],
}


def _sorted_ids(sizes):
    return np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)


@pytest.mark.parametrize("case", sorted(ROW_SUM_SIZES))
def test_group_row_sum_plain_matches_the_vjp_of_jnp_take(case):
    """The sorted-segment sum is the cotangent ``jax.vjp`` of
    ``jnp.take(b, ids, axis=0)`` gives ``b`` (a scatter-add there), f32
    at atol 1e-6 (sums of at most 10 unit normals)."""
    sizes = np.asarray(ROW_SUM_SIZES[case], np.int32)
    ids = _sorted_ids(sizes)
    r = np.random.default_rng(len(ids))
    b = r.standard_normal((len(sizes), 6)).astype(np.float32)
    grad = r.standard_normal((len(ids), 6)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jnp.take(v, jnp.asarray(ids), axis=0), jnp.asarray(b))
    (theirs,) = vjp(jnp.asarray(grad))
    ours = gm.group_row_sum(t(grad), t(sizes)).numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=1e-6, rtol=0)
    for i, size in enumerate(sizes):
        if size == 0:
            assert not ours[i].any()


@pytest.mark.parametrize("case", sorted(ROW_SUM_SIZES))
def test_take_group_rows_matches_jnp_take_and_its_vjp(case):
    sizes = np.asarray(ROW_SUM_SIZES[case], np.int32)
    ids = _sorted_ids(sizes)
    r = np.random.default_rng(len(ids) + 1)
    b = r.standard_normal((len(sizes), 5)).astype(np.float32)
    grad = r.standard_normal((len(ids), 5)).astype(np.float32)
    theirs, vjp = jax.vjp(lambda v: jnp.take(v, jnp.asarray(ids), axis=0), jnp.asarray(b))
    leaf = t(b).requires_grad_()
    ours = moe._take_group_rows(leaf, t(ids).long(), t(sizes))
    np.testing.assert_array_equal(ours.detach().numpy(), np.asarray(theirs))
    (ours * t(grad)).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(vjp(jnp.asarray(grad))[0]),
                               atol=1e-6, rtol=0)


def test_group_row_sum_plain_keeps_the_dtype_and_skips_rows_past_the_groups():
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    sizes = torch.tensor([2, 0, 3, 1], dtype=torch.int32)  # 6 of 8 rows covered
    want = torch.stack([x[0:2].sum(0), torch.zeros(3), x[2:5].sum(0), x[5]])
    torch.testing.assert_close(gm.group_row_sum(x, sizes), want, rtol=0, atol=0)
    torch.testing.assert_close(gm.group_row_sum(x, sizes, 2), want[:2], rtol=0, atol=0)
    out = gm.group_row_sum(x.bfloat16(), sizes)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 3)


def test_grouped_moe_backward_sums_the_biases_through_group_row_sum(monkeypatch):
    """Both bias gathers of the grouped dispatch take their gradient from
    ``group_row_sum``, looked up at each call, and from nothing else."""
    calls = []

    def spy(x, sizes, num_groups=None):
        calls.append((tuple(x.shape), num_groups))
        return gm.group_row_sum_plain(x, sizes, num_groups)

    monkeypatch.setattr(gm, "group_row_sum", spy)
    leaves = [t(a).requires_grad_() for a in _moe_args()]
    out, aux, _ = moe.moe_ffn(*leaves, top_k=2, impl="grouped")
    (torch.sum(out ** 2) + 0.01 * aux).backward()
    assert sorted(calls) == [((32, 16), 4), ((32, 32), 4)]  # b_out [E, d], b_in [E, ff]


@pytest.mark.parametrize("dtype,k,m,n,layout,tensor_cores", [
    (torch.bfloat16, 768, 16384, 3072, "mk", True),    # the MoE step's lhs.T
    (torch.bfloat16, 768, 1554, 3072, "mk", True),     # lhs.T takes any m
    (torch.bfloat16, 768, 1554, 3072, "km", False),    # a contiguous [k, m] needs m % 8 == 0
    (torch.bfloat16, 768, 1552, 3072, "km", True),
    (torch.bfloat16, 100, 1552, 36, "mk", False),      # k and n not multiples of 8
    (torch.float32, 768, 16384, 3072, "mk", False),    # f32 stays SIMT
])
def test_tgmm_tensor_core_eligibility(dtype, k, m, n, layout, tensor_cores):
    lhs_t = torch.zeros(m, k, dtype=dtype).T if layout == "mk" else torch.zeros(k, m, dtype=dtype)
    assert gm.tgmm_uses_tensor_cores(lhs_t, torch.zeros(m, n, dtype=dtype)) == tensor_cores


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_tgmm_partial_slots_bound_every_split(rows):
    """The scratch a tensor-core tgmm allocates holds one [k, n] partial
    for every chunk of a group of more than ``rows`` rows, for every way
    of cutting m rows into g groups, and is tight for some of them."""
    import itertools

    for m in range(0, 19):
        for g in (1, 2, 3, 4):
            most = 0
            for cuts in itertools.combinations_with_replacement(range(m + 1), g - 1):
                bounds = (0, *cuts, m)
                sizes = [b - a for a, b in zip(bounds, bounds[1:])]
                most = max(most, sum(-(-s // rows) for s in sizes if s > rows))
            bound = gm._tgmm_partial_slots(m, g, rows)
            assert most <= bound <= most + 1, (m, g, rows, most, bound)


def test_permute_rows_backward_is_the_inverse_gather():
    x = torch.randn(6, 3, dtype=torch.float64, requires_grad=True)
    perm = torch.tensor([3, 0, 5, 1, 4, 2])
    inv = torch.argsort(perm)
    g = torch.randn(6, 3, dtype=torch.float64)
    (moe._permute_rows(x, perm, inv) * g).sum().backward()
    torch.testing.assert_close(x.grad, g[inv], rtol=0, atol=0)
    assert torch.autograd.gradcheck(lambda y: moe._permute_rows(y, perm, inv), (x,))


# --------------------------------------------------------------- moe_ffn


def _moe_args(b=2, s=8, d=16, e=4, ff=32, seed=0):
    """Router, experts and tokens as numpy arrays (the JAX suite's scales)."""
    r = np.random.default_rng(seed)
    return (r.standard_normal((d, e)).astype(np.float32),
            (r.standard_normal((e, d, ff)) * 0.1).astype(np.float32),
            (r.standard_normal((e, ff)) * 0.1).astype(np.float32),
            (r.standard_normal((e, ff, d)) * 0.1).astype(np.float32),
            (r.standard_normal((e, d)) * 0.1).astype(np.float32),
            r.standard_normal((b, s, d)).astype(np.float32))


MOE_CASES = [
    # (impl, top_k, capacity_factor, jitter key)
    ("grouped", 1, 1.25, None),
    ("grouped", 2, 1.25, None),
    ("grouped", 2, 1.25, 7),
    ("scatter", 1, 8.0, None),
    ("scatter", 2, 8.0, 7),
    ("scatter", 2, 0.5, None),  # drops at capacity
    ("scatter", 1, 0.25, 3),
]


@pytest.mark.parametrize("impl,top_k,capacity_factor,key", MOE_CASES)
def test_moe_ffn_matches_jax(impl, top_k, capacity_factor, key):
    args = _moe_args()
    jkey = None if key is None else jax.random.PRNGKey(key)
    kw = dict(capacity_factor=capacity_factor, top_k=top_k, impl=impl)

    def jax_loss(*a):
        out, aux, drop = jax_moe.moe_ffn(*a, rng=jkey, **kw)
        return jnp.sum(out ** 2) + 0.01 * aux, (out, aux, drop)

    (_, (j_out, j_aux, j_drop)), j_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4, 5), has_aux=True)(*map(jnp.asarray, args))
    leaves = [t(a).requires_grad_() for a in args]
    jitter = None if key is None else (lambda shape, lo, hi, device: torch.from_numpy(
        rng.uniform(np.asarray(jkey), shape, lo, hi)).to(device))
    out, aux, drop = moe.moe_ffn(*leaves, rng=jitter, **kw)
    (torch.sum(out ** 2) + 0.01 * aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(aux.detach()), float(j_aux), rtol=1e-5)
    assert float(drop) == pytest.approx(float(j_drop), abs=1e-7)
    if impl == "grouped":
        assert float(drop) == 0.0
    elif capacity_factor < 1:
        assert float(drop) > 0.0
    for name, leaf, g in zip(("gate", "w_in", "b_in", "w_out", "b_out", "x"), leaves, j_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("top_k", [1, 2])
def test_grouped_matches_scatter_when_nothing_drops(top_k):
    args = [t(a) for a in _moe_args(seed=3)]
    want, aux_w, _ = moe.moe_ffn(*args, capacity_factor=8.0, top_k=top_k, impl="scatter")
    got, aux_g, drop_g = moe.moe_ffn(*args, capacity_factor=8.0, top_k=top_k, impl="grouped")
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(aux_g, aux_w, atol=0, rtol=1e-5)
    assert float(drop_g) == 0.0


def test_moe_impl_default_follows_the_device_and_unknown_raises():
    args = [t(a) for a in _moe_args()]
    scatter = moe.moe_ffn(*args, capacity_factor=0.25, impl="scatter")
    for impl in ("", None):  # the CPU's default is the scatter formulation
        out, _, drop = moe.moe_ffn(*args, capacity_factor=0.25, impl=impl)
        torch.testing.assert_close(out, scatter[0], rtol=0, atol=0)
        assert float(drop) == float(scatter[2]) > 0
    with pytest.raises(ValueError, match="impl"):
        moe.moe_ffn(*args, impl="dense")


@pytest.mark.parametrize("parts", [("h_1", "moe", 1), ("h_11", "moe", 1), ("a", 0, 300, "é"),
                                   ()])
def test_fold_in_static_matches_flax(parts):
    key = jax.random.PRNGKey(5)
    assert np.array_equal(rng.fold_in_static(np.asarray(key), parts),
                          np.asarray(_fold_in_static(key, parts)))


def test_router_jitter_equals_jax_bit_for_bit():
    """The jitter the router adds: the flax key of ``h_1``'s MoeMlp, then
    ``uniform(-1e-2, 1e-2)`` over the [n, E] logits."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    jkey = _fold_in_static(key, ("h_1", "moe", 1))
    theirs = np.asarray(jax.random.uniform(jkey, (96, 8), jnp.float32, -1e-2, 1e-2))
    ours = rng.uniform(rng.fold_in_static(np.asarray(key), ("h_1", "moe", 1)), (96, 8), -1e-2,
                       1e-2)
    assert np.array_equal(ours.view(np.uint32), theirs.view(np.uint32))


@pytest.mark.parametrize("impl", ["grouped", "scatter"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_router_gets_task_gradient(top_k, impl):
    """top-1 keeps the raw router probability as its gate (Switch), so the
    task loss alone trains the router; top-2 renormalizes and still does
    (``tests/test_train_gpt2.py``'s test)."""
    d, e, ff, n = 8, 4, 16, 32
    r = np.random.default_rng(0)
    gate = t(r.standard_normal((d, e)).astype(np.float32)).requires_grad_()
    rest = (t((r.standard_normal((e, d, ff)) * 0.1).astype(np.float32)), torch.zeros(e, ff),
            t((r.standard_normal((e, ff, d)) * 0.1).astype(np.float32)), torch.zeros(e, d),
            t(r.standard_normal((1, n, d)).astype(np.float32)))
    out, _, _ = moe.moe_ffn(gate, *rest, top_k=top_k, impl=impl)
    (g,) = torch.autograd.grad(torch.sum(out ** 2), (gate,))
    assert float(g.abs().max()) > 1e-6


# ----------------------------------------------------------- MoE GPT-2


def tiny(**kw):
    """``tests/test_train_gpt2.py``'s tiny config with 4 experts, top-2,
    as (JAX, port) workload configs; the impl pinned on both sides."""
    base = dict(vocab_size=64, seq_len=16, num_layers=2, num_heads=4, d_model=32, dropout=0.0,
                attention="xla", global_batch_size=16, train_steps=30, warmup_steps=5,
                learning_rate=3e-3, log_every=10, eval_every=0, precision="f32",
                moe_experts=4, moe_top_k=2, moe_every=2, moe_impl="grouped")
    base.update(kw)
    return jax_gpt2.Gpt2Config(checkpoint_every=0, **base), gpt2.Gpt2Config(device="cpu", **base)


def port_model_config(jax_cfg) -> transformer.TransformerConfig:
    fields = {f.name for f in dataclasses.fields(transformer.TransformerConfig)}
    return transformer.TransformerConfig(**{k: v for k, v in dataclasses.asdict(jax_cfg).items()
                                            if k in fields})


@pytest.fixture(scope="module")
def moe_params():
    jax_cfg, _ = tiny()
    params = jax_transformer.Transformer(jax_gpt2.model_config(jax_cfg)).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def torch_params(tree, requires_grad=False):
    return {k.replace("/", "."): t(v).requires_grad_(requires_grad)
            for k, v in convert.flatten_tree(tree).items()}


def tiny_tokens(seed=0, n=16):
    return np.random.default_rng(seed).integers(0, 64, (n, 17)).astype(np.int32)


@pytest.mark.parametrize("impl", ["grouped", "scatter"])
def test_moe_logits_match_flax_with_router_jitter(moe_params, impl):
    jax_cfg, cfg = tiny(moe_impl=impl)
    tokens = tiny_tokens()[:4, :16]
    key = jax.random.PRNGKey(4)
    theirs, state = jax_transformer.Transformer(jax_gpt2.model_config(jax_cfg)).apply(
        {"params": moe_params}, jnp.asarray(tokens), train=True, rngs={"dropout": key},
        mutable=["intermediates"])
    ours, aux, drop = transformer.forward(
        gpt2.model_config(cfg), transformer.ParamView(torch_params(moe_params)), t(tokens),
        train=True, noise=rng.StepNoise(np.asarray(key)), moe_stats=True)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), atol=1e-5, rtol=1e-5)
    sown = state["intermediates"]["h_1"]["moe"]
    np.testing.assert_allclose(float(aux), float(sown["moe_aux"][0]), rtol=1e-6)
    assert float(drop) == pytest.approx(float(sown["moe_drop"][0]), abs=1e-7)


def test_moe_jitter_changes_routing_and_only_at_train(moe_params):
    """The jitter is on at train=True with a key and nowhere else: without
    it the train forward equals the eval forward."""
    _, cfg = tiny()
    mcfg = gpt2.model_config(cfg)
    params = transformer.ParamView(torch_params(moe_params))
    tokens = t(tiny_tokens()[:4, :16])
    plain = transformer.forward(mcfg, params, tokens)
    torch.testing.assert_close(transformer.forward(mcfg, params, tokens, train=True), plain,
                               rtol=0, atol=0)
    jittered = transformer.forward(mcfg, params, tokens, train=True,
                                   noise=rng.StepNoise(rng.PRNGKey(0)))
    assert not torch.equal(jittered, plain)


@pytest.mark.parametrize("impl", ["grouped", "scatter"])
def test_moe_step_loss_aux_and_every_grad_match_jax(moe_params, impl):
    jax_cfg, cfg = tiny(moe_impl=impl)
    tokens = tiny_tokens(1)
    jax_task = jax_gpt2.make_task(jax_cfg)
    (j_loss, j_metrics), j_grads = jax.value_and_grad(
        lambda p: jax_task.loss_fn(p, {}, {"tokens": jnp.asarray(tokens)},
                                   rng=jax.random.PRNGKey(2), train=True)[:2],
        has_aux=True)(jax.tree.map(jnp.asarray, moe_params))
    leaves = torch_params(moe_params, requires_grad=True)
    loss, metrics, _ = gpt2.make_task(cfg).loss_fn(leaves, {}, {"tokens": t(tokens)},
                                                   rng=rng.StepNoise(rng.PRNGKey(2)),
                                                   train=True)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["moe_aux"].detach()), float(j_metrics["moe_aux"]),
                               rtol=1e-6)
    assert float(metrics["moe_drop"].detach()) == pytest.approx(float(j_metrics["moe_drop"]),
                                                              abs=1e-7)
    j_flat = convert.flatten_tree(jax.tree.map(np.asarray, j_grads))
    assert sorted(p.replace("/", ".") for p in j_flat) == sorted(grads)
    for path, g in j_flat.items():
        np.testing.assert_allclose(grads[path.replace("/", ".")].numpy(), g, atol=2e-6,
                                   rtol=1e-4, err_msg=path)


def test_moe_five_step_trajectory_matches_jax_trainer():
    jax_cfg, cfg = tiny(log_every=1)
    sc = ShardingConfig(mesh={"data": 1})
    mesh = sc.build_mesh()
    jt = jax_loop.Trainer(jax_gpt2.make_task(jax_cfg, mesh=mesh), jax_cfg, mesh=mesh, sharding=sc)
    init = jax.tree.map(np.asarray, jt.state.params)
    it = jax_memory.train_iterator(jax_gpt2.datasets(jax_cfg)[0], 16, seed=0)
    state, theirs, their_aux = jt.state, [], []
    for _ in range(5):
        state, metrics = jt._train_step(state, jt._put_batch(next(it)))
        theirs.append(float(metrics["loss"]))
        their_aux.append(float(metrics["moe_aux"]))
    trainer = Trainer(gpt2.make_task(cfg), cfg, init_params=init)
    trainer.fit(memory.train_iterator(gpt2.datasets(cfg)[0], 16, seed=0), num_steps=5)
    ours = [h["loss"] for h in trainer.history]
    assert len(ours) == 5 and ours[-1] < ours[0]
    np.testing.assert_allclose(ours, theirs, rtol=3e-3, atol=0)
    np.testing.assert_allclose([h["moe_aux"] for h in trainer.history], their_aux, rtol=3e-3)
    assert all(h["moe_drop"] == 0.0 for h in trainer.history)


@pytest.mark.parametrize("impl", ["grouped", "scatter"])
def test_moe_greedy_generate_matches_jax(moe_params, impl):
    jax_cfg, cfg = tiny(moe_impl=impl)
    mcfg = gpt2.model_config(cfg)
    prompt = np.random.default_rng(4).integers(0, 64, (2, 5))
    theirs = np.asarray(jax_transformer.generate(
        jax_transformer.Transformer(jax_gpt2.model_config(jax_cfg)),
        jax.tree.map(jnp.asarray, moe_params), jnp.asarray(prompt, jnp.int32), num_tokens=8,
        rng=jax.random.PRNGKey(3), temperature=0.0))
    model = convert.model_from_params(mcfg, moe_params)
    ours = transformer.generate(mcfg, model, t(prompt), num_tokens=8, key=rng.PRNGKey(3),
                                temperature=0.0).numpy()
    assert ours.shape == (2, 13) and np.array_equal(ours, theirs)


def _jax_param_count(jax_cfg) -> int:
    shapes = jax.eval_shape(lambda: jax_transformer.Transformer(jax_cfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32)))["params"]
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


@pytest.mark.parametrize("widths", ["tiny", "moe_bench"])
def test_moe_param_count_on_meta_matches_jax_eval_shape(widths):
    if widths == "tiny":
        jax_cfg = jax_gpt2.model_config(tiny()[0])
    else:  # bench.py moe_bench_config() at its TPU widths: GPT-2 124M, 8 experts, top-2
        jax_cfg = jax_transformer.TransformerConfig(attention="xla", dropout=0.0, moe_experts=8,
                                                    moe_top_k=2, moe_every=2)
    model = transformer.GPT2(port_model_config(jax_cfg), device="meta")
    count = sum(p.numel() for p in model.parameters())
    assert count == _jax_param_count(jax_cfg)
    if widths == "moe_bench":
        assert count == 322_818_816
        assert [i for i in range(12) if hasattr(model.block(i), "moe")] == [1, 3, 5, 7, 9, 11]


def test_moe_weights_round_trip_through_the_bridge(moe_params, tmp_path):
    _, cfg = tiny()
    model = convert.model_from_params(gpt2.model_config(cfg), moe_params)
    names = dict(model.named_parameters())
    assert names["h_1.moe.w_in"].shape == (4, 32, 128) and "h_1.mlp_fc.kernel" not in names
    assert "h_0.mlp_fc.kernel" in names and "h_0.moe.gate" not in names
    back = convert.flatten_tree(convert.to_param_tree(model))
    want = convert.flatten_tree(moe_params)
    assert sorted(back) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(back[path], want[path], err_msg=path)
    convert.save_npz(tmp_path / "p.npz", convert.to_param_tree(model))
    again = convert.model_from_params(gpt2.model_config(cfg), convert.load_npz(tmp_path / "p.npz"))
    for k, v in again.state_dict().items():
        torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0)


def test_moe_random_init_follows_the_reference_scheme():
    _, cfg = tiny(d_model=64, num_layers=4)
    model = transformer.GPT2(gpt2.model_config(cfg), seed=0)
    blk = model.block(1).moe
    assert float(blk.b_in.abs().max()) == 0.0 and float(blk.b_out.abs().max()) == 0.0
    assert abs(float(blk.w_in.std()) - 0.02) < 2e-3
    assert abs(float(blk.w_out.std()) - 0.02 / 8 ** 0.5) < 1e-3
    assert abs(float(blk.gate.std()) - 0.02) < 5e-3


def test_serving_engine_rejects_moe_models(moe_params):
    _, cfg = tiny()
    with pytest.raises(NotImplementedError, match="dense GPT-2"):
        InferenceEngine(gpt2.model_config(cfg), moe_params, device="cpu")


def test_moe_cli_trains_checkpoints_and_generates(tmp_path, capsys):
    """The training CLI takes the MoE flags from the dataclass, logs
    ``moe_aux``/``moe_drop``, and the generate CLI restores the MoE
    checkpoint with the same flags: its stream equals ``generate`` on the
    restored params."""
    from tensorflow_examples_torch import generate as generate_cli
    from tensorflow_examples_torch.train import cli

    flags = ["--device", "cpu", "--vocab_size", "256", "--seq_len", "32", "--num_layers", "2",
             "--num_heads", "2", "--d_model", "32", "--moe_experts", "4", "--moe_top_k", "2",
             "--moe_impl", "grouped", "--workdir", str(tmp_path)]
    assert cli.main(flags + ["--global_batch_size", "4", "--train_steps", "2",
                             "--warmup_steps", "1", "--log_every", "1", "--eval_every", "0"]) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["steps"] == 2 and final["moe_drop"] == 0.0 and final["moe_aux"] > 0
    assert generate_cli.main(flags + ["--prompt", "the ", "--num_tokens", "6",
                                      "--temperature", "0"]) == 0
    out = capsys.readouterr().out.splitlines()
    toks = [int(v) for v in out[0].split(":", 1)[1].strip(" []").split(",")]
    cfg = gpt2.Gpt2Config(device="cpu", vocab_size=256, seq_len=32, num_layers=2, num_heads=2,
                          d_model=32, moe_experts=4, moe_top_k=2, moe_impl="grouped")
    model, step = generate_cli.restore_model(gpt2.model_config(cfg), str(tmp_path), "cpu")
    assert hasattr(model.block(1), "moe") and step == 2
    want = transformer.generate(gpt2.model_config(cfg), model, t([list(b"the ")]), num_tokens=6,
                                key=rng.PRNGKey(cfg.seed), temperature=0.0)
    assert toks == want[0].tolist()
