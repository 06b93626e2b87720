"""The port's cross-entropy against the JAX package (PyTorch/CUDA port).

On the CPU the port's ``fused=True`` path runs the plain versions of its
two kernels (``ce_fwd_plain``, ``ce_bwd_plain``) inside the same
``torch.autograd.Function`` that launches the CUDA kernels on the card;
the JAX fused Pallas kernel runs in interpret mode, as the JAX suite
runs it. Inputs come from numpy seeds. Tolerances are
``tests/test_kernels.py``'s ``TestFusedCrossEntropy``: the NLL at
atol/rtol 1e-5, the gradient at atol 1e-6 and rtol 1e-5, the weighted
mean at rtol 1e-6, bf16 logits at 2e-2. Out-of-range labels select 0 in
both packages. The 5-step GPT-2 trajectory at ``fused_ce=True`` is held
to the JAX ``Trainer``'s at rtol 3e-3, the bound of
``tests/test_sharding.py``'s trajectory test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.data import memory as jax_memory
from tensorflow_examples_tpu.ops import cross_entropy as jax_ce
from tensorflow_examples_tpu.sharding import ShardingConfig
from tensorflow_examples_tpu.train import loop as jax_loop
from tensorflow_examples_tpu.workloads import gpt2 as jax_gpt2
from tensorflow_examples_torch.data import memory
from tensorflow_examples_torch.ops import cross_entropy, losses
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.workloads import gpt2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, n, vocab, scale=3.0):
    r = np.random.default_rng(seed)
    logits = (r.standard_normal((n, vocab)) * scale).astype(np.float32)
    labels = r.integers(0, vocab, n).astype(np.int32)
    return logits, labels


def _jax_grad(fn, logits, labels):
    return np.asarray(jax.grad(lambda x: jnp.mean(fn(x, jnp.asarray(labels))))(
        jnp.asarray(logits)))


def _port(logits, labels, fused=True):
    """(nll, d mean(nll) / d logits) of the port on the CPU."""
    x = torch.from_numpy(logits).requires_grad_()
    nll = cross_entropy.cross_entropy_per_example(x, torch.from_numpy(labels).long(), fused=fused)
    return nll.detach().numpy(), torch.autograd.grad(nll.mean(), x)[0].numpy()


def test_out_of_range_labels_select_zero_as_in_jax():
    """Labels [1, -1, V, 3]: NLL and gradient of the JAX reference, the
    JAX fused kernel and both port paths agree; a row with an
    out-of-range label has NLL = lse and a plain softmax gradient."""
    logits, _ = _inputs(0, 4, 10)
    labels = np.array([1, -1, 10, 3], np.int32)
    ref = np.asarray(jax_ce.cross_entropy_reference(jnp.asarray(logits), jnp.asarray(labels)))
    fused = np.asarray(jax_ce.cross_entropy_per_example(jnp.asarray(logits),
                                                        jnp.asarray(labels), fused=True))
    g_ref = _jax_grad(jax_ce.cross_entropy_reference, logits, labels)
    g_fused = _jax_grad(lambda x, y: jax_ce.cross_entropy_per_example(x, y, fused=True),
                        logits, labels)
    np.testing.assert_allclose(fused, ref, atol=1e-5, rtol=1e-5)
    for is_fused in (True, False):
        nll, g = _port(logits, labels, fused=is_fused)
        np.testing.assert_allclose(nll, ref, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(g, g_ref, atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(g, g_fused, atol=1e-6, rtol=1e-5)
    lse = np.log(np.exp(logits.astype(np.float64)).sum(-1))
    np.testing.assert_allclose(ref[[1, 2]], lse[[1, 2]], rtol=1e-6)
    t = torch.from_numpy(logits)
    assert losses.select_label(t, torch.tensor([1, -1, 10, 3]))[1:3].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("vocab", [1000, 50257])
def test_fused_forward_matches_jax_fused_kernel(vocab):
    logits, labels = _inputs(1, 64, vocab)
    theirs = np.asarray(jax_ce.cross_entropy_per_example(jnp.asarray(logits),
                                                         jnp.asarray(labels), fused=True))
    ours, _ = _port(logits, labels)
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        ours, np.asarray(jax_ce.cross_entropy_reference(jnp.asarray(logits), jnp.asarray(labels))),
        atol=1e-5, rtol=1e-5)


def test_fused_gradient_matches_jax_fused_kernel():
    logits, labels = _inputs(2, 32, 4099, scale=1.0)  # 4099: not a block multiple in JAX
    theirs = _jax_grad(lambda x, y: jax_ce.cross_entropy_per_example(x, y, fused=True),
                       logits, labels)
    _, ours = _port(logits, labels)
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=1e-5)


def test_weighted_mean_loss_matches_jax():
    logits, labels = _inputs(4, 16, 512, scale=1.0)
    weights = np.ones((2, 8), np.float32)
    weights[:, -3:] = 0.0
    theirs = float(jax_ce.cross_entropy_loss(jnp.asarray(logits).reshape(2, 8, 512),
                                             jnp.asarray(labels).reshape(2, 8),
                                             jnp.asarray(weights), fused=True))
    ours = float(cross_entropy.cross_entropy_loss(
        torch.from_numpy(logits).reshape(2, 8, 512), torch.from_numpy(labels).long().reshape(2, 8),
        torch.from_numpy(weights)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6)


def test_bf16_logits_match_jax():
    logits, labels = _inputs(6, 16, 1024, scale=1.0)
    jl = jnp.asarray(logits).astype(jnp.bfloat16)
    theirs = np.asarray(jax_ce.cross_entropy_per_example(jl, jnp.asarray(labels), fused=True))
    x = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(torch.bfloat16).requires_grad_()
    nll = cross_entropy.cross_entropy_per_example(x, torch.from_numpy(labels).long())
    np.testing.assert_allclose(nll.detach().numpy(), theirs, atol=2e-2, rtol=2e-2)
    (g,) = torch.autograd.grad(nll.mean(), x)
    assert g.dtype == torch.bfloat16  # dlogits come back in the logits' dtype


def test_plain_kernel_versions_are_the_reference_and_its_gradient():
    """ce_fwd_plain's NLL is the reference's; ce_bwd_plain is autograd of
    the reference, under a non-unit cotangent; a row of all -1e30 gets
    the reference kernel's (m = -1e30, l clamped) values."""
    logits, labels = _inputs(7, 24, 300)
    x, y = torch.from_numpy(logits), torch.from_numpy(labels).long()
    g = torch.from_numpy(np.random.default_rng(8).random(24).astype(np.float32) + 0.5)
    nll, lse = cross_entropy.ce_fwd_plain(x, y)
    torch.testing.assert_close(nll, cross_entropy.cross_entropy_reference(x, y))
    torch.testing.assert_close(lse, torch.logsumexp(x, -1))
    xr = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(cross_entropy.cross_entropy_reference(xr, y), xr, g)
    torch.testing.assert_close(cross_entropy.ce_bwd_plain(x, y, lse, g), want,
                               atol=1e-6, rtol=1e-5)
    x[0] = -1e30
    nll, lse = cross_entropy.ce_fwd_plain(x, y)
    assert float(nll[0]) == 0.0 and float(lse[0]) == float(np.float32(-1e30))


def test_block_sizes_are_accepted_and_cpu_never_counts_a_launch():
    """The reference's TPU tile sizes: the defaults are accepted, any
    other value raises (the kernels choose their own tiling); and the
    CPU path counts no launch."""
    logits, labels = _inputs(9, 8, 64)
    before = (cross_entropy.ce_fwd.launches, cross_entropy.ce_bwd.launches)
    x = torch.from_numpy(logits).requires_grad_()
    for kw in ({"block_n": 8, "block_v": 16}, {"block_n": 8}, {"block_v": 16}):
        with pytest.raises(ValueError, match="TPU tile sizes"):
            cross_entropy.cross_entropy_per_example(x, torch.from_numpy(labels).long(), **kw)
    nll = cross_entropy.cross_entropy_per_example(x, torch.from_numpy(labels).long(),
                                                  block_n=256, block_v=4096)
    torch.autograd.grad(nll.sum(), x)
    with torch.no_grad():  # eval: the Function's forward still runs
        cross_entropy.cross_entropy_per_example(x, torch.from_numpy(labels).long())
    assert (cross_entropy.ce_fwd.launches, cross_entropy.ce_bwd.launches) == before


def test_five_step_fused_trajectory_matches_jax_trainer():
    base = dict(vocab_size=64, seq_len=16, num_layers=2, num_heads=4, d_model=32, dropout=0.0,
                attention="xla", global_batch_size=16, train_steps=30, warmup_steps=5,
                learning_rate=3e-3, log_every=1, eval_every=0, precision="f32", fused_ce=True)
    jax_cfg = jax_gpt2.Gpt2Config(checkpoint_every=0, **base)
    cfg = gpt2.Gpt2Config(device="cpu", **base)
    sc = ShardingConfig(mesh={"data": 1})
    mesh = sc.build_mesh()
    jt = jax_loop.Trainer(jax_gpt2.make_task(jax_cfg, mesh=mesh), jax_cfg, mesh=mesh, sharding=sc)
    init = jax.tree.map(np.asarray, jt.state.params)
    train_ds, _ = jax_gpt2.datasets(jax_cfg)
    it = jax_memory.train_iterator(train_ds, 16, seed=0)
    state, theirs = jt.state, []
    for _ in range(5):
        state, metrics = jt._train_step(state, jt._put_batch(next(it)))
        theirs.append(float(metrics["loss"]))
    trainer = Trainer(gpt2.make_task(cfg), cfg, init_params=init)
    ours_ds, _ = gpt2.datasets(cfg)
    trainer.fit(memory.train_iterator(ours_ds, 16, seed=0), num_steps=5)
    ours = [h["loss"] for h in trainer.history]
    assert len(ours) == 5 and ours[-1] < ours[0]
    np.testing.assert_allclose(ours, theirs, rtol=3e-3, atol=0)
