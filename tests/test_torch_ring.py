"""Context parallelism of the port (``parallel/ring.py``,
``parallel/attention.py``) against the JAX package's on the
8-fake-device ``ctx_mesh`` (data 2 x context 4).

One spawned gloo world of 4 ranks (context 4) runs every case on its
sequence shards of the same seeded numpy q, k, v [2, 4, s, 8]: the
zigzag and the contiguous causal ring, the non-causal ring, an odd shard
(the contiguous ring by default), Ulysses causal and not, and
``mesh_attention`` with the causal pad to a zigzag length (s 20 and 12),
over Ulysses and the plain route, and BERT's key-bias route with heads
split over ``model``. Each case's output and the gradients
of ``sum(out ** 2)``, gathered from the ranks, are held to the
reference's ``shard_map`` of the same function at the JAX suite's
tolerances: atol 2e-5 for outputs, 5e-4 for gradients
(``tests/test_parallel.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tensorflow_examples_torch.core import distributed

CONTEXT = 4
# name -> (port function, its keywords, seq)
CASES = {
    "ring zigzag": ("ring", dict(causal=True, zigzag=True), 32),
    "ring contiguous": ("ring", dict(causal=True, zigzag=False), 32),
    "ring non-causal": ("ring", dict(causal=False), 32),
    "ring odd shard": ("ring", dict(causal=True), 20),
    "ulysses causal": ("ulysses", dict(causal=True), 32),
    "ulysses non-causal": ("ulysses", dict(causal=False), 32),
    "mesh pad s20": ("mesh", dict(causal=True), 20),
    "mesh pad s12": ("mesh", dict(causal=True), 12),
    "mesh ulysses": ("mesh", dict(causal=True, impl="ulysses"), 32),
    "mesh xla": ("mesh", dict(causal=True, impl="xla"), 32),
}


def qkv(s: int, seed: int = 3):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(2, 4, s, 8).astype(np.float32) for _ in range(3))


def _ring_worker(rank: int) -> dict:
    from tensorflow_examples_torch.core.mesh import MeshConfig, create_mesh
    from tensorflow_examples_torch.parallel.attention import mesh_attention
    from tensorflow_examples_torch.parallel.ring import ring_attention, ulysses_attention

    mesh = create_mesh(MeshConfig(data=1, context=CONTEXT))
    fns = {"ring": ring_attention, "ulysses": ulysses_attention, "mesh": mesh_attention}
    out = {}
    for name, (fn, kw, s) in CASES.items():
        shard = s // CONTEXT
        local = [torch.from_numpy(t[:, :, rank * shard:(rank + 1) * shard].copy())
                 .requires_grad_(True) for t in qkv(s)]
        o = fns[fn](*local, mesh=mesh, **kw)
        (o ** 2).sum().backward()
        out[name] = (o.detach().numpy(), [t.grad.numpy() for t in local])
    # BERT's route: heads split over model, the sequence whole, a key bias.
    tp = create_mesh(MeshConfig(data=1, model=CONTEXT))
    local = [torch.from_numpy(t[:, rank:rank + 1].copy()).requires_grad_(True)
             for t in qkv(KEY_BIAS_SEQ)]
    o = mesh_attention(*local, mesh=tp, causal=False, key_bias=torch.from_numpy(key_bias()))
    (o ** 2).sum().backward()
    out["key_bias"] = (o.detach().numpy(), [t.grad.numpy() for t in local])
    return out


KEY_BIAS_SEQ = 24


def key_bias():
    """[2, 24]: the second example's last 9 keys masked, as padding."""
    bias = np.zeros((2, KEY_BIAS_SEQ), np.float32)
    bias[1, 15:] = -1e9
    return bias


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    ranks = distributed.run_world(_ring_worker, CONTEXT, timeout_s=180,
                                  store_dir=str(tmp_path_factory.mktemp("ring")))
    out = {name: (np.concatenate([r[name][0] for r in ranks], axis=2),
                  [np.concatenate([r[name][1][i] for r in ranks], axis=2) for i in range(3)])
           for name in CASES}
    out["key_bias"] = (np.concatenate([r["key_bias"][0] for r in ranks], axis=1),
                       [np.concatenate([r["key_bias"][1][i] for r in ranks], axis=1)
                        for i in range(3)])
    return out


@pytest.fixture(scope="module")
def ctx_mesh():
    from tensorflow_examples_tpu.core.mesh import MeshConfig, create_mesh

    return create_mesh(MeshConfig(data=2, context=4))


def reference(name: str, ctx_mesh):
    """The JAX package's output and gradients for a case."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tensorflow_examples_tpu.parallel.attention import mesh_attention
    from tensorflow_examples_tpu.parallel.ring import ring_attention, ulysses_attention

    fn, kw, s = CASES[name]
    if fn == "mesh":
        f = functools.partial(mesh_attention, mesh=ctx_mesh, **kw)
    else:
        local = functools.partial(ring_attention if fn == "ring" else ulysses_attention,
                                  axis_name="context", **kw)
        spec = P("data", None, "context", None)
        f = jax.shard_map(local, mesh=ctx_mesh, in_specs=(spec, spec, spec), out_specs=spec,
                          check_vma=False)
    q, k, v = (jnp.asarray(t) for t in qkv(s))
    out = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(f(a, b, c) ** 2), argnums=(0, 1, 2)))(
        q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(CASES))
def test_context_parallel_matches_reference(port, ctx_mesh, name):
    want_out, want_grads = reference(name, ctx_mesh)
    got_out, got_grads = port[name]
    np.testing.assert_allclose(got_out, want_out, atol=2e-5, err_msg=name)
    for which, got, want in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(got, want, atol=5e-4, err_msg=f"{name} d{which}")


def test_context_pad_is_zero_at_gpt2_and_zigzag_even_elsewhere():
    """The pad the mesh cases above hold to the reference's: none at
    GPT-2's seq 1024 over 2 or 4 ranks, and every padded sequence a
    multiple of 2c."""
    from tensorflow_examples_torch.parallel.attention import context_pad

    assert context_pad(1024, 2) == context_pad(1024, 4) == 0
    for seq, c in ((20, 4), (12, 4), (1000, 2), (4100, 2), (18, 2)):
        assert (seq + context_pad(seq, c)) % (2 * c) == 0
    assert context_pad(20, 4) == 4 and context_pad(12, 4) == 4


@pytest.fixture(scope="module")
def tp_mesh():
    from tensorflow_examples_tpu.core.mesh import MeshConfig, create_mesh

    return create_mesh(MeshConfig(data=2, model=4))


def test_key_bias_matches_reference(port, tp_mesh):
    """BERT's route: the reference's ``mesh_attention`` with a key bias on
    a (data 2, model 4) mesh shards heads over ``model`` with the
    sequence whole; each port rank holds one of the 4 heads."""
    import jax
    import jax.numpy as jnp

    from tensorflow_examples_tpu.parallel.attention import mesh_attention

    q, k, v = (jnp.asarray(t) for t in qkv(KEY_BIAS_SEQ))
    kb = jnp.asarray(key_bias())
    f = lambda a, b, c: mesh_attention(a, b, c, mesh=tp_mesh, causal=False, key_bias=kb)
    want = np.asarray(jax.jit(f)(q, k, v))
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(f(a, b, c) ** 2), argnums=(0, 1, 2)))(q, k, v)
    got_out, got_grads = port["key_bias"]
    np.testing.assert_allclose(got_out, want, atol=2e-5)
    for which, got, g in zip("qkv", got_grads, grads):
        np.testing.assert_allclose(got, np.asarray(g), atol=5e-4, err_msg=f"d{which}")
