"""The port's expert parallelism (``parallel/moe.moe_ffn_ep``, the MoE
block of ``models/transformer.py`` on a ``model`` > 1 mesh) against the
JAX package's ``moe_ffn_ep``.

One spawned gloo world of 4 ranks (``core/distributed.run_world``, a
``file://`` store under ``tmp_path``, bounded by a timeout) on
``{data: 2, model: 2}``: each rank holds its batch rows and its E/2
experts of the same numpy-seeded arguments the JAX package's
``moe_ffn_ep`` takes whole on its fake CPU devices.

* Outputs, the aux loss, the drop fraction and the gradients against
  ``jax.grad``, with router jitter on (the key folded by each route
  axis's index, bit for bit jax's) and off, top-1 and top-2, at a
  capacity that drops tokens and one that does not: atol 2e-5 for
  outputs (the JAX suite's, ``tests/test_parallel.py``), rtol 1e-5 for
  the aux loss, the drop fraction exactly. The gradients of the two
  terms are taken apart, so that neither hides in the other: those of
  ``sum(out**2)`` (the JAX suite's loss, ``tests/test_parallel.py:190``,
  whose gradients are O(1) in every argument) at that suite's atol/rtol
  5e-4, and those of ``aux`` (O(0.04), and only in the gate and ``x``)
  at an atol of 1e-4 of their largest entry. Each compared gradient must
  stand well above its atol, so that a zero or doubled one fails.
* A 3-step ``Trainer`` trajectory of the tiny MoE GPT-2 (4 experts,
  top-2, ``tests/test_torch_sharded_train.py``'s widths, f32, dropout 0,
  the router jittering) on ``{data: 2, model: 2}`` against the JAX
  ``Trainer`` on the same layout from the same numpy-seeded weights, at
  rtol 3e-3, with its ``moe_aux`` and ``moe_drop``.
* The single-program fallback (``model`` 1, or E not divisible by it),
  and the folded jitter key against jax's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tensorflow_examples_torch.core import collectives as coll
from tensorflow_examples_torch.core import distributed
from tensorflow_examples_torch.core import rng as rng_mod
from tensorflow_examples_torch.core.mesh import Mesh
from tensorflow_examples_torch.models import convert
from tensorflow_examples_torch.parallel import moe
from tensorflow_examples_torch.sharding import ShardingConfig
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.workloads import gpt2

WORLD_TIMEOUT_S = 240
STEPS = 3
MESH = {"data": 2, "model": 2}
JITTER_KEY = 11
# (name, top_k, capacity_factor, jitter): the jitter-free ample-capacity
# case is the parity regime; the others drop tokens or jitter the router.
CASES = (
    ("top2 ample", 2, 8.0, False),
    ("top2 ample jitter", 2, 8.0, True),
    ("top1 drops jitter", 1, 0.5, True),
    ("top2 drops", 2, 0.75, False),
)


def ep_args(e=8, d=16, ff=32, b=8, s=16, seed=0):
    r = np.random.RandomState(seed)
    return [(r.standard_normal(shape) * scale).astype(np.float32) for shape, scale in (
        ((d, e), 0.5), ((e, d, ff), 0.1), ((e, ff), 0.01), ((e, ff, d), 0.1), ((e, d), 0.01),
        ((b, s, d), 1.0))]


def folded_jitter(key: np.ndarray):
    """The port's jitter source for a key: uniforms of the key folded by
    the route axes' indices (``fold``), jax's bits."""

    def draw(shape, lo, hi, device, fold=()):
        k = key
        for i in fold:
            k = rng_mod.fold_in(k, i)
        return torch.from_numpy(rng_mod.uniform(k, shape, lo, hi)).to(device)

    return draw


def _ep_world(rank: int, args) -> dict:
    mesh = ShardingConfig(mesh=MESH).build_mesh()
    m, r = mesh.axis_size("model"), mesh.axis_index("model")
    nd, di = mesh.axis_size("data"), mesh.axis_index("data")
    e, b = args[0].shape[1], args[5].shape[0]
    local = ([args[0]] + [a[r * e // m:(r + 1) * e // m] for a in args[1:5]]
             + [args[5][di * b // nd:(di + 1) * b // nd]])
    out = {}
    for name, top_k, cf, jitter in CASES:
        leaves = [torch.tensor(a).requires_grad_(True) for a in local]
        y, aux, drop = moe.moe_ffn_ep(
            *leaves, mesh=mesh, capacity_factor=cf, top_k=top_k,
            rng=folded_jitter(rng_mod.PRNGKey(JITTER_KEY)) if jitter else None)
        # sum(out**2) over the rank's rows: the ranks' parameter gradients
        # sum to the whole batch's. aux is the whole batch's on every rank:
        # its gradients are meaned over data, as the trainer reduces them.
        g_out = torch.autograd.grad((y ** 2).sum(), leaves, retain_graph=True)
        g_aux = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(torch.autograd.grad(aux, leaves, allow_unused=True), leaves)]
        out[name] = {
            "out": y.detach().numpy(), "aux": float(aux), "drop": float(drop),
            "grads_out": [coll._all_reduce(g, "data", mesh).numpy() for g in g_out[:5]]
            + [g_out[5].numpy()],
            "grads_aux": [(coll._all_reduce(g, "data", mesh) / nd).numpy() for g in g_aux[:5]]
            + [g_aux[5].numpy() / nd]}
    return out


@pytest.fixture(scope="module")
def port_ep(tmp_path_factory):
    return distributed.run_world(_ep_world, 4, ep_args(), timeout_s=WORLD_TIMEOUT_S,
                                 store_dir=str(tmp_path_factory.mktemp("ep")))


def _jax_mesh():
    from tensorflow_examples_tpu.sharding import ShardingConfig as JaxShardingConfig

    return JaxShardingConfig(mesh=MESH).build_mesh()


@pytest.mark.parametrize("name,top_k,cf,jitter", CASES)
def test_moe_ffn_ep_matches_jax(port_ep, name, top_k, cf, jitter):
    import functools

    import jax
    import jax.numpy as jnp

    from tensorflow_examples_tpu.parallel import moe as jax_moe

    mesh = _jax_mesh()
    args = [jnp.asarray(a) for a in ep_args()]
    kw = dict(mesh=mesh, capacity_factor=cf, top_k=top_k,
              rng=jax.random.PRNGKey(JITTER_KEY) if jitter else None)
    fn = functools.partial(jax_moe.moe_ffn_ep, **kw)

    with mesh:
        out, aux, drop = jax.jit(fn)(*args)
        terms = {"out": jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a)[0] ** 2),
                                         argnums=tuple(range(6))))(*args),
                 "aux": jax.jit(jax.grad(lambda *a: fn(*a)[1], argnums=tuple(range(6))))(*args)}
    ranks = [r[name] for r in port_ep]
    # ranks (data, model) row-major: model ranks hold the same rows.
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(ranks[a]["out"], ranks[b]["out"])
    got = np.concatenate([ranks[0]["out"], ranks[2]["out"]])
    np.testing.assert_allclose(got, np.asarray(out), atol=2e-5, rtol=2e-5, err_msg=name)
    for r in ranks:
        np.testing.assert_allclose(r["aux"], float(aux), rtol=1e-5, err_msg=name)
        assert r["drop"] == pytest.approx(float(drop), abs=1e-7), name
    if "drops" in name:
        assert float(drop) > 0.0, f"{name}: the capacity must drop tokens"
    else:
        assert float(drop) == 0.0
    names = ("gate", "w_in", "b_in", "w_out", "b_out", "x")
    for term, grads in terms.items():
        mine = ranks[0][f"grads_{term}"], ranks[1][f"grads_{term}"], ranks[2][f"grads_{term}"]
        whole = [mine[0][0]] + [np.concatenate([mine[0][i], mine[1][i]]) for i in range(1, 5)] \
            + [np.concatenate([mine[0][5], mine[2][5]])]
        for n, got_g, want in zip(names, whole, (np.asarray(t) for t in grads)):
            peak = float(np.abs(want).max())
            if term == "aux" and n not in ("gate", "x"):
                np.testing.assert_array_equal(got_g, 0.0, err_msg=f"{name} d{n} of aux")
                continue
            atol = 5e-4 if term == "out" else 1e-4 * peak
            assert peak > 50 * atol, f"{name} d{n} of {term}: too small to check ({peak})"
            np.testing.assert_allclose(got_g, want, atol=atol, rtol=5e-4,
                                       err_msg=f"{name} d{n} of {term}")


def test_single_program_fallback_without_a_dividing_model_axis():
    mesh = Mesh((1, 1, 1, 1, 1))
    a = [torch.tensor(x) for x in ep_args(e=6)]
    kw = dict(capacity_factor=8.0, top_k=1, impl="scatter")
    for got, want in zip(moe.moe_ffn_ep(*a, mesh=mesh, **kw), moe.moe_ffn(*a, **kw)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_step_noise_folds_the_router_key_as_jax():
    import jax
    from flax.core.scope import _fold_in_static

    step_key = rng_mod.step_rng(rng_mod.PRNGKey(43), 5)
    noise = rng_mod.StepNoise().stage(rng_mod.fold_in(step_key, 1), base=step_key)
    got = noise.router_jitter(3, (6, 4), -0.01, 0.01, torch.device("cpu"), fold=(1, 0))
    key = _fold_in_static(jax.numpy.asarray(step_key), ("h_3", "moe", 1))
    for i in (1, 0):
        key = jax.random.fold_in(key, i)
    want = jax.random.uniform(key, (6, 4), jax.numpy.float32, -0.01, 0.01)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Unfolded (the single-program path): the rank's own key, as before.
    plain = rng_mod.StepNoise().stage(step_key).router_jitter(3, (6, 4), -0.01, 0.01,
                                                              torch.device("cpu"))
    np.testing.assert_array_equal(plain.numpy(), rng_mod.uniform(
        rng_mod.router_key(step_key, 3), (6, 4), -0.01, 0.01))


# --------------------------------------------------------------- trainer


def tiny_cfg(**kw):
    base = dict(vocab_size=64, seq_len=16, num_layers=2, num_heads=4, d_model=32, dropout=0.0,
                attention="xla", global_batch_size=16, train_steps=STEPS, warmup_steps=5,
                learning_rate=3e-3, log_every=10, checkpoint_every=0, eval_every=0,
                precision="f32", moe_experts=4, moe_top_k=2, moe_impl="scatter")
    base.update(kw)
    return base


def batches() -> list[dict]:
    rng = np.random.RandomState(0)
    return [{"tokens": rng.randint(0, 64, size=(16, 17)).astype(np.int32)} for _ in range(STEPS)]


def _trainer_world(rank: int, tree: dict) -> dict:
    cfg = gpt2.Gpt2Config(device="cpu", watchdog_secs=0, telemetry_sinks="", **tiny_cfg())
    sc = ShardingConfig(mesh=MESH)
    mesh = sc.build_mesh()
    trainer = Trainer(gpt2.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc,
                      init_params=tree)
    metrics = [trainer.train_step(b) for b in batches()]
    return {k: [float(m[k]) for m in metrics] for k in ("loss", "moe_aux", "moe_drop")} | {
        "w_in_local": tuple(trainer.state.params["h_1.moe.w_in"].shape)}


def test_trainer_trajectory_matches_the_jax_trainer(tmp_path):
    import jax
    import jax.numpy as jnp

    from tensorflow_examples_tpu.train.loop import Trainer as JaxTrainer
    from tensorflow_examples_tpu.workloads import gpt2 as jax_gpt2

    cfg = jax_gpt2.Gpt2Config(**tiny_cfg())
    mesh = _jax_mesh()
    jt = JaxTrainer(jax_gpt2.make_task(cfg, mesh=mesh), cfg, mesh=mesh)
    rng = np.random.RandomState(3)
    flat = {k: (1.0 + 0.1 * rng.standard_normal(v.shape) if k.endswith("scale")
                else 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in sorted(convert.flatten_tree(
                jax.tree.map(np.asarray, jt.state.params)).items())}
    tree = convert.to_param_tree({k.replace("/", "."): torch.tensor(v) for k, v in flat.items()})
    state = jt.state.replace(params=jax.tree.map(
        lambda old, new: jax.device_put(jnp.asarray(new, old.dtype), old.sharding),
        jt.state.params, tree))
    theirs = {"loss": [], "moe_aux": [], "moe_drop": []}
    for b in batches():
        state, metrics = jt._train_step(state, jt._put_batch(b))
        for k in theirs:
            theirs[k].append(float(metrics[k]))
    ranks = distributed.run_world(_trainer_world, 4, tree, timeout_s=WORLD_TIMEOUT_S,
                                  store_dir=str(tmp_path))
    ours = ranks[0]
    assert all(r["loss"] == ours["loss"] for r in ranks), "ranks disagree on the loss"
    assert ours["w_in_local"] == (2, 32, 128)  # 2 of the 4 experts a model rank
    np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=3e-3, atol=0)
    np.testing.assert_allclose(ours["moe_aux"], theirs["moe_aux"], rtol=3e-3)
    np.testing.assert_allclose(ours["moe_drop"], theirs["moe_drop"], atol=1e-6)
