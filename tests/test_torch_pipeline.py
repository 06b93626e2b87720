"""The port's pipeline parallelism (``parallel/pipeline.py``, the
``pipe`` task of ``workloads/gpt2.py``) against the JAX package's.

Spawned gloo worlds (``core/distributed.run_world``, a ``file://`` store
under ``tmp_path``, a timeout on every world) run the tiny GPT-2 of
``tests/test_torch_sharded_train.py`` at 4 layers (so that 2 stages of 2
virtual stages divide them), f32, dropout 0. Both packages start from the
same numpy-seeded pipeline tree (``{"embed": ..., "blocks": ...}``,
loaded into the port through ``models/convert.py`` and its gradients
brought back the same way) and read the same batches; the JAX package
runs on its fake CPU devices.

* ``_schedule_1f1b``'s tables equal the reference's, and (8, 4, 1) gives
  22 ticks, depth 4 and queues 2/2 (``tests/test_train_gpt2.py:272``).
* The 1F1B and GPipe loss and gradients on ``{data: 2, pipe: 2}`` and on
  ``{model: 2, pipe: 2}`` (heads split over ``model`` inside each stage,
  ``attention`` "flash" and "xla") against the JAX task's
  ``jax.value_and_grad`` on ``{data: 2, pipe: 2}``: rtol 1e-5 for the
  loss, atol 5e-5 / rtol 1e-4 for the gradients (the reference's own,
  ``tests/test_train_gpt2.py:235-270``).
* Interleaved 1F1B (``pipe_interleave`` 2, slot-major storage) against
  plain 1F1B on ``{pipe: 2}`` through the row permutation, and the eval
  (GPipe in logical order) on both; each run's ``pipeline/ticks`` and
  ``pipeline/idle_ticks`` gauges are its schedule's.
* A 3-step ``Trainer`` trajectory on ``{data: 2, pipe: 2}`` against the
  JAX ``Trainer`` at rtol 3e-3, ZeRO-1 against it at 1e-6; its checkpoint
  restored on ``{pipe: 2}`` bit for bit, and refused, naming the key,
  under ``pipe_interleave`` 2.
* MoE, context parallelism and ``tp_vocab`` under ``pipe`` raise a
  ``ValueError`` naming the fields.
* ``train.cli`` under torchrun on ``{data: 1, pipe: 2}``, resumed on
  ``{pipe: 2}`` under GPipe.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tensorflow_examples_torch.core import distributed
from tensorflow_examples_torch.core.mesh import AxisNames
from tensorflow_examples_torch.core.sharding import batch_rows
from tensorflow_examples_torch.models import convert
from tensorflow_examples_torch.parallel import pipeline
from tensorflow_examples_torch.sharding import ShardingConfig
from tensorflow_examples_torch.telemetry.registry import default_registry
from tensorflow_examples_torch.train.checkpoint import CheckpointManager
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.workloads import gpt2

STEPS = 3
WORLD_TIMEOUT_S = 240
LAYERS = 4
# (name, mesh, port config overrides): value and gradients of one batch.
GRAD_LAYOUTS_4 = (
    ("data+pipe 1f1b", {"data": 2, "pipe": 2}, {}),
    ("data+pipe gpipe", {"data": 2, "pipe": 2}, {"pipeline_schedule": "gpipe"}),
    ("model+pipe flash", {"model": 2, "pipe": 2}, {"attention": "flash"}),
    ("model+pipe xla gpipe", {"model": 2, "pipe": 2}, {"pipeline_schedule": "gpipe"}),
)


def tiny_cfg(**kw):
    base = dict(vocab_size=64, seq_len=16, num_layers=LAYERS, num_heads=4, d_model=32,
                dropout=0.0, attention="xla", global_batch_size=16, train_steps=STEPS,
                warmup_steps=5, learning_rate=3e-3, log_every=10, checkpoint_every=0,
                eval_every=0, precision="f32", num_microbatches=4)
    base.update(kw)
    return base


def port_cfg(**kw):
    return gpt2.Gpt2Config(device="cpu", watchdog_secs=0, telemetry_sinks="", **tiny_cfg(**kw))


def batches(n: int = STEPS) -> list[dict]:
    rng = np.random.RandomState(0)
    return [{"tokens": rng.randint(0, 64, size=(16, 17)).astype(np.int32)} for _ in range(n)]


def row_perm(p: int, v: int) -> np.ndarray:
    per = LAYERS // (p * v)
    return np.concatenate([np.arange(s * per, (s + 1) * per)
                           for s in pipeline.interleave_perm(p, v)])


def slot_major(tree: dict, p: int, v: int) -> dict:
    """The logical pipeline tree stored slot-major under its stamped key."""
    perm = row_perm(p, v)
    return {"embed": tree["embed"], f"blocks_slotmajor_p{p}v{v}": {
        k: _map(lambda a: a[perm], b) for k, b in tree["blocks"].items()}}


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


# ------------------------------------------------------------- port side


def _value_grad(mesh_kw: dict, kw: dict, tree: dict, batch: dict) -> dict:
    """This rank's loss, the eval NLL and (rank 0) the whole gradients,
    meaned over the batch axes as the trainer reduces them, as a tree."""
    cfg = port_cfg(**kw)
    sc = ShardingConfig(mesh=mesh_kw)
    mesh = sc.build_mesh()
    trainer = Trainer(gpt2.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc,
                      init_params=tree)
    layout, task = trainer.layout, trainer.task
    local = {k: v.detach().requires_grad_(True) for k, v in trainer.state.params.items()}
    rows = batch_rows(16, mesh, layout.batch_axes)
    b = {"tokens": torch.as_tensor(batch["tokens"][rows]).long()}
    loss, _, _ = task.loss_fn(local, {}, b, rng=None, train=True)
    gauges = default_registry().gauge_values()  # a 1F1B run's: its table's ticks, its bubble
    bubble = gauges.get("pipeline/ticks"), gauges.get("pipeline/idle_ticks")
    grads = layout.reduce_grads(dict(zip(local, torch.autograd.grad(loss, list(local.values())))))
    whole = layout.gather_state({"params": grads})["params"]
    with torch.no_grad():
        nll = float(task.eval_fn(trainer.state.params, {}, b)["nll"])
    out = {"loss": float(loss), "eval_nll": nll, "bubble": bubble,
           "qkv_local": tuple(trainer.state.params[
               next(k for k in local if k.endswith("attn.qkv.kernel"))].shape)}
    if mesh.rank == 0:
        out["grads"] = convert.to_param_tree(whole)
    return out


def _trajectory(mesh_kw: dict, tree: dict, *, zero1: bool = False):
    cfg = port_cfg(zero1=zero1)
    sc = ShardingConfig(mesh=mesh_kw, zero1=zero1)
    mesh = sc.build_mesh()
    trainer = Trainer(gpt2.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc,
                      init_params=tree)
    losses = [float(trainer.train_step(b)["loss"]) for b in batches()]
    return trainer, losses


def _world4(rank: int, tree: dict, ckpt_dir: str) -> dict:
    out = {name: _value_grad(mesh_kw, kw, tree, batches(1)[0])
           for name, mesh_kw, kw in GRAD_LAYOUTS_4}
    trainer, out["trajectory"] = _trajectory({"data": 2, "pipe": 2}, tree)
    CheckpointManager(ckpt_dir, layout=trainer.layout, primary=rank == 0).save(STEPS,
                                                                                trainer.state)
    torch.distributed.barrier()
    z1, out["trajectory zero1"] = _trajectory({"data": 2, "pipe": 2}, tree, zero1=True)
    out["opt_bytes"] = (trainer.byte_breakdown(per_device=True)["opt_state"],
                        z1.byte_breakdown(per_device=True)["opt_state"])
    return out


def _world2(rank: int, tree: dict, ckpt_dir: str) -> dict:
    out = {"pipe 1f1b": _value_grad({"pipe": 2}, {}, tree, batches(1)[0]),
           "pipe interleaved": _value_grad({"pipe": 2}, {"pipe_interleave": 2},
                                           slot_major(tree, 2, 2), batches(1)[0])}
    for name, v in (("restored", 1), ("restored v2", 2)):
        cfg = port_cfg(pipe_interleave=v)
        sc = ShardingConfig(mesh={"pipe": 2})
        mesh = sc.build_mesh()
        trainer = Trainer(gpt2.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc)
        with CheckpointManager(ckpt_dir, layout=trainer.layout, primary=rank == 0) as ckpt:
            try:
                state, step = ckpt.restore_latest(trainer.state)
            except ValueError as e:
                out[name] = {"error": str(e)}
                continue
        whole = trainer.layout.gather_state({"params": state.params})["params"]
        out[name] = {"step": step, "params": {k: t.numpy() for k, t in whole.items()}}
    return out


@pytest.fixture(scope="module")
def tree():
    """A numpy-seeded pipeline tree in the reference's layout."""
    import jax

    from tensorflow_examples_tpu.core.mesh import MeshConfig, create_mesh
    from tensorflow_examples_tpu.workloads import gpt2 as jax_gpt2

    cfg = jax_gpt2.Gpt2Config(**tiny_cfg())
    mesh = create_mesh(MeshConfig(data=4, pipe=2))
    shapes = jax.eval_shape(jax_gpt2.make_task(cfg, mesh=mesh).init_fn,
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.RandomState(3)
    flat = {}
    for path, leaf in sorted(convert.flatten_tree(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()):
        if path.endswith("scale"):
            flat[path] = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            flat[path] = 0.05 * rng.standard_normal(leaf.shape)
    out: dict = {}
    for path, a in flat.items():
        *keys, last = path.split("/")
        node = out
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def port(tree, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    four = distributed.run_world(_world4, 4, tree, ckpt, timeout_s=WORLD_TIMEOUT_S,
                                 store_dir=str(tmp_path_factory.mktemp("w4")))
    two = distributed.run_world(_world2, 2, tree, ckpt, timeout_s=WORLD_TIMEOUT_S,
                                store_dir=str(tmp_path_factory.mktemp("w2")))
    return {"4": four, "2": two, "ckpt": ckpt}


# -------------------------------------------------------------- jax side


def _jax_mesh(mesh_kw: dict):
    from tensorflow_examples_tpu.sharding import ShardingConfig as JaxShardingConfig

    return JaxShardingConfig(mesh=mesh_kw).build_mesh()


@pytest.fixture(scope="module")
def reference(tree):
    """The JAX task's loss and gradients of the batch on ``{data: 2,
    pipe: 2}`` under each schedule, and the JAX ``Trainer``'s 3 steps
    from the same tree."""
    import jax
    import jax.numpy as jnp

    from tensorflow_examples_tpu.train.loop import Trainer as JaxTrainer
    from tensorflow_examples_tpu.workloads import gpt2 as jax_gpt2

    mesh = _jax_mesh({"data": 2, "pipe": 2})
    params = jax.tree.map(jnp.asarray, tree)
    batch = {"tokens": jnp.asarray(batches(1)[0]["tokens"])}
    out = {}
    for schedule in ("1f1b", "gpipe"):
        task = jax_gpt2.make_task(jax_gpt2.Gpt2Config(**tiny_cfg(pipeline_schedule=schedule)),
                                  mesh=mesh)

        def f(p, task=task):
            return task.loss_fn(p, {}, batch, rng=jax.random.PRNGKey(7), train=True)[0]

        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(f))(params)
            nll = jax.jit(lambda p, task=task: task.eval_fn(p, {}, batch))(params)["nll"]
        out[schedule] = {"loss": float(loss), "eval_nll": float(nll),
                         "grads": jax.tree.map(np.asarray, grads)}
    cfg = jax_gpt2.Gpt2Config(**tiny_cfg())
    trainer = JaxTrainer(jax_gpt2.make_task(cfg, mesh=mesh), cfg, mesh=mesh)
    state = trainer.state
    state = state.replace(params=jax.tree.map(
        lambda old, new: jax.device_put(jnp.asarray(new, old.dtype), old.sharding),
        state.params, tree))
    losses = []
    for b in batches():
        state, metrics = trainer._train_step(state, trainer._put_batch(b))
        losses.append(float(metrics["loss"]))
    out["trajectory"] = losses
    return out


def _assert_grads(got: dict, want: dict, what: str) -> None:
    flat_got, flat_want = convert.flatten_tree(got), convert.flatten_tree(want)
    assert flat_got.keys() == flat_want.keys(), what
    for k, w in flat_want.items():
        np.testing.assert_allclose(flat_got[k], w, atol=5e-5, rtol=1e-4, err_msg=f"{what}: {k}")


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("m,p,v", [(8, 4, 1), (4, 2, 1), (4, 2, 2), (8, 4, 2), (8, 4, 4),
                                   (3, 3, 1), (6, 2, 3)])
def test_schedule_tables_equal_the_reference(m, p, v):
    from tensorflow_examples_tpu.parallel import pipeline as jax_pipeline

    ours, theirs = pipeline._schedule_1f1b(m, p, v), jax_pipeline._schedule_1f1b(m, p, v)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pipeline.interleave_perm(p, v),
                                  jax_pipeline.interleave_perm(p, v))
    if (m, p, v) == (8, 4, 1):
        op, mb, ch, t, depth, q_f, q_b = ours
        assert (t, depth, q_f, q_b) == (22, 4, 2, 2) and (ch == 0).all()
        assert op.shape == (22, 4) and (op == 1).sum() == (op == 2).sum() == 8 * 4


@pytest.mark.parametrize("name", [n for n, _, _ in GRAD_LAYOUTS_4] + ["pipe 1f1b"])
def test_loss_and_grads_match_the_reference(port, reference, name):
    world = "2" if name == "pipe 1f1b" else "4"
    ranks = port[world]
    schedule = "gpipe" if "gpipe" in name else "1f1b"
    want = reference[schedule]
    # Ranks are row-major over (data or model, pipe): each pair of pipe
    # ranks shares a batch shard and reports its loss; the shards' mean
    # is the reference's.
    losses = [r[name]["loss"] for r in ranks]
    assert losses[0::2] == losses[1::2], f"{name}: pipe ranks disagree: {losses}"
    np.testing.assert_allclose(np.mean(losses), want["loss"], rtol=1e-5, err_msg=name)
    _assert_grads(ranks[0][name]["grads"], want["grads"], name)
    np.testing.assert_allclose(np.mean([r[name]["eval_nll"] for r in ranks]),
                               want["eval_nll"], rtol=1e-5, err_msg=name)
    if name.startswith("model+pipe"):
        assert ranks[0][name]["qkv_local"] == (LAYERS // 2, 32, 3, 4 // 2, 8)  # stage, heads cut


def test_interleaved_matches_plain_1f1b_through_the_row_permutation(port):
    ranks = port["2"]
    plain, inter = ranks[0]["pipe 1f1b"], ranks[0]["pipe interleaved"]
    np.testing.assert_allclose(inter["loss"], plain["loss"], rtol=1e-5)
    np.testing.assert_allclose(inter["eval_nll"], plain["eval_nll"], rtol=1e-5)
    key = "blocks_slotmajor_p2v2"
    assert set(inter["grads"]) == {"embed", key}
    unperm = np.argsort(row_perm(2, 2))
    logical = {"embed": inter["grads"]["embed"],
               "blocks": _map(lambda a: a[unperm], inter["grads"][key])}
    _assert_grads(logical, plain["grads"], "interleaved")
    for rank, r in enumerate(ranks):
        for name, v, want in (("pipe 1f1b", 1, (10, 2)), ("pipe interleaved", 2, (18, 2))):
            op = pipeline._schedule_1f1b(4, 2, v)[0]
            assert want == (op.shape[0], int((op[:, rank] == 0).sum())), (name, rank)
            assert r[name]["bubble"] == want, (name, rank, r[name]["bubble"])


def test_trainer_trajectory_matches_the_jax_trainer(port, reference):
    ranks = port["4"]
    losses = ranks[0]["trajectory"]
    assert all(r["trajectory"] == losses for r in ranks), "ranks disagree on the loss"
    np.testing.assert_allclose(losses, reference["trajectory"], rtol=3e-3, atol=0)
    np.testing.assert_allclose(ranks[0]["trajectory zero1"], losses, rtol=1e-6)
    plain, z1 = ranks[0]["opt_bytes"]
    assert z1 < plain  # the embedding's moments cut over `data`, the stages' over `pipe`


def test_checkpoint_restores_bitwise_across_meshes_and_refuses_another_interleave(port):
    saved = CheckpointManager(port["ckpt"]).load(STEPS)["params"]
    assert any(k.startswith("blocks.") for k in saved)
    restored = port["2"][0]["restored"]
    assert restored["step"] == STEPS
    for k, v in saved.items():
        np.testing.assert_array_equal(restored["params"][k], v.numpy(), err_msg=k)
    err = port["2"][0]["restored v2"]["error"]
    assert "does not match the live train state" in err and "blocks_slotmajor_p2v2" in err


class _StageMesh:
    """What the pipeline task reads of a mesh before it raises."""

    def __init__(self, **shape):
        self.shape = {a: shape.get(a, 1) for a in AxisNames.ALL}
        self.trivial = False

    def axis_size(self, axis) -> int:
        return self.shape[axis]

    def axis_index(self, axis) -> int:
        return 0


@pytest.mark.parametrize("kw,mesh,match", [
    ({"moe_experts": 4}, {"pipe": 2}, r"moe_experts=4 with mesh_pipe=2"),
    ({}, {"pipe": 2, "context": 2}, r"mesh_context > 1 with mesh_pipe > 1"),
    ({"tp_vocab": True}, {"pipe": 2, "model": 2}, r"tp_vocab with mesh_pipe > 1"),
    ({"pipe_interleave": 2, "pipeline_schedule": "gpipe"}, {"pipe": 2}, r"requires the 1f1b"),
    ({"pipe_interleave": 3}, {"pipe": 2}, r"not divisible by pipe=2 x interleave=3"),
    ({"pipeline_schedule": "zb"}, {"pipe": 2}, r"unknown pipeline_schedule"),
])
def test_layouts_without_a_pipeline_route_raise(kw, mesh, match):
    with pytest.raises(ValueError, match=match):
        gpt2.make_task(port_cfg(**kw), mesh=_StageMesh(**mesh))


def _torchrun(workdir: str, steps: int, *flags: str):
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:  # a free loopback port for the rendezvous
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
           "2", "--master_addr", "127.0.0.1", "--master_port", str(port), "-m",
           "tensorflow_examples_torch.train.cli", "--device", "cpu", "--vocab_size", "64",
           "--seq_len", "16", "--num_layers", "2", "--num_heads", "2", "--d_model", "32",
           "--global_batch_size", "4", "--train_steps", str(steps), "--log_every", "2",
           "--checkpoint_every", "4", "--telemetry_sinks", "", "--workdir", workdir, *flags]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run(cmd, capture_output=True, text=True, timeout=180, env=env)


def test_train_cli_under_torchrun_on_pipe_resumes(tmp_path):
    """``train.cli`` under torchrun, 2 ranks on ``{data: 1, pipe: 2}`` for
    4 steps, then resumed to 6 on ``{pipe: 2}`` under GPipe with an
    explicit ``--pipe_interleave 1`` (the same storage key)."""
    import json

    wd = str(tmp_path / "run")
    first = _torchrun(wd, 4, "--mesh_data", "1", "--mesh_pipe", "2")
    assert first.returncode == 0, first.stderr[-3000:]
    second = _torchrun(wd, 6, "--mesh_pipe", "2", "--pipe_interleave", "1",
                       "--pipeline_schedule", "gpipe")
    assert second.returncode == 0, second.stderr[-3000:]
    assert "restored checkpoint at step 4" in second.stderr
    results = [json.loads(x) for x in second.stdout.splitlines() if x.startswith("{")]
    assert len(results) == 1 and results[0]["mesh"]["pipe"] == 2
    assert results[0]["steps"] == 6 and np.isfinite(results[0]["loss"])
    assert CheckpointManager(wd).all_steps() == [4, 6]
