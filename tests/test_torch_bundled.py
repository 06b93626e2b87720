"""``steps_per_launch`` in the port (PyTorch/CUDA port), mirroring
``tests/test_bundled_steps.py``: k steps a launch change only the wall
time, never the trajectory. On the CPU the k steps run as a loop; the
graph path (static buffers, staged noise, the write-back) runs here
through a stand-in whose replay reruns the captured function, and on
the card in ``tests/test_torch_cuda.py``. A 6-step trajectory at
``steps_per_launch=2`` is held to the JAX ``Trainer`` at rtol 3e-3.
"""

import types

import jax
import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.data import memory as jax_memory
from tensorflow_examples_tpu.data.prefetch import bundle_batches as jax_bundle_batches
from tensorflow_examples_tpu.sharding import ShardingConfig
from tensorflow_examples_tpu.train import loop as jax_loop
from tensorflow_examples_tpu.workloads import gpt2 as jax_gpt2
from tensorflow_examples_torch.data.memory import train_iterator
from tensorflow_examples_torch.data.prefetch import bundle_batches
from tensorflow_examples_torch.train.checkpoint import CheckpointManager
from tensorflow_examples_torch.train.graphs import BundledStep
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.workloads import gpt2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(**kw):
    base = dict(device="cpu", vocab_size=64, seq_len=16, num_layers=2, num_heads=2, d_model=32,
                dropout=0.0, attention="flash", global_batch_size=8, train_steps=8, log_every=8,
                warmup_steps=2, learning_rate=1e-2, eval_every=0, checkpoint_every=0,
                precision="f32", telemetry_sinks="")
    base.update(kw)
    return gpt2.Gpt2Config(**base)


_DS = gpt2.datasets(tiny_cfg())[0]


def run(cfg, **fit_kw):
    trainer = Trainer(gpt2.make_task(cfg), cfg)
    metrics = trainer.fit(train_iterator(_DS, cfg.global_batch_size, seed=0), **fit_kw)
    return trainer, metrics


def params_vec(trainer):
    return torch.cat([p.reshape(-1) for p in trainer.state.params.values()]).numpy()


@pytest.mark.parametrize("extra", [{}, {"grad_accum_steps": 2}, {"dropout": 0.1}],
                         ids=["plain", "grad_accum", "dropout"])
def test_bundle_matches_unbundled(extra):
    """8 steps as 2 launches of 4 == 8 launches of 1: the same params and
    window loss (accumulation micro-steps and dropout keys tick per step)."""
    t1, m1 = run(tiny_cfg(**extra))
    t4, m4 = run(tiny_cfg(steps_per_launch=4, **extra))
    assert t1.state.step == t4.state.step == 8
    np.testing.assert_allclose(params_vec(t1), params_vec(t4), rtol=2e-5, atol=2e-6)
    assert abs(m1["loss"] - m4["loss"]) < 1e-4


def test_cadence_validation():
    with pytest.raises(ValueError, match="steps_per_launch"):
        run(tiny_cfg(steps_per_launch=3))  # 8 % 3 != 0


def test_resume_phase_validation():
    """A k-unaligned start step is refused even when the span divides by k."""
    cfg = tiny_cfg(steps_per_launch=4, train_steps=14, log_every=0)
    trainer = Trainer(gpt2.make_task(cfg), cfg)
    trainer.state.step = 6  # span 8 % 4 == 0
    with pytest.raises(ValueError, match="start step"):
        trainer.fit(train_iterator(_DS, 8, seed=0))


def test_checkpoint_at_bundle_boundary(tmp_path):
    run(tiny_cfg(steps_per_launch=4, checkpoint_every=4, workdir=str(tmp_path)))
    cfg = tiny_cfg(workdir=str(tmp_path))
    restored = CheckpointManager(str(tmp_path)).restore_latest(
        Trainer(gpt2.make_task(cfg), cfg).state)
    assert restored is not None and restored[1] == 8
    assert CheckpointManager(str(tmp_path)).all_steps() == [4, 8]


def _rerun_graph(fn, generators):
    """A CPU stand-in for a CUDA graph: the capture runs ``fn`` once and a
    replay reruns it, writing the same output tensors."""
    out = fn()

    def replay():
        for o, n in zip(out.values(), fn().values()):
            o.copy_(n)

    return types.SimpleNamespace(replay=replay), out, {}


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe_jitter"])
def test_graph_path_equals_eager_steps(moe):
    """The graph path's static buffers, staged dropout generators and
    staged router jitter reproduce the eager steps bit for bit, and a
    foreign state (a restore) is copied in before the next replay."""
    kw = dict(dropout=0.1, global_batch_size=4, attention="flash")
    if moe:
        kw.update(moe_experts=4, moe_top_k=2, moe_impl="grouped")
    cfg = tiny_cfg(**kw)
    eager = Trainer(gpt2.make_task(cfg), cfg)
    it = train_iterator(_DS, 4, seed=0)
    losses = [float(eager.train_step(next(it))["loss"]) for _ in range(4)]
    trainer = Trainer(gpt2.make_task(cfg), cfg)
    start = trainer.state
    step = BundledStep(trainer, 2, graph=True, graph_factory=_rerun_graph)
    bundles = bundle_batches(train_iterator(_DS, 4, seed=0), 2)
    ours = []
    for _ in range(2):
        batch = {k: torch.as_tensor(v) for k, v in next(bundles).items()}
        trainer.state, metrics = step(trainer.state, batch)
        ours += metrics["loss"].tolist()
    assert ours == losses and step.captured == 1 and trainer.state.step == 4
    for name, p in eager.state.params.items():
        assert torch.equal(p, trainer.state.params[name]), name
    trainer.state, metrics = step(start, {k: torch.as_tensor(v) for k, v in next(
        bundle_batches(train_iterator(_DS, 4, seed=0), 2)).items()})
    assert metrics["loss"].tolist() == losses[:2] and trainer.state.step == 2


def test_six_step_trajectory_matches_jax_trainer_two_steps_a_launch():
    """The port at steps_per_launch=2 against the JAX Trainer's steps, on
    the same init and batches: window means of 2 steps at rtol 3e-3."""
    base = dict(vocab_size=64, seq_len=16, num_layers=2, num_heads=4, d_model=32, dropout=0.0,
                attention="xla", global_batch_size=16, train_steps=30, warmup_steps=5,
                learning_rate=3e-3, eval_every=0, precision="f32")
    jax_cfg = jax_gpt2.Gpt2Config(checkpoint_every=0, log_every=10, **base)
    sc = ShardingConfig(mesh={"data": 1})
    mesh = sc.build_mesh()
    jt = jax_loop.Trainer(jax_gpt2.make_task(jax_cfg, mesh=mesh), jax_cfg, mesh=mesh, sharding=sc)
    init = jax.tree.map(np.asarray, jt.state.params)
    ds, _ = jax_gpt2.datasets(jax_cfg)
    it = jax_memory.train_iterator(ds, 16, seed=0)
    state, theirs = jt.state, []
    for _ in range(6):
        state, metrics = jt._train_step(state, jt._put_batch(next(it)))
        theirs.append(float(metrics["loss"]))
    cfg = gpt2.Gpt2Config(device="cpu", log_every=2, steps_per_launch=2, telemetry_sinks="",
                          **base)
    trainer = Trainer(gpt2.make_task(cfg), cfg, init_params=init)
    trainer.fit(train_iterator(gpt2.datasets(cfg)[0], 16, seed=0), num_steps=6)
    ours = [h["loss"] for h in trainer.history]
    assert [h["step"] for h in trainer.history] == [2, 4, 6] and ours[-1] < ours[0]
    np.testing.assert_allclose(ours, np.reshape(theirs, (3, 2)).mean(axis=1), rtol=3e-3, atol=0)


class TestBundleBatches:
    def test_stacks_k_batches_as_the_reference(self):
        make = lambda: iter([{"x": np.full((2, 3), i)} for i in range(6)])
        ours, theirs = list(bundle_batches(make(), 3)), list(jax_bundle_batches(make(), 3))
        assert len(ours) == len(theirs) == 2
        assert ours[0]["x"].shape == (3, 2, 3) and ours[1]["x"][0, 0, 0] == 3
        assert all(np.array_equal(a["x"], b["x"]) for a, b in zip(ours, theirs))

    def test_partial_bundle_raises(self):
        gen = bundle_batches(iter([{"x": np.zeros(2)} for _ in range(5)]), 3)
        next(gen)
        with pytest.raises(ValueError, match="mid-bundle"):
            next(gen)

    def test_clean_exhaustion(self):
        assert list(bundle_batches(iter([]), 4)) == []
