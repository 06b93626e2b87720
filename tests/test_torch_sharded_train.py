"""The port's ``Trainer`` on meshes against the JAX package's.

Spawned gloo worlds (``core/distributed.run_world``; a ``file://`` store
under ``tmp_path``, one torch thread a rank, a timeout on every world)
train the tiny GPT-2 of ``tests/test_sharding.py`` (f32, dropout 0) for
3 steps on each layout, off the same seeded batches as the reference's
``run_steps``. Every layout's trajectory is held to the JAX ``Trainer``
on the same layout at rtol 3e-3, and ZeRO-1 to data parallelism at
1e-6 (``tests/test_sharding.py:306-360``): data, ZeRO-1, FSDP, TP with
``tp_vocab`` (the vocab 64 divides, so the table itself is split),
context parallelism over the ring and Ulysses, and the 2-D layouts. The
checkpoint of a 2-D run restores bit for bit on other mesh shapes; a
drifted rules table raises ``ShardingMismatchError``; the final line
carries the ``sharding`` object; the eval on every layout gives the
one-device mean; uneven per-rank eval streams are padded as the
reference's ``_pad_per_host_batches`` pads them.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from tensorflow_examples_torch.core import distributed
from tensorflow_examples_torch.models import transformer
from tensorflow_examples_torch.sharding import ShardingConfig, ShardingMismatchError
from tensorflow_examples_torch.sharding.config import rules_to_json
from tensorflow_examples_torch.train.checkpoint import CheckpointManager
from tensorflow_examples_torch.train.loop import Trainer, _pad_per_host_batches
from tensorflow_examples_torch.workloads import gpt2

STEPS = 3
WORLD_TIMEOUT_S = 240
# (name, mesh, port config overrides, the reference's layout)
LAYOUTS_2 = (
    ("data", {"data": 2}, {}),
    ("data+zero1", {"data": 2}, {"zero1": True}),
    ("fsdp", {"fsdp": 2}, {}),
    ("model+tp_vocab", {"model": 2}, {"tp_vocab": True}),
    ("context ring", {"context": 2}, {"attention": "flash"}),
    ("context ulysses", {"context": 2}, {"attention": "ulysses"}),
)
LAYOUTS_4 = (
    ("data+model", {"data": 2, "model": 2}, {}),
    ("fsdp+model+zero1", {"fsdp": 2, "model": 2}, {"zero1": True}),
    ("data+context", {"data": 2, "context": 2}, {"attention": "flash"}),
)


def tiny_cfg(**kw):
    base = dict(vocab_size=64, seq_len=16, num_layers=2, num_heads=4, d_model=32, dropout=0.0,
                attention="xla", global_batch_size=16, train_steps=STEPS, warmup_steps=5,
                learning_rate=3e-3, log_every=10, checkpoint_every=0, eval_every=0,
                precision="f32", watchdog_secs=0)
    base.update(kw)
    return base


def port_cfg(**kw):
    kw.setdefault("telemetry_sinks", "")
    return gpt2.Gpt2Config(device="cpu", **tiny_cfg(**kw))


def batches(cfg, n: int = STEPS):
    """The reference's ``run_steps`` stream."""
    rng = np.random.RandomState(0)
    return [{"tokens": rng.randint(0, cfg.vocab_size, size=(cfg.global_batch_size,
                                                             cfg.seq_len + 1)).astype(np.int32)}
            for _ in range(n)]


def eval_stream(cfg):
    """Two eval batches, the second with 3 padding rows (mask 0)."""
    rng = np.random.RandomState(5)
    mask = np.ones(cfg.global_batch_size, np.float32)
    mask[-3:] = 0.0
    return [{"tokens": rng.randint(0, cfg.vocab_size, size=(cfg.global_batch_size,
                                                             cfg.seq_len + 1)).astype(np.int32),
             "mask": m} for m in (np.ones_like(mask), mask)]


def make_trainer(mesh_kw: dict, **kw):
    cfg = port_cfg(**kw)
    sc = ShardingConfig(mesh=mesh_kw, zero1=cfg.zero1)
    mesh = sc.build_mesh()
    return Trainer(gpt2.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc), cfg


def run_steps(trainer, cfg) -> list[float]:
    return [float(trainer.train_step(b)["loss"]) for b in batches(cfg)]


def _layouts_worker(rank: int, layouts, ckpt_dir) -> dict:
    out = {}
    for name, mesh_kw, kw in layouts:
        trainer, cfg = make_trainer(mesh_kw, **kw)
        eval0 = trainer.evaluate(iter(eval_stream(cfg)))["nll"]
        out[name] = {"eval0": eval0, "losses": run_steps(trainer, cfg),
                     "opt_bytes": trainer.byte_breakdown(per_device=True)["opt_state"],
                     "opt_bytes_global": trainer.byte_breakdown()["opt_state"]}
        if name == "data+model" and ckpt_dir:
            CheckpointManager(ckpt_dir, layout=trainer.layout, primary=rank == 0).save(
                STEPS, trainer.state)
            torch.distributed.barrier()
    if ckpt_dir:
        # The 2-D checkpoint restored on another mesh shape, gathered back.
        trainer, _ = make_trainer({"fsdp": 2, "model": 2})
        with CheckpointManager(ckpt_dir, layout=trainer.layout, primary=rank == 0) as ckpt:
            state, step = ckpt.restore_latest(trainer.state)
        whole = trainer.layout.gather_state({"params": state.params})["params"]
        out["restored"] = {"step": step, "params": {k: v.numpy() for k, v in whole.items()},
                           "qkv_local": tuple(state.params["h_0.attn.qkv.kernel"].shape)}
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    two = distributed.run_world(_layouts_worker, 2, LAYOUTS_2, None, timeout_s=WORLD_TIMEOUT_S,
                                store_dir=str(tmp_path_factory.mktemp("w2")))
    four = distributed.run_world(_layouts_worker, 4, LAYOUTS_4, ckpt, timeout_s=WORLD_TIMEOUT_S,
                                 store_dir=str(tmp_path_factory.mktemp("w4")))
    return {"2": two, "4": four, "ckpt": ckpt}


def reference_losses(mesh_kw: dict, **kw) -> list[float]:
    """The JAX ``Trainer`` on the same layout (``tests/test_sharding.py``
    ``run_steps``), the GPT-2 rules embedded in its config."""
    from tensorflow_examples_tpu.models import transformer as jax_transformer
    from tensorflow_examples_tpu.sharding import ShardingConfig as JaxShardingConfig
    from tensorflow_examples_tpu.sharding.config import rules_to_json as jax_rules_to_json
    from tensorflow_examples_tpu.train.loop import Trainer as JaxTrainer
    from tensorflow_examples_tpu.workloads import gpt2 as jax_gpt2

    zero1 = kw.pop("zero1", False)
    cfg = jax_gpt2.Gpt2Config(**tiny_cfg(**kw))
    sc = JaxShardingConfig(mesh=mesh_kw, zero1=zero1, rules=() if cfg.tp_vocab else
                           jax_rules_to_json(jax_transformer.GPT2_RULES))
    mesh = sc.build_mesh()
    trainer = JaxTrainer(jax_gpt2.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc)
    state, losses = trainer.state, []
    for b in batches(cfg):
        state, metrics = trainer._train_step(state, trainer._put_batch(b))
        losses.append(float(metrics["loss"]))
    return losses


@pytest.fixture(scope="module")
def one_device():
    return reference_losses({"data": 1})


def _reference_layout(mesh_kw, kw):
    """The reference's run for a layout: its attention stays "xla" (the
    plain math the ring and Ulysses compute; its flash kernels in
    interpret mode would cost minutes)."""
    return reference_losses(dict(mesh_kw), **{k: v for k, v in kw.items() if k != "attention"})


@pytest.mark.parametrize("world,name", [("2", n) for n, _, _ in LAYOUTS_2]
                         + [("4", n) for n, _, _ in LAYOUTS_4])
def test_trajectory_matches_the_reference_on_the_same_layout(port, one_device, world, name):
    layouts = {n: (m, kw) for n, m, kw in LAYOUTS_2 + LAYOUTS_4}
    mesh_kw, kw = layouts[name]
    ranks = port[world]
    losses = ranks[0][name]["losses"]
    assert all(r[name]["losses"] == losses for r in ranks), "ranks disagree on the loss"
    want = _reference_layout(mesh_kw, kw)
    np.testing.assert_allclose(losses, want, rtol=3e-3, atol=0, err_msg=name)
    np.testing.assert_allclose(losses, one_device, rtol=3e-3, atol=0, err_msg=name)


def test_eval_on_every_layout_equals_one_device(port):
    """The eval's weighted totals, summed over the batch axes and
    averaged over context, give the one-device mean over the real rows
    (the same initial parameters on every layout)."""
    trainer, cfg = make_trainer({"data": 1})
    want = trainer.evaluate(iter(eval_stream(cfg)))["nll"]
    for world in ("2", "4"):
        for r in port[world]:
            for name, got in r.items():
                if name != "restored":
                    assert got["eval0"] == pytest.approx(want, rel=1e-6), (world, name)


def test_zero1_matches_data_parallel_and_shards_the_moments(port):
    ranks = port["2"]
    dp, z1 = ranks[0]["data"], ranks[0]["data+zero1"]
    np.testing.assert_allclose(z1["losses"], dp["losses"], rtol=1e-6)
    assert z1["opt_bytes_global"] == dp["opt_bytes_global"]
    assert z1["opt_bytes"] < 0.6 * dp["opt_bytes"]  # every divisible moment halved


def test_checkpoint_restores_bitwise_across_mesh_shapes(port):
    saved = CheckpointManager(port["ckpt"]).load(STEPS)["params"]
    restored = port["4"][0]["restored"]
    assert restored["step"] == STEPS
    assert restored["qkv_local"] == (32 // 2, 3, 4 // 2, 8)  # fsdp rows and model heads cut
    for k, v in saved.items():
        np.testing.assert_array_equal(restored["params"][k], v.numpy(), err_msg=k)
    # ... and on one device, through the plain trainer.
    trainer, _ = make_trainer({"data": 1})
    with CheckpointManager(port["ckpt"]) as ckpt:
        state, step = ckpt.restore_latest(trainer.state)
    assert step == STEPS
    for k, v in saved.items():
        assert torch.equal(state.params[k], v), k


def test_drifted_rules_fail_with_a_named_error_and_final_line_carries_sharding(tmp_path):
    from tensorflow_examples_tpu.telemetry import schema as jax_schema
    from tensorflow_examples_torch.core.sharding import ShardingRules

    wd = str(tmp_path)
    cfg = port_cfg(workdir=wd, telemetry_sinks="jsonl", train_steps=1)
    trainer = Trainer(gpt2.make_task(cfg), cfg)
    trainer.fit(iter(batches(cfg)))
    doc = json.load(open(os.path.join(wd, "sharding.json")))
    assert doc["param_sharding_digest"] == trainer.sharding_digest()
    assert doc["config"]["rules"] == json.loads(json.dumps(rules_to_json(transformer.GPT2_RULES)))
    final = [json.loads(x) for x in open(os.path.join(wd, "telemetry", "metrics.jsonl"))][-1]
    assert final["kind"] == "final" and final["sharding"] == {
        "mesh_shape": {"data": 1, "fsdp": 1, "model": 1, "context": 1, "pipe": 1},
        "param_sharding_digest": trainer.sharding_digest(), "zero1": False}
    assert jax_schema.validate_line(final) == []
    drifted = ShardingConfig(mesh={"data": 1}, rules=rules_to_json(
        ShardingRules([(r"mlp_fc/kernel", ("model", "fsdp"))])))
    other = Trainer(gpt2.make_task(cfg), cfg.replace(train_steps=2), sharding=drifted)
    with pytest.raises(ShardingMismatchError, match=r"h_0/mlp_fc/kernel: saved"):
        other.fit(iter(batches(cfg)))


def _pad_worker(rank: int, counts) -> dict:
    rows = [{"tokens": np.full((2, 3), 10 * rank + i, np.int32)} for i in range(counts[rank])]
    try:
        got = list(_pad_per_host_batches(iter(rows)))
    except ValueError as e:
        return {"error": str(e)}
    trainer, cfg = make_trainer({"data": 2})
    evals = [{"tokens": np.random.RandomState(rank * 7 + i).randint(
        0, 64, size=(4, cfg.seq_len + 1)).astype(np.int32)} for i in range(counts[rank])]
    return {"batches": got, "eval": trainer.evaluate(iter(evals), per_host=True),
            "evals": evals}


def test_uneven_per_rank_eval_streams_are_padded(tmp_path):
    ranks = distributed.run_world(_pad_worker, 2, (3, 1), timeout_s=WORLD_TIMEOUT_S,
                                  store_dir=str(tmp_path))
    short = ranks[1]["batches"]
    assert len(ranks[0]["batches"]) == len(short) == 3
    np.testing.assert_array_equal(short[0]["mask"], np.ones(2, np.float32))
    for pad in short[1:]:  # zero-weight copies of the last real batch's shape
        assert not pad["mask"].any() and pad["tokens"].shape == (2, 3)
    assert ranks[0]["eval"] == ranks[1]["eval"]
    # Padding changes nothing: every real row once, on one device.
    trainer, _ = make_trainer({"data": 1})
    real = ranks[0]["evals"] + ranks[1]["evals"]
    want = trainer.evaluate(iter([{"tokens": np.concatenate([b["tokens"] for b in real])}]))
    assert ranks[0]["eval"]["nll"] == pytest.approx(want["nll"], rel=1e-6)
    empty = distributed.run_world(_pad_worker, 2, (2, 0), timeout_s=WORLD_TIMEOUT_S,
                                  store_dir=str(tmp_path))
    assert all("at least one local batch" in r["error"] for r in empty)


def _torchrun(workdir: str, steps: int, *mesh_flags: str):
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
           "--checkpoint_every", "4", "--telemetry_sinks", "jsonl", "--workdir", workdir,
           *mesh_flags]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run(cmd, capture_output=True, text=True, timeout=180, env=env)


def test_train_cli_under_torchrun_resumes_on_another_mesh(tmp_path):
    """``train.cli`` under torchrun, 2 ranks: ``{data: 2}`` for 4 steps,
    then a resume on ``{model: 2}`` to 6; rank 0 prints the one result
    line and writes the only telemetry file."""
    wd = str(tmp_path / "run")
    first = _torchrun(wd, 4, "--mesh_data", "2")
    assert first.returncode == 0, first.stderr[-3000:]
    second = _torchrun(wd, 6, "--mesh_model", "2")
    assert second.returncode == 0, second.stderr[-3000:]
    assert "restored checkpoint at step 4" in second.stderr
    for run, mesh in ((first, {"data": 2}), (second, {"model": 2})):
        results = [json.loads(x) for x in run.stdout.splitlines() if x.startswith("{")]
        assert len(results) == 1 and all(results[0]["mesh"][k] == v for k, v in mesh.items())
    assert results[0]["steps"] == 6 and np.isfinite(results[0]["loss"])
    # rank 0's files only: no per-rank shards
    assert sorted(os.listdir(os.path.join(wd, "telemetry"))) == ["metrics.jsonl", "trace.json"]
    assert CheckpointManager(wd).all_steps() == [4, 6]
