"""The port's checkpoints, preemption, bad-step escalation and telemetry
(PyTorch/CUDA port), mirroring ``tests/test_resilience.py``.

Everything runs on the CPU on a one-layer GPT-2 with dropout on, so a
bitwise resume needs the data order and the dropout keys to be functions
of the step. Faults are injected by the port's fault plan (a SIGTERM
right before a step, ``utils/faults.py``) and by the test's own data:
NaN losses through a ``scale`` entry that the test's task multiplies
into the loss. Every
telemetry line the port writes must pass the JAX package's
``telemetry.schema.validate_line`` as well as the port's own.
"""

import json
import logging
import os
import signal

import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.telemetry import schema as jax_schema
from tensorflow_examples_torch.data.memory import train_iterator
from tensorflow_examples_torch.telemetry import accounting, schema, sinks
from tensorflow_examples_torch.telemetry.registry import default_registry
from tensorflow_examples_torch.telemetry.spans import Tracer
from tensorflow_examples_torch.train import cli, optimizers, resilience
from tensorflow_examples_torch.train import eval as eval_cli
from tensorflow_examples_torch.train.checkpoint import STATE_NAME, CheckpointManager
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.train.task import Task
from tensorflow_examples_torch.utils import faults
from tensorflow_examples_torch.workloads import gpt2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(**kw):
    base = dict(device="cpu", vocab_size=64, seq_len=16, num_layers=1, num_heads=2, d_model=32,
                dropout=0.1, attention="flash", global_batch_size=8, train_steps=6,
                warmup_steps=2, learning_rate=3e-3, log_every=50, eval_every=0,
                checkpoint_every=100, precision="f32", telemetry_sinks="jsonl")
    base.update(kw)
    return gpt2.Gpt2Config(**base)


_DS = gpt2.datasets(tiny_cfg())[0]


@pytest.fixture(autouse=True)
def _no_fault_plan():
    yield
    faults.clear()


def data_fn(sigterm_at=None, nan_at=()):
    """A ``start -> iterator`` of the tiny run's batches, each with a
    ``scale`` of 1; NaN at the step indices of ``nan_at`` (each fires
    once, so a replay after a rollback is clean); a SIGTERM to this
    process right before step ``sigterm_at`` runs (the fault plan's
    ``sigterm@N``: the loop prefetches batches ahead, so a signal sent
    from the iterator would land steps early)."""
    poison = set(nan_at)
    if sigterm_at is None:
        faults.clear()
    else:
        faults.install(f"sigterm@{sigterm_at}")

    def make(start):
        for step, batch in enumerate(train_iterator(_DS, 8, seed=3, start_step=start), start):
            scale = np.full(8, np.nan if step in poison else 1.0, np.float32)
            poison.discard(step)
            yield {**batch, "scale": scale}

    return make


def scaled_task(cfg):
    task = gpt2.make_task(cfg)

    def loss_fn(params, model_state, batch, *, rng, train):
        batch = dict(batch)
        scale = batch.pop("scale")
        loss, metrics, ms = task.loss_fn(params, model_state, batch, rng=rng, train=train)
        return loss * scale.mean(), metrics, ms

    return Task("scaled", task.init_fn, loss_fn, task.make_optimizer, task.eval_fn)


def leaves(state):
    return optimizers.tree_leaves({"p": state.params, "o": state.opt_state})


def assert_bitwise(a, b):
    assert a.step == b.step
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)


def read_lines(workdir):
    with open(sinks.metrics_path(str(workdir))) as f:
        return [json.loads(line) for line in f]


# ------------------------------------------------------ checkpoint/resume


def test_preempt_and_restart_resume_bitwise(tmp_path):
    """SIGTERM mid-run: a clean ``Preempted`` (code 0) with a checkpoint
    at the step boundary; the resumed run's params and optimizer state
    equal an uninterrupted run's bit for bit. A plain restart of a run
    cut short does too."""
    cfg_a = tiny_cfg(workdir=str(tmp_path / "a"))
    tr_a = Trainer(scaled_task(cfg_a), cfg_a)
    tr_a.fit(data_fn())

    cfg_b = tiny_cfg(workdir=str(tmp_path / "b"))
    with pytest.raises(resilience.Preempted) as exc:
        Trainer(scaled_task(cfg_b), cfg_b).fit(data_fn(sigterm_at=3))
    assert exc.value.code == 0 and exc.value.step == 4 and exc.value.signum == signal.SIGTERM
    assert CheckpointManager(cfg_b.workdir).all_steps() == [4]
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL  # handlers restored
    tr_b = Trainer(scaled_task(cfg_b), cfg_b)
    tr_b.fit(data_fn())
    assert_bitwise(tr_a.state, tr_b.state)
    assert [h["step"] for h in tr_b.history] == [6]
    finals = [x for x in read_lines(cfg_b.workdir) if x["kind"] == "final"]
    assert [x["exit_reason"] for x in finals] == ["preempt", "complete"]

    cfg_c = tiny_cfg(workdir=str(tmp_path / "c"))
    Trainer(scaled_task(cfg_c), cfg_c).fit(data_fn(), num_steps=2)
    tr_c = Trainer(scaled_task(cfg_c), cfg_c)
    tr_c.fit(data_fn())
    assert_bitwise(tr_a.state, tr_c.state)


def test_preempt_without_workdir_still_exits_cleanly():
    cfg = tiny_cfg(telemetry_sinks="")
    with pytest.raises(resilience.Preempted) as exc:
        Trainer(scaled_task(cfg), cfg).fit(data_fn(sigterm_at=1))
    assert exc.value.code == 0 and exc.value.step == 2


def test_corrupt_latest_falls_back_with_the_file_named(tmp_path, caplog):
    cfg = tiny_cfg(workdir=str(tmp_path), checkpoint_every=2)
    trainer = Trainer(scaled_task(cfg), cfg)
    trainer.fit(data_fn())
    mngr = CheckpointManager(cfg.workdir)
    assert mngr.all_steps() == [2, 4, 6] and mngr.verify_step_integrity(6) == []
    path = os.path.join(mngr.step_dir(6), STATE_NAME)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with caplog.at_level(logging.WARNING):
        state, step = mngr.restore_latest(Trainer(scaled_task(cfg), cfg).state)
    assert step == 4 and state.step == 4
    assert "sha256 mismatch in state.pt" in caplog.text and "step 6" in caplog.text
    for s in (2, 4):
        os.remove(os.path.join(mngr.step_dir(s), STATE_NAME))
    with pytest.raises(RuntimeError, match="every checkpoint .* is corrupt") as exc:
        mngr.restore_latest(state)
    assert "missing file state.pt" in str(exc.value)


def test_restore_validates_structure_naming_the_paths(tmp_path):
    cfg = tiny_cfg(workdir=str(tmp_path), train_steps=1)
    Trainer(scaled_task(cfg), cfg).fit(data_fn())
    wider = tiny_cfg(workdir=str(tmp_path), d_model=64)
    with pytest.raises(ValueError, match="does not match the live train state") as exc:
        CheckpointManager(cfg.workdir).restore_latest(Trainer(scaled_task(wider), wider).state)
    assert "h_0.attn.qkv.kernel: checkpoint (32, 3, 2, 16) vs live (64, 3, 2, 32)" in str(
        exc.value)
    deeper = tiny_cfg(workdir=str(tmp_path), num_layers=2)
    with pytest.raises(ValueError, match="missing from checkpoint: params/h_1.ln_1.scale"):
        CheckpointManager(cfg.workdir).restore_latest(Trainer(scaled_task(deeper), deeper).state)


def test_async_save_keeps_max_to_keep_and_closes(tmp_path):
    cfg = tiny_cfg()
    state = Trainer(scaled_task(cfg), cfg).state
    with CheckpointManager(str(tmp_path), max_to_keep=2) as mngr:
        for step in (1, 2, 3):
            mngr.save(step, state)
            assert mngr.latest_step() == step
    assert mngr.all_steps() == [2, 3]
    assert not [n for n in os.listdir(mngr.directory) if n.startswith(".tmp")]
    saved, step = mngr.load_latest()
    assert step == 3 and saved["step"] == 3
    for k, t in state.params.items():
        assert torch.equal(saved["params"][k], t)


# ---------------------------------------------------------- bad steps


def test_skip_policy_drops_the_step_and_counts_it():
    before = default_registry().counter_values().get("resilience/bad_steps", 0)
    cfg = tiny_cfg(train_steps=8, bad_step_policy="skip", log_every=4, telemetry_sinks="")
    trainer = Trainer(scaled_task(cfg), cfg)
    metrics = trainer.fit(data_fn(nan_at=(2,)))
    assert trainer.state.step == 8 and trainer._guard.bad_steps_seen == 1
    assert all(torch.isfinite(t).all() for t in trainer.state.params.values())
    assert np.isfinite(trainer.history[0]["loss"]) and trainer.history[0]["bad_step"] == 0.25
    assert np.isfinite(metrics["loss"])
    assert default_registry().counter_values()["resilience/bad_steps"] - before == 1


def test_rollback_policy_restores_and_replays(tmp_path):
    cfg = tiny_cfg(train_steps=12, checkpoint_every=4, workdir=str(tmp_path),
                   bad_step_policy="rollback", bad_step_patience=3)
    trainer = Trainer(scaled_task(cfg), cfg)
    trainer.fit(data_fn(nan_at=(6, 7, 8)))
    assert trainer._guard.rollbacks == 1 and trainer.state.step == 12
    assert all(torch.isfinite(t).all() for t in trainer.state.params.values())
    counters = read_lines(tmp_path)[-1]["counters"]
    assert counters["resilience/rollbacks"] == 1 and counters["resilience/bad_steps"] == 3


@pytest.mark.parametrize("policy,nan_at,workdir,match", [
    ("abort", (2,), False, "policy=abort"),
    ("skip", tuple(range(2, 8)), False, "consecutive bad steps"),
    ("rollback", (2, 3, 4, 5), False, "needs a checkpoint"),
])
def test_escalation_aborts(tmp_path, policy, nan_at, workdir, match):
    cfg = tiny_cfg(train_steps=10, bad_step_policy=policy, bad_step_patience=3,
                   workdir=str(tmp_path) if workdir else "")
    with pytest.raises(resilience.BadStepError, match=match):
        Trainer(scaled_task(cfg), cfg).fit(data_fn(nan_at=nan_at))


def test_abort_lands_an_error_final_line(tmp_path):
    cfg = tiny_cfg(train_steps=10, bad_step_policy="abort", workdir=str(tmp_path))
    with pytest.raises(resilience.BadStepError):
        Trainer(scaled_task(cfg), cfg).fit(data_fn(nan_at=(1,)))
    assert read_lines(tmp_path)[-1]["exit_reason"] == "error:BadStepError"


def test_guard_spike_detection_and_repeat_rollback():
    g = resilience.BadStepGuard("abort", spike_factor=5.0)
    for step, loss in enumerate([1.0, 1.1, 0.9, 1.0]):
        g.observe(step, {"loss": torch.tensor(loss), "bad_step": torch.tensor(0.0)})
    assert g.poll() is None  # CPU entries are ready at once
    g.observe(4, {"loss": torch.tensor(100.0), "bad_step": torch.tensor(0.0)})
    with pytest.raises(resilience.BadStepError, match="bad train step 4"):
        g.poll()
    g = resilience.BadStepGuard("rollback", patience=1)
    g.note_rollback(4)
    with pytest.raises(resilience.BadStepError, match="not transient"):
        g.note_rollback(4)
    with pytest.raises(ValueError, match="bad_step_policy"):
        resilience.BadStepGuard("explode")
    with pytest.raises(ValueError, match="bad_step_policy"):
        Trainer(scaled_task(tiny_cfg()), tiny_cfg(bad_step_policy="explode"))
    assert resilience.BadStepGuard.from_config(tiny_cfg(bad_step_policy="off")) is None


def test_guard_patience_counts_consecutive_steps_only():
    g = resilience.BadStepGuard("skip", patience=3)
    for step, bad in enumerate([1, 1, 0, 1, 1, 0]):
        g.observe(step, {"loss": torch.tensor(1.0), "bad_step": torch.tensor(float(bad))})
    assert g.poll() is None and g.bad_steps_seen == 4
    for step in (6, 7, 8):
        g.observe(step, {"loss": torch.tensor(float("nan"))})
    with pytest.raises(resilience.BadStepError, match="3 consecutive bad steps ending at 8"):
        g.poll()


# ----------------------------------------------------------- telemetry


def test_every_jsonl_line_passes_both_schemas(tmp_path):
    cfg = tiny_cfg(train_steps=4, log_every=2, eval_every=2, workdir=str(tmp_path),
                   telemetry_sinks="jsonl,tensorboard,console", checkpoint_every=2)
    trainer = Trainer(gpt2.make_task(cfg), cfg)
    _, eval_ds = gpt2.datasets(cfg)
    from tensorflow_examples_torch.data.memory import eval_batches

    trainer.fit(lambda start: train_iterator(_DS, 8, seed=0, start_step=start),
                eval_iter_fn=lambda: eval_batches(eval_ds, 8))
    lines = read_lines(tmp_path)
    assert [x["kind"] for x in lines] == ["memory", "window", "fleet", "eval", "window", "fleet",
                                          "eval", "final"]
    for line in lines:
        assert jax_schema.validate_line(line) == [], line
        assert schema.validate_line(line) == [], line
    window = lines[4]
    assert window["counters"]["train/steps_total"] == 4
    assert window["counters"]["checkpoint/saves"] == 1
    assert window["derived"]["goodput"] == 1.0 and window["derived"]["mfu"] > 0
    assert window["derived"]["tokens_per_sec"] == pytest.approx(
        window["metrics"]["train/examples_per_sec"] * 16)
    assert lines[0]["memory"]["params_bytes"] == 4 * trainer.n_params
    assert lines[-1]["exit_reason"] == "complete"
    trace = json.load(open(sinks.trace_path(str(tmp_path))))
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"data_fetch", "device_step", "metric_flush", "eval", "checkpoint_save"} <= names
    bad = dict(lines[1], kind="fleet")
    assert schema.validate_line(bad) and schema.validate_line({**lines[1], "step": -1})


def test_sinks_tracer_and_accounting():
    with pytest.raises(ValueError, match="unknown telemetry sink"):
        sinks.make_sinks("jsonl,bogus", "")
    assert [type(s).__name__ for s in sinks.make_sinks("jsonl,tensorboard,console", "")] == [
        "ConsoleSink"]
    tracer = Tracer(now_ns=iter(range(0, 10**9, 1000)).__next__)
    with tracer.span("outer"):
        with tracer.span("inner", step=3):
            assert tracer.active_span_names() == ["inner"]
    events = tracer.chrome_trace()["traceEvents"]
    assert [e["name"] for e in events] == ["inner", "outer"] and events[0]["args"] == {"step": 3}
    assert accounting.peak_flops_per_device("NVIDIA H100 80GB HBM3") == (989.4e12, True)
    assert accounting.peak_flops_per_device("cpu") == (1e12, False)
    assert accounting.train_step_flops(10, 4, 8) == 6 * 10 * 4 * 8
    assert accounting.goodput({"train/steps_total": 10, "resilience/bad_steps": 1,
                               "resilience/steps_lost": 2}) == 0.7
    assert accounting.mfu(1e12, 2.0, 4e12) == 0.5 and accounting.mfu(1e12, None, 4e12) is None


# ----------------------------------------------------------------- CLIs


def test_cli_checkpoints_resumes_and_eval_restores(tmp_path, capsys):
    flags = ["--workload", "gpt2", "--device", "cpu", "--vocab_size", "64", "--seq_len", "16",
             "--num_layers", "1", "--num_heads", "2", "--d_model", "32",
             "--global_batch_size", "4", "--warmup_steps", "1", "--log_every", "1",
             "--eval_every", "0", "--workdir", str(tmp_path)]
    assert cli.main(flags + ["--train_steps", "2", "--checkpoint_every", "1"]) == 0
    assert cli.main(flags + ["--train_steps", "3"]) == 0
    first, second = (json.loads(x) for x in capsys.readouterr().out.strip().splitlines())
    assert (first["steps"], second["steps"]) == (2, 3)
    assert CheckpointManager(str(tmp_path)).all_steps() == [1, 2, 3]
    assert eval_cli.main(flags) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 3 and out["eval_nll"] == pytest.approx(second["eval_nll"], rel=1e-6)
    with pytest.raises(SystemExit) as exc:
        eval_cli.main(flags[:-2])
    assert exc.value.code == 2 and "--workdir is required" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="no checkpoint"):
        eval_cli.main(flags[:-1] + [str(tmp_path / "empty")])
