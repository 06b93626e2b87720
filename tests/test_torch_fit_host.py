"""The host side of the port's ``fit`` (PyTorch/CUDA port): the fault
plan's grammar against the reference's ``parse_spec``, ``retry_io``'s
backoff, the poisoned-batch budget, the prefetch depth controller
against the reference's, the watchdog's dump and its fatal
exit, the profiler window, ``debug_nans`` and the ``compile_warning``
line; every line checked with the reference's ``validate_line``, the
serving lines too (dense, paged, speculative, int8 weights).
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.data import prefetch as jax_prefetch
from tensorflow_examples_tpu.telemetry import registry as jax_registry
from tensorflow_examples_tpu.telemetry import schema as jax_schema
from tensorflow_examples_tpu.utils import faults as jax_faults
from tensorflow_examples_torch.data.memory import train_iterator
from tensorflow_examples_torch.data.prefetch import DepthController, device_prefetch
from tensorflow_examples_torch.models import transformer
from tensorflow_examples_torch.serving.batcher import ContinuousBatcher, Request
from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
from tensorflow_examples_torch.telemetry import schema, sinks
from tensorflow_examples_torch.telemetry.registry import MetricsRegistry, default_registry
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.train.task import Task
from tensorflow_examples_torch.utils import faults
from tensorflow_examples_torch.utils.diagnostics import HUNG_EXIT_CODE
from tensorflow_examples_torch.workloads import gpt2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    faults.clear()


def tiny_cfg(**kw):
    base = dict(device="cpu", vocab_size=64, seq_len=16, num_layers=1, num_heads=2, d_model=32,
                dropout=0.1, global_batch_size=4, train_steps=6, warmup_steps=2, log_every=3,
                eval_every=0, checkpoint_every=0, precision="f32", telemetry_sinks="jsonl")
    base.update(kw)
    return gpt2.Gpt2Config(**base)


_DS = gpt2.datasets(tiny_cfg())[0]


def data(start=0):
    return train_iterator(_DS, 4, seed=0, start_step=start)


def read_lines(workdir):
    with open(sinks.metrics_path(str(workdir))) as f:
        return [json.loads(line) for line in f]


def assert_valid(lines):
    for line in lines:
        assert jax_schema.validate_line(line) == [], line
        assert schema.validate_line(line) == [], line


@pytest.mark.parametrize("spec", [
    "sigterm@10,nan@5:2,slow@3:8,ioerr@2,badbatch@1", "nan@4", "slow@7", " ioerr@1 , ioerr@2 ",
    "", "boom@1", "nan", "nan@x", "slow@1:y", "sigterm@",
])
def test_parse_spec_matches_the_reference(spec):
    try:
        theirs = jax_faults.parse_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            faults.parse_spec(spec)
        assert str(ours.value) == str(e)
        return
    ours = faults.parse_spec(spec)
    assert {f: getattr(ours, f) for f in vars(ours)} == {f: getattr(theirs, f) for f in vars(theirs)}


def test_retry_io_backs_off_then_succeeds_or_raises():
    faults.install("ioerr@2")
    slept = []
    before = default_registry().counter_values().get("io/retries", 0)
    assert faults.retry_io(lambda: 7, "x", attempts=3, backoff_secs=0.5, sleep=slept.append) == 7
    assert slept == [0.5, 1.0]
    assert default_registry().counter_values()["io/retries"] - before == 2
    faults.install("ioerr@5")
    with pytest.raises(OSError, match="injected io error"):
        faults.retry_io(lambda: 7, "x", attempts=1, backoff_secs=0.1, sleep=slept.append)
    faults.configure_io_retry(3, 0.25)


@pytest.mark.parametrize("budget", [0, 1])
def test_max_skipped_batches(budget):
    """badbatch@1: skipped and counted within the budget; with none the
    conversion error itself propagates."""
    faults.install("badbatch@1")
    before = default_registry().counter_values().get("data/batches_skipped", 0)
    it = device_prefetch(data(), torch.device("cpu"), max_skips=budget)
    if budget == 0:
        with pytest.raises(TypeError):
            [next(it) for _ in range(3)]
        return
    got = [next(it)["tokens"] for _ in range(3)]
    src = data()
    want = [next(src) for _ in range(4)]
    assert all(np.array_equal(g.numpy(), want[i]["tokens"]) for g, i in zip(got, (0, 2, 3)))
    assert default_registry().counter_values()["data/batches_skipped"] - before == 1


@pytest.mark.parametrize("fetch_s,step_s,depth_max,start,want", [
    (0.1, 0.01, 6, 2, 6),      # input-bound: grows to the bound
    (0.0001, 0.05, 6, 5, 2),   # queue ahead: decays to the floor
    (0.003, 0.01, 6, 4, 4),    # between the ratios: holds
    (1.0, 0.001, 0, 2, 2),     # fixed depth: inert
], ids=["grow", "shrink", "hold", "fixed"])
def test_depth_controller_matches_the_reference(fetch_s, step_s, depth_max, start, want):
    """The same span histograms move the port's queue depth as they move
    the reference's, fetch by fetch, and the gauge follows."""
    ours_reg, theirs_reg = MetricsRegistry(), jax_registry.MetricsRegistry()
    ours = DepthController(2, depth_max, registry=ours_reg, adapt_every=2)
    theirs = jax_prefetch.DepthController(2, depth_max, registry=theirs_reg, adapt_every=2)
    ours.depth = theirs.depth = start
    for reg in (ours_reg, theirs_reg):
        for _ in range(8):
            reg.histogram("span/data_fetch").record(fetch_s)
            reg.histogram("span/device_step").record(step_s)
    depths = [(ours.observe(), theirs.observe()) for _ in range(12)]
    assert [a for a, _ in depths] == [b for _, b in depths] and depths[-1][0] == want
    assert ours_reg.gauge("data/prefetch_depth").value == \
        theirs_reg.gauge("data/prefetch_depth").value


def test_watchdog_dumps_on_a_stalled_fetch(caplog):
    faults.install("slow@3:1.5")
    cfg = tiny_cfg(watchdog_secs=0.4, telemetry_sinks="")
    with caplog.at_level(logging.ERROR, logger="tensorflow_examples_torch.utils.diagnostics"):
        Trainer(gpt2.make_task(cfg), cfg).fit(data, num_steps=4)
    dumps = [r.getMessage() for r in caplog.records if "WATCHDOG" in r.getMessage()]
    assert dumps and "'input_fetch'" in dumps[0] and "data_work" in dumps[0]


def test_watchdog_fatal_exit_in_a_subprocess(tmp_path):
    script = (
        "import time\n"
        "from tensorflow_examples_torch.utils.diagnostics import Watchdog\n"
        f"flag = {str(tmp_path / 'flushed')!r}\n"
        "wd = Watchdog(30.0, fatal_timeout_s=0.3, flush_fn=lambda: open(flag, 'w').close())\n"
        "wd.start(); wd.enter('device_step'); time.sleep(20)\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, timeout=60,
                          capture_output=True, text=True)
    assert proc.returncode == HUNG_EXIT_CODE, proc.stderr[-2000:]
    assert (tmp_path / "flushed").exists() and "WATCHDOG FATAL" in proc.stderr


def test_profiler_window_links_the_final_line(tmp_path):
    cfg = tiny_cfg(workdir=str(tmp_path), profile_start_step=1, profile_num_steps=2)
    Trainer(gpt2.make_task(cfg), cfg).fit(data)
    lines = read_lines(tmp_path)
    assert_valid(lines)
    prof = lines[-1]["profile"]
    assert lines[-1]["kind"] == "final" and (prof["start_step"], prof["num_steps"]) == (1, 2)
    assert prof["dir"] == os.path.join(str(tmp_path), "profile")
    assert os.path.exists(os.path.join(prof["dir"], f"trace_{os.getpid()}.json"))
    assert "profile" not in lines[-2]


def _scaled_task(cfg):
    task = gpt2.make_task(cfg)

    def loss_fn(params, model_state, batch, *, rng, train):
        batch = dict(batch)
        scale = batch.pop("scale")
        loss, metrics, ms = task.loss_fn(params, model_state, batch, rng=rng, train=train)
        return loss * scale.mean(), metrics, ms

    return Task("scaled", task.init_fn, loss_fn, task.make_optimizer)


def test_debug_nans_names_the_loss_and_the_block():
    cfg = tiny_cfg(debug_nans=True, telemetry_sinks="")
    stream = lambda s: ({**b, "scale": np.ones(4, np.float32)} for b in data(s))
    faults.install("nan@2")
    with pytest.raises(FloatingPointError, match="the loss at step 2"):
        Trainer(_scaled_task(cfg), cfg).fit(stream)
    trainer = Trainer(gpt2.make_task(cfg), cfg)
    trainer.state.params["h_0.mlp_fc.bias"][0] = float("inf")
    with pytest.raises(FloatingPointError, match="output of h_0 at step 0"):
        trainer.train_step(next(data()))
    off = Trainer(gpt2.make_task(tiny_cfg()), tiny_cfg())
    off.state.params["h_0.mlp_fc.bias"][0] = float("inf")
    assert float(off.train_step(next(data()))["bad_step"]) == 1.0  # the guard, no raise


def test_compile_warning_line_for_a_new_batch_signature(tmp_path):
    cfg = tiny_cfg(workdir=str(tmp_path), log_every=2)

    def stream(start):
        for i, b in enumerate(data(start), start):
            yield b if i < 2 else {"tokens": b["tokens"][:3]}

    trainer = Trainer(gpt2.make_task(cfg), cfg)
    trainer.fit(stream, num_steps=4)
    lines = read_lines(tmp_path)
    assert_valid(lines)
    warnings = [x for x in lines if x["kind"] == "compile_warning"]
    assert len(warnings) == 1 and warnings[0]["compile"]["fn"] == "train_step"
    assert "axis 0: 4->3" in warnings[0]["compile"]["delta"] and warnings[0]["step"] == 2
    assert trainer.sentinel.post_warmup_recompiles() == 1


SMOKE = dict(vocab_size=211, max_len=64, num_layers=2, num_heads=2, d_model=32)


@pytest.mark.parametrize("kw", [{}, {"kv_block_size": 8}, {"spec_decode_k": 3},
                                {"weight_dtype": "int8"}],
                         ids=["dense", "paged", "speculative", "int8_weights"])
def test_serving_lines_pass_the_reference_schema(kw):
    model = transformer.GPT2(transformer.TransformerConfig(**SMOKE), seed=1)
    eng = InferenceEngine(transformer.TransformerConfig(**SMOKE), model,
                          cfg=ServeConfig(max_slots=4, prefill_bucket_floor=16,
                                          kv_bucket_floor=32, max_delay_s=0.002, **kw),
                          registry=MetricsRegistry(), device="cpu")
    batcher = ContinuousBatcher(eng).start()
    try:
        futures = [batcher.submit(Request(prompt=[3, 5, 7] * (i + 2), max_new_tokens=4))
                   for i in range(3)]
        [f.result(timeout=120) for f in futures]
        line = batcher.stats_line()
    finally:
        batcher.close(drain=True)
    assert line["schema_version"] == schema.SERVING_SCHEMA_VERSION == jax_schema.SERVING_SCHEMA_VERSION
    assert jax_schema.validate_line(line) == []
