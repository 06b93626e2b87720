"""The trainer's memory monitor, OOM report and metrics server in the port
against the JAX package (PyTorch/CUDA port).

* A fit's ``kind="memory"`` line and its window, eval and final lines
  pass the reference's ``telemetry/schema.validate_line``; the memory
  line's params, optimizer and model-state bytes are ``tree_bytes`` of
  the state, and the windows carry a nonzero watermark on the CPU.
* ``is_oom`` agrees with the reference's on the reference's cases and
  on CUDA's out-of-memory text, and also takes ``torch.OutOfMemoryError``.
* ``oom_report`` has the reference's sections and names the largest
  tensor; a fit that dies of an OOM logs it once, before the error
  re-raises, and lands a final line naming the error.
* ``MetricsServer`` answers ``/metrics``, ``/health``, ``/window``,
  ``/fleet`` and any other path as the reference's does (statuses, the
  Prometheus samples, the bodies), turns ``/health`` to 503 on a
  watchdog stall, and serves a fit started with ``metrics_port`` until
  the fit ends.
"""

import json
import logging
import os
import re
import socket
import types
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.telemetry import memory as jax_memory
from tensorflow_examples_tpu.telemetry import registry as jax_registry
from tensorflow_examples_tpu.telemetry import schema as jax_schema
from tensorflow_examples_tpu.telemetry import serve as jax_serve
from tensorflow_examples_tpu.telemetry.hub import Telemetry as JaxTelemetry
from tensorflow_examples_torch.data.memory import InMemoryDataset, eval_batches, train_iterator
from tensorflow_examples_torch.telemetry import memory, serve
from tensorflow_examples_torch.telemetry import registry as registry_mod
from tensorflow_examples_torch.telemetry.hub import Telemetry
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.workloads import cifar10, mnist

PROM_SAMPLE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? "
                         r"(-?\d+(\.\d+)?([eE][+-]?\d+)?|NaN|[+-]Inf)$")


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _prometheus_names(text: str) -> list[str]:
    names = []
    for line in text.strip().splitlines():
        if line.startswith("#"):
            assert line.startswith(("# TYPE ", "# HELP ")), line
            continue
        assert PROM_SAMPLE.match(line), f"invalid prometheus line: {line}"
        names.append(line.split("{")[0].split(" ")[0])
    return names


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tiny_cifar(tmp_path, **kw):
    base = dict(device="cpu", global_batch_size=8, train_steps=4, warmup_steps=1, log_every=2,
                eval_every=2, checkpoint_every=0, precision="f32", workdir=str(tmp_path),
                telemetry_sinks="jsonl", eval_batch_size=16)
    base.update(kw)
    return cifar10.Cifar10Config(**base)


def test_fit_lines_pass_the_reference_schema(tmp_path):
    cfg = tiny_cifar(tmp_path)
    trainer = Trainer(cifar10.make_task(cfg), cfg)
    train_ds, eval_ds = cifar10.datasets(cfg)
    eval_ds = InMemoryDataset({k: v[:32] for k, v in eval_ds.arrays.items()})
    trainer.fit(lambda s: train_iterator(train_ds, 8, seed=0, start_step=s),
                eval_iter_fn=lambda: eval_batches(eval_ds, 16))
    lines = [json.loads(x) for x in open(os.path.join(tmp_path, "telemetry", "metrics.jsonl"))]
    assert [x["kind"] for x in lines][:2] == ["memory", "window"] and lines[-1]["kind"] == "final"
    for line in lines:
        assert jax_schema.validate_line(line) == [], line["kind"]
    mem = lines[0]["memory"]
    sizes = trainer.state.byte_breakdown()
    assert (mem["params_bytes"], mem["opt_bytes"], mem["model_state_bytes"]) == (
        memory.tree_bytes(trainer.state.params), memory.tree_bytes(trainer.state.opt_state),
        memory.tree_bytes(trainer.state.model_state))
    assert mem["params_bytes"] == sizes["params"] == 4 * trainer.n_params
    assert mem["live_bytes"] == sum(sizes.values()) and mem["other_bytes"] == 0
    for line in lines:
        if line["kind"] in ("window", "final"):
            m = line["memory"]
            assert m["peak_live_bytes"] >= m["live_bytes"] > mem["live_bytes"]  # + the batch


@pytest.mark.parametrize("package", ["port", "reference"])
def test_tree_bytes_counts_every_leaf(package):
    if package == "port":
        tree = {"a": torch.ones(4, 4), "b": [torch.ones(2, dtype=torch.int32), None],
                "c": np.zeros(3, np.float64)}
        assert memory.tree_bytes(tree) == 64 + 8 + 24
    else:
        tree = {"a": jnp.ones((4, 4)), "b": [jnp.ones(2, jnp.int32), None],
                "c": np.zeros(3, np.float64)}
        assert jax_memory.tree_bytes(tree) == 64 + 8 + 24


OOM_CASES = [
    (RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 1073741824 bytes"), True),
    (ValueError("allocation failure"), True),
    (RuntimeError("OOM when allocating"), True),
    (ValueError("shape mismatch"), False),
    (RuntimeError("in the classroom"), False),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.1 GiB total)"), True),
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 512.00 MiB"), True),
    (MemoryError("memory_limit exceeded"), True),
]


@pytest.mark.parametrize("exc,want", OOM_CASES)
def test_is_oom_agrees_with_the_reference(exc, want):
    assert memory.is_oom(exc) is want
    assert jax_memory.is_oom(exc) is want
    assert memory.is_oom(torch.OutOfMemoryError())  # the type alone


def _sections(report: str) -> list[str]:
    return [re.sub(r"\d+", "N", line.split(":")[0]) for line in report.splitlines()
            if not line.startswith("  ")]


def test_oom_report_has_the_reference_sections():
    big = torch.ones(256, 256)
    state = types.SimpleNamespace(params={"w": torch.ones(10)}, opt_state={"m": torch.ones(10)},
                                  model_state={})
    mon = memory.MemoryMonitor(registry=registry_mod.MetricsRegistry(),
                               tracked=lambda: vars(state))
    mon.init_breakdown(state)
    assert mon.sample() == 80
    # Every live CPU tensor: an xdist worker's earlier test files can leave
    # larger ones alive, which a fixed top-n would list in its place.
    report = mon.oom_report(top=len(memory._live_tensors(None)))
    ref = jax_memory.MemoryMonitor(registry=jax_registry.MetricsRegistry())
    ref.init_breakdown(types.SimpleNamespace(params={"w": jnp.ones(10)},
                                             opt_state={"m": jnp.ones(10)}, model_state={}))
    assert _sections(report) == _sections(ref.oom_report(top=3)) == [
        "== OOM allocation forensics ==", "live arrays", "fit-start breakdown",
        "top N live arrays by size"]
    assert "(256, 256)" in report and "MiB" in report
    del big


def test_oom_in_fit_logs_the_report_before_it_reraises(tmp_path, caplog):
    cfg = tiny_cifar(tmp_path, eval_every=0, log_every=1)
    task = cifar10.make_task(cfg)
    calls = {"n": 0}
    inner = task.loss_fn

    def loss_fn(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 20.00 GiB")
        return inner(*a, **kw)

    task.loss_fn = loss_fn
    trainer = Trainer(task, cfg)
    ds = cifar10.datasets(cfg)[0]
    with caplog.at_level(logging.ERROR, logger="tensorflow_examples_torch"):
        with pytest.raises(torch.OutOfMemoryError):
            trainer.fit(lambda s: train_iterator(ds, 8, seed=0, start_step=s))
    dumps = [r.getMessage() for r in caplog.records
             if "OOM allocation forensics" in r.getMessage()]
    assert len(dumps) == 1 and "fit-start breakdown" in dumps[0]
    lines = [json.loads(x) for x in open(os.path.join(tmp_path, "telemetry", "metrics.jsonl"))]
    assert lines[-1]["exit_reason"] == "error:OutOfMemoryError"
    assert not memory.maybe_log_oom_report(ValueError("unrelated"), trainer.telemetry.memory)
    assert not memory.maybe_log_oom_report(None, trainer.telemetry.memory)


def _servers(tmp_path):
    ours_tel = Telemetry([])
    theirs_reg = jax_registry.MetricsRegistry()
    theirs_tel = JaxTelemetry([], registry=theirs_reg, host=0)
    for reg in (registry_mod.default_registry(), theirs_reg):
        reg.counter("train/steps_total").inc(7)
        reg.gauge("memory/peak_live_bytes").set(2048)
        reg.histogram("step_time").record(0.01)
    ours = serve.MetricsServer(registry_mod.default_registry(), port=0, telemetry=ours_tel)
    theirs = jax_serve.MetricsServer(theirs_reg, port=0, telemetry=theirs_tel)
    return (ours.start(), ours_tel), (theirs.start(), theirs_tel)


@pytest.mark.timeout(60)
def test_metrics_server_answers_as_the_reference(tmp_path):
    (ours, ours_tel), (theirs, theirs_tel) = _servers(tmp_path)
    try:
        for srv, tel in ((ours, ours_tel), (theirs, theirs_tel)):
            assert _get(srv.url("/window"))[0] == 404
            tel.log_window(0, {}, kind="memory",
                           extra={"memory": {"live_bytes": 1, "params_bytes": 1}},
                           **({} if tel is ours_tel else {"reduce": False}))
            assert _get(srv.url("/window"))[0] == 404  # a memory line is not a window
            tel.log_window(7, {"loss": 1.25})
        got = {}
        for name, srv in (("ours", ours), ("theirs", theirs)):
            got[name] = {p: _get(srv.url(p)) for p in ("/metrics", "/health", "/window",
                                                     "/fleet", "/nope", "/metrics/")}
        for path in got["ours"]:
            assert got["ours"][path][0] == got["theirs"][path][0], path
        names = _prometheus_names(got["ours"]["/metrics"][1])
        assert {"train_steps_total", "memory_peak_live_bytes",
                "step_time_seconds_count"} <= set(names)
        assert 'host="0"' in got["ours"]["/metrics"][1]
        health = json.loads(got["ours"]["/health"][1])
        assert health["ok"] is True and health["last_step"] == 7
        assert health.keys() == json.loads(got["theirs"]["/health"][1]).keys()
        window = json.loads(got["ours"]["/window"][1])
        assert window["step"] == 7 and window["metrics"]["train/loss"] == 1.25
        assert jax_schema.validate_line(window) == []
        assert got["ours"]["/fleet"][0] == 404
        assert got["ours"]["/nope"] == got["theirs"]["/nope"] == (
            404, "endpoints: /metrics /health /window /fleet\n")
    finally:
        ours.close()
        theirs.close()
        ours.close()  # idempotent
    with pytest.raises(OSError):
        urllib.request.urlopen(ours.url("/health"), timeout=2)


@pytest.mark.timeout(60)
def test_health_is_503_on_a_watchdog_stall():
    status = {"phase": "device_step", "phase_age_secs": 9.0, "stalled_secs": 9.0,
              "paused": False, "timeout_secs": 5.0}
    dog = types.SimpleNamespace(status=lambda: dict(status))
    srv = serve.MetricsServer(registry_mod.MetricsRegistry(), port=0, watchdog=dog).start()
    ref = jax_serve.MetricsServer(jax_registry.MetricsRegistry(), port=0, watchdog=dog).start()
    try:
        for s in (srv, ref):
            code, body = _get(s.url("/health"))
            assert code == 503 and json.loads(body)["phase"] == "device_step"
        status["paused"] = True
        assert _get(srv.url("/health"))[0] == _get(ref.url("/health"))[0] == 200
    finally:
        srv.close()
        ref.close()


@pytest.mark.timeout(120)
def test_fit_serves_metrics_while_it_runs(tmp_path):
    port = _free_port()
    cfg = mnist.MnistConfig(device="cpu", global_batch_size=16, train_steps=4, log_every=1,
                            eval_every=0, checkpoint_every=0, precision="f32",
                            telemetry_sinks="", metrics_port=port, hidden=16, num_layers=1)
    trainer = Trainer(mnist.make_task(cfg), cfg)
    ds = mnist.datasets(cfg)[0]
    scraped = {}

    def data(start):
        for i, batch in enumerate(train_iterator(ds, 16, seed=0, start_step=start)):
            if i == 3:  # two windows in
                scraped["metrics"] = _get(f"http://127.0.0.1:{port}/metrics")
                scraped["health"] = _get(f"http://127.0.0.1:{port}/health")
            yield batch

    trainer.fit(data)
    assert scraped["metrics"][0] == 200 and scraped["health"][0] == 200
    names = _prometheus_names(scraped["metrics"][1])
    assert "memory_peak_live_bytes" in names and "memory_params_bytes" in names
    assert json.loads(scraped["health"][1])["last_step"] >= 1
    with pytest.raises(OSError):  # closed with the fit
        urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=2)
