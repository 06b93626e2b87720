"""The port's fleet line (``telemetry/fleet.py``) against the JAX
package's ``FleetMonitor``.

The summary is held to the reference's ``_summarize`` on the same
per-rank matrices (input- and compute-side stragglers, ranks without
step times, a one-rank fleet, ``data_fetch`` standing in for a missing
``data_work``). Both monitors gather through an injected allgather, the
reference's own way of testing it on one process (its two-process test
cannot run collectives here): the injected straggler is named, with the
same summary, and the hub's ``kind="fleet"`` line passes the
reference's validator and answers 200 at ``/fleet``. A real world of 2
gloo ranks then fits with a slow input fetch on rank 1: only rank 0
writes ``metrics.jsonl``, and its fleet lines carry both ranks' rows.
"""

from __future__ import annotations

import json
import logging
import os
import urllib.request

import numpy as np
import pytest

from tensorflow_examples_torch.core import distributed
from tensorflow_examples_torch.telemetry import fleet, registry as registry_mod, serve
from tensorflow_examples_torch.telemetry.hub import Telemetry
from tensorflow_examples_torch.telemetry.memory import tree_bytes

NAN = float("nan")


def row(p50, p95, fetch, work, lost=0, peak=2 ** 20, retries=0, skipped=0):
    return [p50, p95, fetch, lost, peak, retries, skipped, work]


MATRICES = {
    "input-side straggler": [row(0.1, 0.12, 0.01, 0.01), row(0.3, 0.9, 0.8, 0.75)],
    "compute-side straggler": [row(0.1, 0.1, 0.01, 0.01), row(0.1, 0.11, 0.01, 0.01),
                               row(0.4, 0.5, 0.01, 0.02)],
    "below the threshold": [row(0.1, 0.1, 0.01, 0.01), row(0.1, 0.15, 0.01, 0.01)],
    "no step times yet": [row(NAN, NAN, NAN, NAN), row(NAN, NAN, NAN, NAN)],
    "one rank": [row(0.1, 0.2, 0.05, 0.01)],
    "fetch stands in for work": [row(0.1, 0.1, 0.01, NAN), row(0.1, 0.1, 0.02, NAN),
                                 row(0.2, 0.6, 0.5, NAN), row(0.1, 0.12, 0.02, NAN)],
    "no input evidence": [row(0.1, 0.1, NAN, NAN), row(0.1, 0.5, NAN, NAN)],
}


def jax_monitor(**kw):
    from tensorflow_examples_tpu.telemetry import fleet as jax_fleet
    from tensorflow_examples_tpu.telemetry import registry as jax_registry

    return jax_fleet.FleetMonitor(registry=jax_registry.MetricsRegistry(), **kw)


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("skew_factor", [2.0, 0.0])
def test_summary_equals_the_reference(name, skew_factor):
    m = np.asarray(MATRICES[name], np.float64)
    ours = fleet.FleetMonitor(skew_factor=skew_factor)._summarize(m)
    theirs = jax_monitor(skew_factor=skew_factor)._summarize(m)
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)


def _gather_of(name):
    rows = np.asarray(MATRICES[name], np.float32)
    return lambda vec: rows


def test_injected_straggler_is_named_as_the_reference_names_it(caplog):
    kw = dict(skew_factor=2.0, allgather=_gather_of("input-side straggler"), process_index=0,
              process_count=2)
    ours = fleet.FleetMonitor(registry=registry_mod.MetricsRegistry(), **kw)
    with caplog.at_level(logging.WARNING):
        got = ours.gather({})
    want = jax_monitor(**kw).gather({})
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["straggler"] and got["slowest_host"] == 1 and got["side"] == "input"
    assert "FLEET STRAGGLER: host 1" in caplog.text and "input-side" in caplog.text
    snap = ours.snapshot({})
    assert snap["emergency"] is True and snap["slowest_host"] == 1


@pytest.mark.timeout(60)
def test_fleet_line_validates_and_answers_at_fleet():
    from tensorflow_examples_tpu.telemetry import schema as jax_schema

    monitor = fleet.FleetMonitor(skew_factor=2.0, allgather=_gather_of("input-side straggler"),
                                 process_index=0, process_count=2)
    tel = Telemetry([], fleet=monitor)
    server = serve.MetricsServer(registry_mod.default_registry(), port=0, telemetry=tel).start()
    try:
        url = server.url("/fleet")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(url, timeout=10)  # 404 before the first window
        line = tel.log_window(4, {"loss": 1.0})
        assert line["kind"] == "window" and jax_schema.validate_line(line) == []
        fleet_line = tel.last_fleet_line
        assert fleet_line["kind"] == "fleet" and fleet_line["step"] == 4
        assert jax_schema.validate_line(fleet_line) == []
        with urllib.request.urlopen(url, timeout=10) as r:
            assert r.status == 200
            body = json.loads(r.read())
        assert body["fleet"]["slowest_host"] == 1 and body["fleet"]["straggler"] is True
        assert tel.last_line["kind"] == "window"  # /window keeps the scalar line
    finally:
        server.close()
        tel.close()


def test_tree_bytes_counts_whole_tensors_or_this_ranks_pieces():
    import torch

    from tensorflow_examples_tpu.telemetry.memory import tree_bytes as jax_tree_bytes

    tree = {"a": torch.zeros(4, 8), "b": [torch.zeros(3, dtype=torch.bfloat16), 7],
            "c": np.zeros((2, 2), np.float64)}
    whole = jax_tree_bytes({"a": np.zeros((4, 8), np.float32), "b": [np.zeros(3, np.float16)],
                            "c": np.zeros((2, 2))})
    assert tree_bytes(tree) == tree_bytes(tree, per_device=True) == whole
    pieces = {"a": 4, "b": [1, 1], "c": 2}
    assert tree_bytes(tree, pieces=pieces) == 4 * 128 + 6 + 2 * 32
    assert tree_bytes(tree, per_device=True, pieces=pieces) == whole


def _fit_worker(rank: int, workdir: str) -> dict:
    from tensorflow_examples_torch.data.memory import train_iterator
    from tensorflow_examples_torch.data.sources import synthetic_images
    from tensorflow_examples_torch.sharding import ShardingConfig
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.utils import faults
    from tensorflow_examples_torch.workloads import mnist

    cfg = mnist.MnistConfig(device="cpu", global_batch_size=16, train_steps=8, hidden=32,
                            num_layers=1, precision="f32", log_every=4, checkpoint_every=0,
                            resume=False, watchdog_secs=0, bad_step_policy="off",
                            workdir=workdir, telemetry_sinks="jsonl", telemetry_trace=False,
                            straggler_skew_factor=2.0, eval_every=0)
    if rank == 1:
        faults.install("slow@5:0.6,slow@6:0.6")  # rank 1's input fetches stall
    sc = ShardingConfig(mesh={"data": 2})
    mesh = sc.build_mesh()
    trainer = Trainer(mnist.make_task(cfg), cfg, mesh=mesh, sharding=sc)
    ds = synthetic_images(n=128, shape=(28, 28, 1), num_classes=10, seed=0)
    m = trainer.fit(lambda start: train_iterator(ds, 16, seed=0, start_step=start))
    return {"loss": m["loss"], "fleet": trainer.telemetry.last_fleet_line}


def test_two_rank_fit_writes_fleet_lines_with_every_rank(tmp_path):
    from tensorflow_examples_tpu.telemetry import schema as jax_schema

    workdir = str(tmp_path / "run")
    ranks = distributed.run_world(_fit_worker, 2, workdir, timeout_s=180,
                                  store_dir=str(tmp_path))
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert ranks[0]["fleet"]["fleet"] == ranks[1]["fleet"]["fleet"]  # every rank derives it
    assert os.listdir(os.path.join(workdir, "telemetry")) == ["metrics.jsonl"]
    lines = [json.loads(x) for x in open(os.path.join(workdir, "telemetry", "metrics.jsonl"))]
    for line in lines:
        assert jax_schema.validate_line(line) == [], line
    assert {x["host"] for x in lines} == {0}
    fleets = [x["fleet"] for x in lines if x["kind"] == "fleet"]
    assert len(fleets) == 2 and [h["host"] for h in fleets[-1]["hosts"]] == [0, 1]
    slow, fast = fleets[-1]["hosts"][1], fleets[-1]["hosts"][0]
    assert slow["data_fetch_p95"] >= 0.6 > fast["data_fetch_p95"]
    final = lines[-1]
    assert final["kind"] == "final" and final["sharding"]["mesh_shape"]["data"] == 2
