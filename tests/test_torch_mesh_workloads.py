"""BERT, the ResNets and the MLP on the port's meshes against the JAX package's Trainer.

Spawned gloo worlds (``core/distributed.run_world``: a ``file://`` store
under ``tmp_path``, one torch thread a rank, a timeout on every world;
jax is imported only inside functions, so a rank does not load it)
train every workload's task made for the mesh, from the port's seeded
initial parameters, off the same seeded global batches as the reference's
run on the same layout, while the main process runs the reference (8
fake CPU devices) from the same parameters:

* ResNet-20 (CIFAR-10, batch 8) and the ImageNet ResNet of
  ``tests/test_train_imagenet.py``'s ``tiny_config`` (ResNet-50, 32 px, 4
  classes, batch 16) on ``{data: 2}`` and ``{fsdp: 2}``, 5 f32 steps:
  losses, parameters and ``batch_stats`` at rtol 3e-3, atol 1e-5, the
  ranks' ``batch_stats`` bitwise equal. The reference's BatchNorm is
  sync-BN by construction; the port sums each layer's moments across
  ranks (``models/resnet.py``). The ImageNet ResNet's parameters are
  compared after its fourth update (:func:`steps_of`), the one the fifth
  step's loss and statistics come from: its fifth update is
  ill-conditioned in f32 (from these parameters and batches, the port's
  runs and the reference's leave the float64 trajectory of the same
  math there by 3.5e-5 and 5.3e-5 on some elements, past 1e-5; after
  four updates all stay within 1.5e-7 of it);
* the gradient guard: one step's gradients on ``{data: 2}`` against the
  port's one-rank step at the same global batch (rtol 1e-5), on
  parameters moved off their init so that every BatchNorm's moments carry
  a cotangent; it fails unless the moments' all-reduce is summed in the
  backward too;
* ``grad_accum_steps=2`` on ``{data: 2}`` against the reference;
* the trainer refusing a ResNet whose ``batch_axes`` split the batch
  over ``model``;
* a ``{data: 2}`` ResNet-20 checkpoint restored on one rank and on
  ``{fsdp: 2}`` bit for bit, and the ``{data: 2}`` eval equal to the
  one-device eval;
* BERT (GLUE sst2; 2 layers, 4 heads, d 16, vocab 120 for the synthetic
  task's markers) on ``{model: 2}``, ``{fsdp: 2}`` and ``{data: 2, model:
  2}``, 3 f32 steps with the port's ``"xla"`` and ``"flash"`` attention
  (the flash kernels' plain version here) against the reference's
  ``"xla"`` at rtol 3e-3; on ``{model: 2}`` each rank's ``attn_qkv.kernel``
  is ``[d, 3, H/2, hd]`` and the sharding digest is the reference's;
* the MNIST MLP on ``{data: 2}`` against the reference, its rules
  ``REPLICATED``;
* ``train.cli`` under torchrun training a ResNet on ``{data: 2}``, and
  ``train.eval`` on that mesh equal to ``train.eval`` in one process.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

from tensorflow_examples_torch.core import distributed

STEPS = 5
BERT_STEPS = 3
WORLD_TIMEOUT_S = 280
RTOL, ATOL = 3e-3, 1e-5

# (name, workload, mesh, config overrides); the reference runs each
# layout with its own attention ("xla") and the port's config.
RESNET_RUNS = (
    ("cifar data", "cifar10", {"data": 2}, {}),
    ("cifar fsdp", "cifar10", {"fsdp": 2}, {}),
    ("cifar data accum", "cifar10", {"data": 2}, {"grad_accum_steps": 2}),
    ("imagenet data", "imagenet", {"data": 2}, {}),
    ("imagenet fsdp", "imagenet", {"fsdp": 2}, {}),
)
BERT_LAYOUTS = (("model", {"model": 2}), ("fsdp", {"fsdp": 2}),
                ("data+model", {"data": 2, "model": 2}))
BERT_RUNS = tuple((f"bert {name} {impl}", "bert_glue", mesh, {"attention": impl})
                  for name, mesh in BERT_LAYOUTS for impl in ("xla", "flash"))
MNIST_RUN = ("mnist data", "mnist", {"data": 2}, {})
RUNS_2 = RESNET_RUNS + tuple(r for r in BERT_RUNS if len(r[2]) == 1) + (MNIST_RUN,)
RUNS_4 = tuple(r for r in BERT_RUNS if len(r[2]) == 2)


def config_kw(workload: str, **kw) -> dict:
    """The tiny f32 config of a workload (no files, no logging)."""
    base = dict(train_steps=40, warmup_steps=2, log_every=1, eval_every=0, precision="f32")
    if workload == "cifar10":
        base.update(global_batch_size=8, augment=False)
    elif workload == "imagenet":  # tests/test_train_imagenet.py tiny_config
        base.update(image_size=32, num_classes=4, global_batch_size=16, warmup_steps=5,
                    learning_rate=0.01, eval_batches=2)
    elif workload == "mnist":
        base.update(global_batch_size=16, dropout=0.0)
    else:
        base.update(task="sst2", seq_len=32, vocab_size=120, num_layers=2, num_heads=4,
                    d_model=16, d_ff=32, dropout=0.0, global_batch_size=16, warmup_steps=4,
                    learning_rate=3e-4)
    base.update(kw)
    return base


def port_module(workload: str):
    from tensorflow_examples_torch.workloads import bert_glue, cifar10, imagenet, mnist

    return {"cifar10": cifar10, "imagenet": imagenet, "mnist": mnist,
            "bert_glue": bert_glue}[workload]


def jax_module(workload: str):
    from tensorflow_examples_tpu.workloads import bert_glue, cifar10, imagenet, mnist

    return {"cifar10": cifar10, "imagenet": imagenet, "mnist": mnist,
            "bert_glue": bert_glue}[workload]


def port_cfg(workload: str, **kw):
    cls = {"cifar10": "Cifar10Config", "imagenet": "ImagenetConfig", "mnist": "MnistConfig",
           "bert_glue": "BertGlueConfig"}[workload]
    return getattr(port_module(workload), cls)(device="cpu", telemetry_sinks="",
                                               watchdog_secs=0, checkpoint_every=0,
                                               **config_kw(workload, **kw))


def jax_cfg(workload: str, **kw):
    cls = {"cifar10": "Cifar10Config", "imagenet": "ImagenetConfig", "mnist": "MnistConfig",
           "bert_glue": "BertGlueConfig"}[workload]
    kw = {k: v for k, v in kw.items() if k != "attention"}  # the reference's "xla"
    return getattr(jax_module(workload), cls)(checkpoint_every=0, **config_kw(workload, **kw))


def make_batches(workload: str, n: int) -> list:
    """The global batches every run reads: ImageNet's and GLUE's from the
    reference's synthetic streams, CIFAR-10's and MNIST's made from a
    seed with numpy (labelled prototypes plus noise, as the synthetic
    sets, without building a whole set)."""
    from tensorflow_examples_tpu.data import memory as jax_memory

    mod, cfg = jax_module(workload), jax_cfg(workload)
    if workload == "imagenet":
        it = mod.make_train_iter(cfg, 0)
    elif workload == "bert_glue":
        it = jax_memory.train_iterator(mod.datasets(cfg)[0], cfg.global_batch_size, seed=0)
    else:
        rng = np.random.default_rng(0)
        shape = (32, 32, 3) if workload == "cifar10" else (28, 28, 1)
        protos = rng.normal(0, 1, (10, *shape)).astype(np.float32)

        def batch():
            y = rng.integers(0, 10, cfg.global_batch_size).astype(np.int32)
            noise = rng.normal(0, 2.0, (cfg.global_batch_size, *shape)).astype(np.float32)
            return {"image": protos[y] + noise, "label": y}

        it = iter(batch, None)
    return [{k: np.asarray(v) for k, v in next(it).items()} for _ in range(n)]


def eval_stream(n: int = 8) -> list:
    """Two CIFAR eval batches, the second with 3 padding rows (mask 0)."""
    rng = np.random.RandomState(5)
    mask = np.ones(n, np.float32)
    mask[-3:] = 0.0
    return [{"image": rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
             "label": rng.randint(0, 10, n).astype(np.int32), "mask": m}
            for m in (np.ones_like(mask), mask)]


def moved(params: dict, seed: int = 1) -> dict:
    """``params`` (a flat ``/``-keyed dict) moved off their init: zero
    BatchNorm scales would leave a block's moments without a cotangent."""
    rng = np.random.default_rng(seed)
    return {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in params.items()}


# ------------------------------------------------------------ the port


def make_trainer(workload: str, mesh_kw: dict, init, *, batch_axes=None, **kw):
    from tensorflow_examples_torch.sharding import ShardingConfig
    from tensorflow_examples_torch.train.loop import Trainer

    cfg = port_cfg(workload, **kw)
    sc = ShardingConfig(mesh=mesh_kw, **({"batch_axes": batch_axes} if batch_axes else {}))
    mesh = sc.build_mesh()
    return Trainer(port_module(workload).make_task(cfg, mesh=mesh), cfg, init_params=init,
                   mesh=mesh, sharding=sc)


def whole_state(trainer) -> dict:
    """Whole params and ``batch_stats`` of a trainer, as numpy."""
    params = trainer.state.params
    if trainer.layout is not None:
        params = trainer.layout.gather_state({"params": params})["params"]
    stats = trainer.state.model_state.get("batch_stats", {})
    return {"params": {k: v.numpy() for k, v in params.items()},
            "batch_stats": {k: v.numpy() for k, v in stats.items()}}


def step_grads(trainer, batch) -> dict:
    """One step's gradients as the optimizer sees them (the trainer's own
    pieces: the loss on this rank's rows, then the mean over the batch
    axes)."""
    from tensorflow_examples_torch.core import rng

    leaves = {k: p.detach().requires_grad_(True) for k, p in trainer.state.params.items()}
    loss, _, _ = trainer.task.loss_fn(trainer._compute_params(leaves), trainer.state.model_state,
                                      trainer.put_batch(batch),
                                      rng=trainer.stage_noise(rng.StepNoise(), 0), train=True)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    if trainer.layout is not None:
        grads = trainer.layout.reduce_grads(grads)
    return {k: g.numpy() for k, g in grads.items()}


def _world_worker(rank: int, runs, inits, batches, ckpt_dir) -> dict:
    from tensorflow_examples_torch.train.checkpoint import CheckpointManager

    out = {}
    for name, workload, mesh_kw, kw in runs:
        trainer = make_trainer(workload, mesh_kw, inits[workload], **kw)
        n, params_at = steps_of(workload)
        losses = []
        for i, b in enumerate(batches[workload][:n]):
            losses.append(float(trainer.train_step(b)["loss"]))
            if i + 1 == params_at:  # a collective: every rank gathers
                params = whole_state(trainer)["params"]
        res = {"losses": losses, **whole_state(trainer)}
        res["params"] = params if rank == 0 else None  # rank 0's; every rank's statistics
        if workload == "bert_glue":
            res["qkv_local"] = tuple(trainer.state.params["bert.layer_0.attn_qkv.kernel"].shape)
            res["digest"] = trainer.sharding_digest()
        if name == "cifar data" and ckpt_dir:
            res["eval"] = trainer.evaluate(iter(eval_stream()))
            if rank == 0:  # replicated: no collective
                res["final_params"] = whole_state(trainer)["params"]
            CheckpointManager(ckpt_dir, layout=trainer.layout, primary=rank == 0).save(
                STEPS, trainer.state)
            torch.distributed.barrier()
        out[name] = res
    if ckpt_dir:
        trainer = make_trainer("cifar10", {"fsdp": 2}, inits["cifar10"])
        with CheckpointManager(ckpt_dir, layout=trainer.layout, primary=rank == 0) as ckpt:
            trainer.state, step = ckpt.restore_latest(trainer.state)
        out["restored fsdp"] = {"step": step, **whole_state(trainer)}
        trainer = make_trainer("cifar10", {"data": 2}, inits["moved cifar10"])
        out["grads"] = step_grads(trainer, batches["cifar10"][0])
        try:
            make_trainer("cifar10", {"model": 2}, inits["cifar10"], batch_axes=("data", "model"))
        except NotImplementedError as e:
            out["refused"] = str(e)
    return out


# ------------------------------------------------------- the reference


def jax_trainer(workload: str, mesh_kw: dict, init: dict, **kw):
    """The reference's trainer on ``mesh_kw``, its parameters replaced by
    ``init`` (flat, ``/``-keyed) in their own sharding."""
    import jax

    from tensorflow_examples_tpu.sharding import ShardingConfig
    from tensorflow_examples_tpu.train.loop import Trainer

    cfg = jax_cfg(workload, **kw)
    sc = ShardingConfig(mesh=mesh_kw)
    mesh = sc.build_mesh()
    trainer = Trainer(jax_module(workload).make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc)
    names = []

    def given(path, leaf):
        names.append("/".join(str(getattr(p, "key", p)) for p in path))
        return jax.device_put(np.asarray(init[names[-1]], leaf.dtype), leaf.sharding)

    params = jax.tree_util.tree_map_with_path(given, trainer.state.params)
    assert sorted(names) == sorted(init), "the reference's parameters are not the port's"
    trainer.state = trainer.state.replace(params=params)
    return trainer


def flat_numpy(tree) -> dict:
    from tensorflow_examples_torch.models.convert import flatten_tree

    return {k.replace("/", "."): np.asarray(v) for k, v in flatten_tree(tree).items()}


def jax_run(trainer, batches, n: int, params_at: int) -> dict:
    """``n`` steps of the reference's trainer; its parameters after
    ``params_at`` updates."""
    import jax

    state, losses = trainer.state, []
    for i, b in enumerate(batches[:n]):
        state, metrics = trainer._train_step(state, trainer._put_batch(b))
        losses.append(float(metrics["loss"]))
        if i + 1 == params_at:
            params = flat_numpy(jax.device_get(state.params))
    stats = state.model_state.get("batch_stats", {}) if state.model_state else {}
    return {"losses": losses, "params": params, "batch_stats": flat_numpy(jax.device_get(stats)),
            "digest": trainer.sharding_digest()}


def steps_of(workload: str) -> tuple[int, int]:
    """(steps, the updates after which the parameters are compared): the
    ImageNet ResNet's after its fourth (see the module docstring)."""
    if workload == "bert_glue":
        return BERT_STEPS, BERT_STEPS
    return STEPS, STEPS - 1 if workload == "imagenet" else STEPS


def run_key(workload: str, mesh_kw: dict, kw: dict) -> tuple:
    """The reference's run of a port run: its attention is always "xla"."""
    return workload, tuple(mesh_kw.items()), kw.get("grad_accum_steps", 1)


def reference_runs(runs, batches, inits) -> dict:
    """The reference's result for each distinct layout of ``runs`` (this
    process, or a spawned one)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = {}
    for _, workload, mesh_kw, kw in runs:
        key = run_key(workload, mesh_kw, kw)
        if key not in out:
            out[key] = jax_run(jax_trainer(workload, mesh_kw, inits[workload], **kw),
                               batches[workload], *steps_of(workload))
    return out


def port_init(workload: str) -> dict:
    """The port task's seeded initial parameters, flat and ``/``-keyed:
    the port's runs and the reference's start from them."""
    cfg = port_cfg(workload)
    params = port_module(workload).make_task(cfg).init_fn(cfg.seed, torch.device("cpu"))["params"]
    return {k.replace(".", "/"): v.numpy() for k, v in params.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's worlds (threads waiting on spawned ranks) beside the
    reference's runs on the same layouts: the ImageNet ResNet's in a
    spawned process, the others in this one."""
    import concurrent.futures
    import multiprocessing

    all_runs = RESNET_RUNS + BERT_RUNS + (MNIST_RUN,)
    batches = {w: make_batches(w, STEPS) for w in ("cifar10", "imagenet", "mnist", "bert_glue")}
    imagenet = tuple(r for r in all_runs if r[1] == "imagenet")
    pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    inits = {w: port_init(w) for w in ("cifar10", "imagenet", "mnist", "bert_glue")}
    spawned = pool.submit(reference_runs, imagenet, batches, inits)
    inits["moved cifar10"] = moved(inits["cifar10"])
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    port: dict = {}

    def world(n: int, world_runs, ckpt_dir):
        used = {w for _, w, *_ in world_runs} | ({"moved cifar10"} if ckpt_dir else set())
        try:  # each rank unpickles only its runs' inputs
            port[n] = distributed.run_world(
                _world_worker, n, world_runs, {w: inits[w] for w in used},
                {w: batches[w] for w in used if w in batches}, ckpt_dir,
                timeout_s=WORLD_TIMEOUT_S, store_dir=str(tmp_path_factory.mktemp(f"w{n}")))
        except Exception as e:  # raised again in the fixture's thread
            port[f"error {n}"] = e

    threads = [threading.Thread(target=world, args=a, daemon=True)
               for a in ((2, RUNS_2, ckpt), (4, RUNS_4, None))]
    for t in threads:
        t.start()
    try:
        ref = reference_runs(tuple(r for r in all_runs if r[1] != "imagenet"), batches, inits)
        ref.update(spawned.result(timeout=2 * WORLD_TIMEOUT_S))
    finally:
        pool.shutdown(cancel_futures=True)
        for t in threads:
            t.join(timeout=2 * WORLD_TIMEOUT_S)
    for n in (2, 4):
        if f"error {n}" in port:
            raise port[f"error {n}"]
    ranks = {**{n: port[2] for n, *_ in RUNS_2}, **{n: port[4] for n, *_ in RUNS_4}}
    refs = {n: ref[run_key(w, m, kw)] for n, w, m, kw in all_runs}
    return {"ranks": ranks, "refs": refs, "world2": port[2], "inits": inits,
            "batches": batches, "ckpt": ckpt}


def assert_state_close(got: dict, want: dict, what: str) -> None:
    """Parameters and ``batch_stats`` at rtol 3e-3, atol 1e-5."""
    for part in ("params", "batch_stats"):
        assert got[part].keys() == want[part].keys(), (what, part)
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {part} {k}")


@pytest.mark.parametrize("name", [n for n, *_ in RESNET_RUNS + (MNIST_RUN,)])
def test_resnet_and_mlp_match_the_reference_on_the_same_layout(runs, name):
    ranks, want = [r[name] for r in runs["ranks"][name]], runs["refs"][name]
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks), "ranks disagree on the loss"
    for r in ranks[1:]:  # the global batch's moments: the same statistics everywhere
        assert r["batch_stats"].keys() == ranks[0]["batch_stats"].keys()
        for k, v in r["batch_stats"].items():
            np.testing.assert_array_equal(v, ranks[0]["batch_stats"][k], err_msg=k)
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"], rtol=RTOL, atol=0)
    assert_state_close(ranks[0], want, name)


def test_data_parallel_gradients_equal_one_ranks(runs):
    """The moments' all-reduce is summed in the backward: the mean of the
    ranks' gradients is the one-rank gradient of the global batch."""
    trainer = make_trainer("cifar10", {"data": 1}, runs["inits"]["moved cifar10"])
    want = step_grads(trainer, runs["batches"]["cifar10"][0])
    for r in runs["world2"]:
        assert r["grads"].keys() == want.keys()
        for k, g in want.items():
            np.testing.assert_allclose(r["grads"][k], g, rtol=1e-5, atol=1e-7, err_msg=k)


def test_checkpoint_restores_bitwise_on_one_rank_and_fsdp(runs):
    from tensorflow_examples_torch.train.checkpoint import CheckpointManager

    saved = CheckpointManager(runs["ckpt"]).load(STEPS)
    trainer = make_trainer("cifar10", {"data": 1}, runs["inits"]["cifar10"])
    with CheckpointManager(runs["ckpt"]) as ckpt:
        trainer.state, step = ckpt.restore_latest(trainer.state)
    assert step == STEPS
    mine = whole_state(trainer)
    for got in (mine, *(r["restored fsdp"] for r in runs["world2"])):
        for k, v in saved["params"].items():
            np.testing.assert_array_equal(got["params"][k], v.numpy(), err_msg=k)
        for k, v in saved["model_state"]["batch_stats"].items():
            np.testing.assert_array_equal(got["batch_stats"][k], v.numpy(), err_msg=k)
    # ... and what was saved is what the data-parallel ranks held.
    held = runs["world2"][0]["cifar data"]
    for k, v in held["final_params"].items():
        np.testing.assert_array_equal(mine["params"][k], v, err_msg=k)


def test_data_parallel_eval_equals_one_device(runs):
    """The eval's weighted totals, summed over the batch axis, give the
    one-device mean over the real rows (the same restored state)."""
    from tensorflow_examples_torch.train.checkpoint import CheckpointManager

    trainer = make_trainer("cifar10", {"data": 1}, runs["inits"]["cifar10"])
    with CheckpointManager(runs["ckpt"]) as ckpt:
        trainer.state, _ = ckpt.restore_latest(trainer.state)
    want = trainer.evaluate(iter(eval_stream()))
    for r in runs["world2"]:
        got = r["cifar data"]["eval"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-7), k


def test_running_statistics_refuse_batch_axes_other_than_data_and_fsdp(runs):
    """``batch_axes`` that split a ResNet's batch over ``model``: the
    model sums its moments over ``data`` and ``fsdp`` only, so each rank
    would normalize with its own rows' moments and keep its own running
    statistics. The trainer refuses the layout."""
    for r in runs["world2"]:
        assert "running statistics" in r.get("refused", ""), r.get("refused")
        assert "['model']" in r["refused"]


@pytest.mark.parametrize("name", [n for n, *_ in BERT_RUNS])
def test_bert_matches_the_reference_on_the_same_layout(runs, name):
    ranks, want = [r[name] for r in runs["ranks"][name]], runs["refs"][name]
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks), "ranks disagree on the loss"
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"], rtol=RTOL, atol=0)
    assert_state_close(ranks[0], want, name)
    assert all(r["digest"] == want["digest"] for r in ranks)


def test_bert_model_axis_cuts_qkv_by_heads(runs):
    """On ``{model: 2}`` a rank holds half the heads of each qkv kernel
    (``[d, 3, H/2, hd]``), and the placement hashes as the reference's."""
    cfg = port_cfg("bert_glue")
    hd = cfg.d_model // cfg.num_heads
    for impl in ("xla", "flash"):
        for r in runs["ranks"][f"bert model {impl}"]:
            got = r[f"bert model {impl}"]
            assert got["qkv_local"] == (cfg.d_model, 3, cfg.num_heads // 2, hd)
    fsdp = runs["ranks"]["bert fsdp xla"][0]["bert fsdp xla"]["qkv_local"]
    assert fsdp == (cfg.d_model // 2, 3, cfg.num_heads, hd)
    trainer = make_trainer("bert_glue", {"data": 1}, runs["inits"]["bert_glue"])
    assert trainer.sharding_digest() == runs["refs"]["bert model xla"]["digest"]


def _run_cli(module: str, flags: list, nproc: int = 1):
    """``python -m tensorflow_examples_torch.<module>``, under torchrun
    with ``nproc`` > 1 (a free loopback port for the rendezvous)."""
    import os
    import socket
    import subprocess
    import sys

    cmd = [sys.executable, "-m", f"tensorflow_examples_torch.{module}", *flags]
    if nproc > 1:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
               "--nproc_per_node", str(nproc), "--master_addr", "127.0.0.1", "--master_port",
               str(port), "-m", f"tensorflow_examples_torch.{module}", *flags]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=180, env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = [json.loads(x) for x in done.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1, done.stdout[-2000:]  # rank 0 prints the one line
    return lines[0]


def test_imagenet_cli_trains_and_evaluates_on_data2_under_torchrun(tmp_path):
    """``train.cli --workload imagenet --mesh_data 2`` under torchrun (a
    ResNet on a data mesh through ``fit``: the task made for the mesh,
    rank 0's checkpoint and final eval), then ``train.eval`` on the same
    flags under torchrun and in one process: the three evals agree."""
    flags = ["--device", "cpu", "--workload", "imagenet", "--model", "resnet18",
             "--image_size", "32", "--num_classes", "4", "--global_batch_size", "8",
             "--train_steps", "2", "--warmup_steps", "1", "--eval_batches", "1",
             "--checkpoint_every", "2", "--telemetry_sinks", "", "--workdir",
             str(tmp_path / "run")]
    trained = _run_cli("train.cli", [*flags, "--mesh_data", "2"], nproc=2)
    assert trained["mesh"]["data"] == 2 and trained["steps"] == 2
    on_mesh = _run_cli("train.eval", [*flags, "--mesh_data", "2"], nproc=2)
    alone = _run_cli("train.eval", flags)
    assert on_mesh["step"] == alone["step"] == 2
    for k in ("loss", "accuracy", "top5_accuracy"):
        assert on_mesh[f"eval_{k}"] == pytest.approx(alone[f"eval_{k}"], rel=1e-6), k
        assert trained[f"eval_{k}"] == pytest.approx(alone[f"eval_{k}"], rel=1e-6), k
