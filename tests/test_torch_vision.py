"""The image workloads in the port against the JAX package (PyTorch/CUDA port).

* ResNet-20 at 32 x 32 and ResNet-50 on a tiny 40 x 40 input (its 7x7/2
  stem, SAME max pool and stride-2 bottlenecks all pad asymmetrically by
  XLA's rule): logits in training and eval mode and the ``batch_stats``
  after a training forward against flax (1e-5 for ResNet-20, 1e-4 over
  ResNet-50's 53 layers), on the same variables
  with BatchNorm scales, biases and statistics moved off their init;
  every depth's variable tree against flax's; the SAME rule against
  ``lax.padtype_to_pads``.
* The MLP's logits against flax's (NHWC flattened in the reference's
  order).
* 5-step trajectories of ``cifar10`` (augmentation on) and ``mnist``
  against the JAX ``Trainer`` at rtol 3e-3, the ResNet's ``batch_stats``
  after every step included, at f32; at bf16 the statistics stay f32 and
  step 0's loss agrees with f32's to bf16 precision.
* ``adam``, ``adamw_linear`` (with its warmup-linear schedule) and
  ``sgd_momentum_cosine`` against optax over 30 updates with clipping.
* A k-step bundle through the graph path's stand-in carries the
  ``batch_stats`` forward as k eager steps do.
* The CLI: ``--workload cifar10`` (on python-pickle batches the test
  writes) and ``mnist`` train 2 steps on the CPU, and ``imagenet`` is
  refused by name.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

from tensorflow_examples_tpu.data import memory as jax_memory
from tensorflow_examples_tpu.data.augment import cifar_augment as jax_cifar_augment
from tensorflow_examples_tpu.models import mlp as jax_mlp
from tensorflow_examples_tpu.models import resnet as jax_resnet
from tensorflow_examples_tpu.sharding import ShardingConfig
from tensorflow_examples_tpu.train import loop as jax_loop
from tensorflow_examples_tpu.train import optimizers as jax_optimizers
from tensorflow_examples_tpu.workloads import cifar10 as jax_cifar10
from tensorflow_examples_tpu.workloads import mnist as jax_mnist
from tensorflow_examples_torch.data import memory
from tensorflow_examples_torch.data.prefetch import bundle_batches
from tensorflow_examples_torch.models import convert, mlp, resnet
from tensorflow_examples_torch.models.transformer import ParamView
from tensorflow_examples_torch.train import cli, optimizers
from tensorflow_examples_torch.train.graphs import BundledStep
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.workloads import cifar10, mnist


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_trainer(module, cfg):
    sc = ShardingConfig(mesh={"data": 1})
    mesh = sc.build_mesh()
    return jax_loop.Trainer(module.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc)


def jittered(variables, seed=1):
    """Variables moved off their init (unit scales, zero biases and
    statistics would hide a BatchNorm mistake); variances stay positive."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, tree in variables.items():
        flat_tree = convert.flatten_tree(tree)
        out[name] = {k: (np.abs(v) + 0.5 if k.endswith("var") else
                         v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                     for k, v in flat_tree.items()}
    return out


def as_torch(flat_tree):
    return {k.replace("/", "."): torch.tensor(v) for k, v in flat_tree.items()}


def unflatten(flat_tree):
    tree: dict = {}
    for k, v in flat_tree.items():
        *path, leaf = k.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.mark.parametrize("n", [32, 31, 40, 224, 1])
def test_same_padding_is_xla_rule(n):
    for k, s in ((3, 1), (3, 2), (1, 2), (7, 2), (3, 3)):
        assert resnet.same_pads(n, k, s) == tuple(lax.padtype_to_pads((n,), (k,), (s,),
                                                                      "SAME")[0])
    assert resnet.same_pads(32, 3, 2) == (0, 1)  # torch's padding=1 would be (1, 1)


@pytest.mark.parametrize("name,shape,tol", [("resnet20", (4, 32, 32, 3), 1e-5),
                                            ("resnet50", (2, 40, 40, 3), 1e-4)])
def test_resnet_forward_and_batch_stats_match_flax(name, shape, tol):
    """``tol``: f32 summation order over 20 layers, and over ResNet-50's 53."""
    jm = getattr(jax_resnet, name)(num_classes=5)
    init = numpy_tree(jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1,) + shape[1:])))
    v = jittered(init)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    j_vars = {k: unflatten(t) for k, t in v.items()}
    j_train, j_new = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        j_vars, jnp.asarray(x))
    j_eval = jax.jit(lambda v, x: jm.apply(v, x, train=False))(j_vars, jnp.asarray(x))
    cfg = getattr(resnet, name)(num_classes=5)
    params, stats = as_torch(v["params"]), as_torch(v["batch_stats"])
    ours, new_stats = resnet.apply(cfg, params, stats, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(j_train), atol=tol, rtol=tol)
    want = as_torch(convert.flatten_tree(numpy_tree(j_new["batch_stats"])))
    assert list(new_stats) == list(stats)  # the input's order: a graph copies back by position
    for k, t in want.items():
        np.testing.assert_allclose(new_stats[k].numpy(), t.numpy(), atol=tol, rtol=tol,
                                   err_msg=k)
    evald, same = resnet.apply(cfg, params, stats, torch.from_numpy(x))
    np.testing.assert_allclose(evald.numpy(), np.asarray(j_eval), atol=tol, rtol=tol)
    assert all(same[k] is stats[k] for k in stats)
    # The flax tree into the module: params into its parameters, batch_stats into its buffers.
    model = convert.load_params(resnet.ResNet(cfg, device="meta").to_empty(device="cpu"),
                                j_vars["params"], j_vars["batch_stats"])
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), np.asarray(j_eval),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["resnet20", "resnet18", "resnet34", "resnet50", "resnet101",
                                  "resnet152"])
def test_every_depth_has_the_flax_tree(name):
    jm = getattr(jax_resnet, name)(num_classes=7)
    shape = (1, 32, 32, 3)
    tree = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros(shape)))
    theirs = {c: {k.replace("/", "."): tuple(s.shape) for k, s in _flat_shapes(t).items()}
              for c, t in tree.items()}
    model = resnet.ResNet(getattr(resnet, name)(num_classes=7), device="meta")
    ours = {"params": {k: tuple(p.shape) for k, p in model.named_parameters()},
            "batch_stats": {k: tuple(b.shape) for k, b in model.named_buffers()}}
    assert ours == theirs


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_init_zeroes_each_blocks_last_scale():
    v = resnet.variables(resnet.ResNet(resnet.resnet20(), seed=3))
    p = v["params"]
    assert not p["stage1_block0.BatchNorm_1.scale"].any()
    assert torch.equal(p["stage1_block0.BatchNorm_0.scale"], torch.ones(32))
    assert torch.equal(v["batch_stats"]["stem_bn.var"], torch.ones(16))
    std = float(p["stage2_block2.Conv_1.kernel"].std())
    assert abs(std - (2.0 / (9 * 64)) ** 0.5) < 0.01  # variance 2 / fan_out


def test_mlp_matches_flax():
    jm = jax_mlp.MLP(features=(32, 16), num_classes=10)
    x = np.random.default_rng(2).standard_normal((5, 28, 28, 1)).astype(np.float32)
    params = numpy_tree(jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 28, 28, 1))))
    theirs = jm.apply(params, jnp.asarray(x))
    cfg = mlp.MLPConfig(features=(32, 16))
    ours = mlp.forward(cfg, ParamView(as_torch(convert.flatten_tree(params["params"]))),
                       torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5, rtol=1e-5)
    model = convert.load_params(mlp.MLP(cfg, device="meta").to_empty(device="cpu"),
                                params["params"])
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), np.asarray(theirs),
                                   atol=1e-5, rtol=1e-5)
    assert {k: tuple(p.shape) for k, p in mlp.MLP(cfg).named_parameters()} == {
        k.replace("/", "."): v.shape for k, v in convert.flatten_tree(params["params"]).items()}


# ------------------------------------------------------------- training


def tiny(config_jax, config, **kw):
    base = dict(global_batch_size=8, train_steps=40, warmup_steps=2, log_every=1, eval_every=0,
                precision="f32")
    base.update(kw)
    return (config_jax(checkpoint_every=0, **base),
            config(device="cpu", telemetry_sinks="", **base))


@pytest.mark.parametrize("workload", ["cifar10", "mnist"])
def test_five_step_trajectory_and_batch_stats_match_jax_trainer(workload):
    if workload == "cifar10":
        jax_cfg, cfg = tiny(jax_cifar10.Cifar10Config, cifar10.Cifar10Config)
        jax_mod, mod = jax_cifar10, cifar10
    else:
        jax_cfg, cfg = tiny(jax_mnist.MnistConfig, mnist.MnistConfig,
                            dropout=0.0, global_batch_size=32)
        jax_mod, mod = jax_mnist, mnist
    jt = jax_trainer(jax_mod, jax_cfg)
    init = numpy_tree(jt.state.params)
    train_ds, _ = jax_mod.datasets(jax_cfg)
    augment = jax_cifar_augment if workload == "cifar10" else None
    it = jax_memory.train_iterator(train_ds, cfg.global_batch_size, seed=0, augment=augment)
    state, theirs, their_stats = jt.state, [], []
    for _ in range(5):
        state, metrics = jt._train_step(state, jt._put_batch(next(it)))
        theirs.append(float(metrics["loss"]))
        their_stats.append(convert.flatten_tree(numpy_tree(state.model_state)))
    trainer = Trainer(mod.make_task(cfg), cfg, init_params=init)
    ours_ds, _ = mod.datasets(cfg)
    ours_it = memory.train_iterator(ours_ds, cfg.global_batch_size, seed=0,
                                    augment=getattr(mod, "train_augment", lambda c: None)(cfg))
    ours = []
    for step in range(5):
        ours.append(float(trainer.train_step(next(ours_it))["loss"]))
        ours_stats = {f"{c}/{k}": t.numpy() for c, tree in trainer.state.model_state.items()
                      for k, t in tree.items()}
        assert ours_stats.keys() == {_dotted(k) for k in their_stats[step]}
        for k, t in their_stats[step].items():
            np.testing.assert_allclose(ours_stats[_dotted(k)], t, rtol=3e-3, atol=1e-5,
                                       err_msg=f"{k} after step {step}")
    np.testing.assert_allclose(ours, theirs, rtol=3e-3, atol=0)


def _dotted(path: str) -> str:
    """A flax ``batch_stats/a/b/mean`` path as the port's
    ``batch_stats/a.b.mean`` (collection, then the flat name)."""
    collection, rest = path.split("/", 1)
    return f"{collection}/{rest.replace('/', '.')}"


def test_bf16_keeps_f32_statistics_and_step0_loss_close_to_f32():
    """bf16 compute casts the params and the batch, never the running
    statistics (the reference's policy); step 0's loss agrees with the
    f32 step's to bf16 precision."""
    _, cfg = tiny(jax_cifar10.Cifar10Config, cifar10.Cifar10Config)
    batch = next(memory.train_iterator(cifar10.datasets(cfg)[0], 8, seed=0,
                                       augment=cifar10.train_augment(cfg)))
    losses = {}
    for precision in ("f32", "bf16"):
        trainer = Trainer(cifar10.make_task(cfg), cfg.replace(precision=precision))
        losses[precision] = float(trainer.train_step(batch)["loss"])
        stats = trainer.state.model_state["batch_stats"]
        assert all(t.dtype == torch.float32 for t in stats.values())
        assert not torch.equal(stats["stem_bn.mean"], torch.zeros(16))
    np.testing.assert_allclose(losses["bf16"], losses["f32"], rtol=2e-2)


# ------------------------------------------------------------ optimizers


@pytest.mark.parametrize("name", ["adam", "adamw_linear", "sgd_momentum_cosine"])
def test_optimizer_matches_optax_over_30_updates(name):
    base = dict(learning_rate=0.05, warmup_steps=5, train_steps=25, weight_decay=0.01,
                grad_clip_norm=1.0)
    jax_cfg, cfg = tiny(jax_cifar10.Cifar10Config, cifar10.Cifar10Config,
                        **base)
    if name == "adamw_linear":
        schedule = jax_optimizers.warmup_linear(jax_cfg)
        ours_schedule = optimizers.warmup_linear(cfg)
        for count in range(35):
            np.testing.assert_allclose(float(ours_schedule(count)), float(schedule(count)),
                                       rtol=1e-6, atol=1e-12)
    r = np.random.default_rng(0)
    params = {"a": r.standard_normal((4, 3)).astype(np.float32),
              "b": r.standard_normal((5,)).astype(np.float32)}
    tx = getattr(jax_optimizers, name)(jax_cfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    jax_update = jax.jit(tx.update)
    ours_tx = getattr(optimizers, name)(cfg)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tstate = ours_tx.init(tp)
    for step in range(30):
        scale = 5.0 if step % 3 == 0 else 0.1  # some steps clip, some do not
        grads = {k: (r.standard_normal(v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        updates, jstate = jax_update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tupd, tstate = ours_tx.update({k: torch.from_numpy(g) for k, g in grads.items()},
                                      tstate, tp)
        tp = optimizers.apply_updates(tp, tupd)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=2e-5, atol=1e-7,
                                       err_msg=f"{name}: {k} after update {step}")


# ------------------------------------------------------- graphs and CLI


def _rerun_graph(fn, generators):
    """A CPU stand-in for a CUDA graph: a replay reruns the captured
    function into the same output tensors."""
    out = fn()

    def replay():
        for o, n in zip(out.values(), fn().values()):
            o.copy_(n)

    return types.SimpleNamespace(replay=replay), out, {}


def test_bundle_carries_batch_stats_as_eager_steps():
    _, cfg = tiny(jax_cifar10.Cifar10Config, cifar10.Cifar10Config)
    ds = cifar10.datasets(cfg)[0]
    eager = Trainer(cifar10.make_task(cfg), cfg)
    it = memory.train_iterator(ds, 8, seed=0, augment=cifar10.train_augment(cfg))
    losses = [float(eager.train_step(next(it))["loss"]) for _ in range(4)]
    trainer = Trainer(cifar10.make_task(cfg), cfg)
    step = BundledStep(trainer, 2, graph=True, graph_factory=_rerun_graph)
    bundles = bundle_batches(memory.train_iterator(ds, 8, seed=0,
                                                   augment=cifar10.train_augment(cfg)), 2)
    ours = []
    for _ in range(2):
        trainer.state, metrics = step(trainer.state, {k: torch.as_tensor(v)
                                                      for k, v in next(bundles).items()})
        ours += metrics["loss"].tolist()
    assert ours == losses
    for k, t in eager.state.model_state["batch_stats"].items():
        assert torch.equal(t, trainer.state.model_state["batch_stats"][k]), k


def write_cifar_batches(root, n: int = 16, seed: int = 0) -> np.ndarray:
    """CIFAR-10's python-pickle distribution (``data_batch_1..5`` and
    ``test_batch`` under ``cifar-10-batches-py``) with ``n`` seeded
    uint8 images each: the pixel rows of the first training batch."""
    import os
    import pickle

    rng = np.random.default_rng(seed)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    first = None
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = rng.integers(0, 256, (n, 3072), dtype=np.uint8)
        first = data if first is None else first
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": data, b"labels": rng.integers(0, 10, n).tolist()}, f)
    return first


@pytest.mark.parametrize("workload", ["cifar10", "mnist"])
def test_cli_trains_two_steps_on_cpu(workload, capsys, tmp_path):
    data = []
    if workload == "cifar10":  # real-format batches: uint8 through the native augmentation
        write_cifar_batches(tmp_path)
        data = ["--data_dir", str(tmp_path)]
    assert cli.main(["--workload", workload, "--device", "cpu", "--global_batch_size", "8",
                     "--train_steps", "2", "--log_every", "1", "--eval_every", "0",
                     "--eval_batch_size", "2000", "--telemetry_sinks", "", *data]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and out["workload"] == workload
    assert np.isfinite(out["loss"]) and 0.0 <= out["eval_accuracy"] <= 1.0
    args = cli.build_parser(workload).parse_args([])
    if workload == "cifar10":
        assert (args.augment, args.learning_rate, args.global_batch_size) == (True, 0.1, 128)
    else:
        assert (args.hidden, args.num_layers, args.global_batch_size) == (128, 2, 256)


def test_unported_workload_is_refused_by_name(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--workload", "imagenet", "--device", "cpu"])
    assert e.value.code == 2
    assert "imagenet" in capsys.readouterr().err
