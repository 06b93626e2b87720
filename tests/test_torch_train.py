"""The port's training slice against the JAX package (PyTorch/CUDA port).

* ``core/rng.py`` against ``jax.random`` directly: keys after
  ``PRNGKey``/``fold_in``, ``random_bits`` and ``uniform`` bit for bit,
  ``categorical`` draws over 1 000 keys, and the sampled streams of both
  engine configurations against the JAX engine at the smoke model.
  XLA's CPU ``log`` is not correctly rounded and torch's is, so about a
  fifth of Gumbel values differ from jax's by one ulp: a sampled stream
  may part from the JAX engine's only where the two best
  Gumbel-perturbed scores are within 1e-4 (a near-tie), the rule the
  greedy parity tests use for logits.
* The optimizer (optax schedule, AdamW, clipping, accumulation) against
  optax over 30 updates; losses, cross-entropy and the precision policy.
* At ``tests/test_train_gpt2.py``'s tiny config, f32 and dropout 0: the
  training forward's logits against flax ``Transformer.apply`` (flash
  in interpret mode, and xla), one step's loss and every gradient
  against ``jax.value_and_grad`` of the JAX task's ``loss_fn``, and a
  5-step loss trajectory against the JAX ``Trainer`` at rtol 3e-3 (the
  bound of ``tests/test_sharding.py``'s trajectory test).
* remat, the bad-step guard, data order, the CLI, the device policy, and
  weights carried back from a port-trained model into the JAX
  ``eval_fn``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflow_examples_tpu.data import memory as jax_memory
from tensorflow_examples_tpu.data import sources as jax_sources
from tensorflow_examples_tpu.models import transformer as jax_transformer
from tensorflow_examples_tpu.ops import cross_entropy as jax_ce
from tensorflow_examples_tpu.ops import losses as jax_losses
from tensorflow_examples_tpu.serving import engine as jax_engine
from tensorflow_examples_tpu.sharding import ShardingConfig
from tensorflow_examples_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from tensorflow_examples_tpu.train import loop as jax_loop
from tensorflow_examples_tpu.train import optimizers as jax_optimizers
from tensorflow_examples_tpu.workloads import gpt2 as jax_gpt2
from tensorflow_examples_torch.core import precision, rng
from tensorflow_examples_torch.data import memory, sources
from tensorflow_examples_torch.models import convert, transformer
from tensorflow_examples_torch.ops import cross_entropy, losses
from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
from tensorflow_examples_torch.telemetry.registry import MetricsRegistry
from tensorflow_examples_torch.train import cli, optimizers
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.train.task import Task
from tensorflow_examples_torch.workloads import gpt2

NEAR_TIE = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run beside timing-sensitive
    serving tests in other workers and must not starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(**kw):
    """``tests/test_train_gpt2.py``'s tiny_config, as (JAX, port) configs."""
    base = dict(vocab_size=64, seq_len=16, num_layers=2, num_heads=4, d_model=32, dropout=0.0,
                attention="xla", global_batch_size=16, train_steps=30, warmup_steps=5,
                learning_rate=3e-3, log_every=10, eval_every=0, precision="f32")
    base.update(kw)
    jax_cfg = jax_gpt2.Gpt2Config(checkpoint_every=0, **base)
    return jax_cfg, gpt2.Gpt2Config(device="cpu", **base)


def jax_trainer(cfg):
    sc = ShardingConfig(mesh={"data": 1})
    mesh = sc.build_mesh()
    return jax_loop.Trainer(jax_gpt2.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------------ rng


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -7])
def test_prng_key_and_fold_in_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(key), rng.PRNGKey(seed))
    for data in (0, 1, 977, 2**32 - 1):
        assert np.array_equal(np.asarray(jax.random.fold_in(key, data)),
                              rng.fold_in(rng.PRNGKey(seed), data))
    assert np.array_equal(rng.step_rng(rng.PRNGKey(seed), 5),
                          np.asarray(jax.random.fold_in(key, 5)))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4), (50257,)])
def test_random_bits_and_uniform_bit_for_bit(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(11), 3)
    ours = np.asarray(key)
    assert np.array_equal(rng.random_bits(ours, shape),
                          np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    for lo, hi in ((0.0, 1.0), (np.finfo(np.float32).tiny, 1.0), (-2.0, 3.0)):
        a = rng.uniform(ours, shape, lo, hi)
        b = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_categorical_draws_match_jax_over_1000_keys():
    logits = np.random.default_rng(0).standard_normal((1000, 64)).astype(np.float32) * 3
    root = jax.random.PRNGKey(3)
    ours, theirs = [], []
    for i in range(1000):
        key = jax.random.fold_in(root, i)
        theirs.append(int(jax.random.categorical(key, jnp.asarray(logits[i]))))
        ours.append(rng.categorical(np.asarray(key), torch.from_numpy(logits[i])))
    assert ours == theirs
    assert len(set(ours)) > 30  # real draws, not an argmax


SERVE = {"flash": dict(attention="flash"),
         "paged_flash": dict(attention="paged_flash", kv_block_size=8)}
SMOKE = dict(vocab_size=211, max_len=64, num_layers=2, num_heads=2, d_model=32)


@pytest.fixture(scope="module")
def smoke_params():
    cfg = jax_transformer.TransformerConfig(**SMOKE)
    params = jax_transformer.Transformer(cfg).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 8), jnp.int32))["params"]
    return numpy_tree(params)


def drive_sampled(engine, prompts, max_new, temperature, top_k):
    """Sampled streams served together (request i has seed i)."""
    slots, streams = {}, {}
    for i, p in enumerate(prompts):
        slots[i] = engine.pool.alloc()
        streams[i] = [engine.prefill(slots[i], p, seed=i, temperature=temperature,
                                     top_k=top_k)[0]]
    while True:
        live = [i for i in streams if len(streams[i]) < max_new]
        for i in list(slots):
            if i not in live:
                engine.pool.free(slots.pop(i))
        if not live:
            return [streams[i] for i in range(len(prompts))]
        out = engine.decode([(slots[i], streams[i][-1], i, temperature, top_k) for i in live])
        for i in live:
            streams[i].append(out[slots[i]])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("top_k", [0, 5])
@pytest.mark.parametrize("name", sorted(SERVE))
def test_sampled_streams_match_jax_engine(smoke_params, name, top_k):
    temp = 0.8
    prompts = [[int(t) for t in np.random.default_rng(ln).integers(0, 211, ln)]
               for ln in (5, 12, 20)]
    kw = dict(max_slots=4, prefill_bucket_floor=16, kv_bucket_floor=32, **SERVE[name])
    port = InferenceEngine(transformer.TransformerConfig(**SMOKE), smoke_params,
                           cfg=ServeConfig(**kw), registry=MetricsRegistry(), device="cpu")
    theirs_engine = jax_engine.InferenceEngine(
        jax_transformer.TransformerConfig(**SMOKE), jax.tree.map(jnp.asarray, smoke_params),
        cfg=jax_engine.ServeConfig(**kw), registry=JaxRegistry())
    ours = drive_sampled(port, prompts, 8, temp, top_k)
    theirs = drive_sampled(theirs_engine, prompts, 8, temp, top_k)
    for seed, (prompt, a, b) in enumerate(zip(prompts, ours, theirs)):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                pos = len(prompt) + i
                scaled = port.reference_logits(prompt + b[:i]).float() / temp
                if top_k:
                    kth = torch.sort(scaled).values[-top_k]
                    scaled = torch.where(scaled < kth, -1e30, scaled)
                scores = rng.gumbel(rng.fold_in(rng.PRNGKey(seed), pos), scaled.shape) + scaled
                top2 = torch.topk(scores, 2).values
                assert float(top2[0] - top2[1]) < NEAR_TIE, (name, seed, i, a, b)
                break
        assert len(a) == len(b)
    assert ours != [[s[0]] * 8 for s in ours]  # sampling, not a constant
    for seed, prompt in enumerate(prompts):  # and the port's own golden
        assert ours[seed] == port.reference_generate(prompt, max_new=8, seed=seed,
                                                     temperature=temp, top_k=top_k)


# ------------------------------------------------------------ optimizer


@pytest.mark.parametrize("accum", [1, 2])
def test_adamw_cosine_matches_optax_over_30_updates(accum):
    jax_cfg, cfg = tiny(grad_accum_steps=accum, weight_decay=0.1, grad_clip_norm=1.0,
                        train_steps=40)
    schedule = jax_optimizers.warmup_cosine(jax_cfg, end_value=0.1 * jax_cfg.learning_rate)
    ours_schedule = optimizers.warmup_cosine(cfg, end_value=0.1 * cfg.learning_rate)
    for count in range(45):
        np.testing.assert_allclose(float(ours_schedule(count)), float(schedule(count)),
                                   rtol=1e-6, atol=1e-12)
    assert float(ours_schedule(0)) == 0.0
    r = np.random.default_rng(0)
    params = {"a": r.standard_normal((4, 3)).astype(np.float32),
              "b": r.standard_normal((5,)).astype(np.float32)}
    tx = jax_optimizers.adamw_cosine(jax_cfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    jax_update = jax.jit(tx.update)
    ours_tx = optimizers.adamw_cosine(cfg)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tstate = ours_tx.init(tp)
    for step in range(30 * accum):
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
                                       err_msg=f"{k} after update {step}")


def test_losses_and_reference_cross_entropy_match_jax():
    r = np.random.default_rng(1)
    logits = r.standard_normal((12, 50)).astype(np.float32) * 4
    labels = r.integers(0, 50, 12).astype(np.int32)
    weights = (r.random(12) > 0.3).astype(np.float32)
    t_logits, t_labels, t_w = (torch.from_numpy(x) for x in (logits, labels, weights))
    np.testing.assert_allclose(losses.select_label(t_logits, t_labels).numpy(),
                               np.asarray(jax_losses.select_label(logits, labels)))
    np.testing.assert_allclose(float(losses.weighted_mean(t_logits[:, 0], t_w)),
                               float(jax_losses.weighted_mean(logits[:, 0], weights)), rtol=1e-6)
    np.testing.assert_allclose(
        cross_entropy.cross_entropy_per_example(t_logits, t_labels).numpy(),
        np.asarray(jax_ce.cross_entropy_reference(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(cross_entropy.cross_entropy_loss(t_logits.reshape(3, 4, 50), t_labels.reshape(3, 4),
                                               t_w.reshape(3, 4))),
        float(jax_ce.cross_entropy_loss(jnp.asarray(logits).reshape(3, 4, 50),
                                        jnp.asarray(labels).reshape(3, 4),
                                        jnp.asarray(weights).reshape(3, 4), fused=False)),
        rtol=1e-6)
    np.testing.assert_allclose(  # fused=True: the kernels' plain versions on the CPU
        cross_entropy.cross_entropy_per_example(t_logits, t_labels, fused=True).numpy(),
        np.asarray(jax_ce.cross_entropy_per_example(jnp.asarray(logits), jnp.asarray(labels),
                                                    fused=True)),
        rtol=1e-5, atol=1e-5)


def test_precision_policy_casts_differentiably():
    policy = precision.PrecisionPolicy.create("bf16")
    assert (policy.param_dtype, policy.compute_dtype) == (torch.float32, torch.bfloat16)
    w = torch.ones(3, requires_grad=True)
    cast = policy.cast_compute({"w": w, "ids": torch.arange(3)})
    assert cast["w"].dtype == torch.bfloat16 and cast["ids"].dtype == torch.int64
    (g,) = torch.autograd.grad(cast["w"].float().sum(), (w,))
    assert g.dtype == torch.float32 and torch.equal(g, torch.ones(3))
    assert precision.PrecisionPolicy.create("bf16_full").param_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        precision.PrecisionPolicy.create("fp8")


def test_layer_norm_keeps_f32_statistics_in_bf16():
    """flax LayerNorm with dtype=bf16: statistics and affine map in f32,
    one rounding to bf16 at the end."""
    import flax.linen as nn

    x = np.random.default_rng(2).standard_normal((4, 32)).astype(np.float32) * 3 + 5
    xb = jnp.asarray(x, jnp.bfloat16)
    ln = nn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
    theirs = ln.apply(ln.init(jax.random.PRNGKey(0), xb), xb)
    params = transformer.LayerNorm(32)
    ours = transformer._layer_norm(torch.from_numpy(x).bfloat16(), params.to(torch.bfloat16))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().detach().numpy(), np.asarray(theirs, np.float32),
                               atol=1.6e-2, rtol=0)


# ------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def tiny_params():
    jax_cfg, _ = tiny()
    params = jax_transformer.Transformer(jax_gpt2.model_config(jax_cfg)).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16), jnp.int32))["params"]
    return numpy_tree(params)


def tiny_batch(seed=0, n=16):
    return {"tokens": np.random.default_rng(seed).integers(0, 64, (n, 17)).astype(np.int32)}


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_training_forward_matches_flax(tiny_params, impl):
    jax_cfg, cfg = tiny(attention=impl)
    tokens = tiny_batch()["tokens"][:4, :16]
    theirs = jax_transformer.Transformer(jax_gpt2.model_config(jax_cfg)).apply(
        {"params": tiny_params}, jnp.asarray(tokens), train=True,
        rngs={"dropout": jax.random.PRNGKey(0)})
    params = {k.replace("/", "."): torch.tensor(v)
              for k, v in convert.flatten_tree(tiny_params).items()}
    ours = transformer.forward(gpt2.model_config(cfg), transformer.ParamView(params),
                               torch.from_numpy(tokens), train=True,
                               noise=rng.StepNoise(rng.PRNGKey(0)))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_one_step_loss_and_every_grad_match_jax(tiny_params, impl):
    jax_cfg, cfg = tiny(attention=impl)
    batch = tiny_batch(1)
    jax_task = jax_gpt2.make_task(jax_cfg)
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: jax_task.loss_fn(p, {}, {"tokens": jnp.asarray(batch["tokens"])},
                                   rng=jax.random.PRNGKey(0), train=True)[:2],
        has_aux=True)(jax.tree.map(jnp.asarray, tiny_params))
    task = gpt2.make_task(cfg)
    leaves = {k.replace("/", "."): torch.tensor(v).requires_grad_()
              for k, v in convert.flatten_tree(tiny_params).items()}
    loss, _, _ = task.loss_fn(leaves, {}, {"tokens": torch.from_numpy(batch["tokens"])},
                              rng=rng.StepNoise(rng.PRNGKey(0)), train=True)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-6)
    for path, g in convert.flatten_tree(numpy_tree(j_grads)).items():
        np.testing.assert_allclose(grads[path.replace("/", ".")].numpy(), g, atol=2e-6,
                                   rtol=1e-4, err_msg=path)


def test_five_step_trajectory_matches_jax_trainer():
    jax_cfg, cfg = tiny(log_every=1)
    jt = jax_trainer(jax_cfg)
    init = numpy_tree(jt.state.params)
    train_ds, _ = jax_gpt2.datasets(jax_cfg)
    it = jax_memory.train_iterator(train_ds, 16, seed=0)
    state, theirs = jt.state, []
    for _ in range(5):
        state, metrics = jt._train_step(state, jt._put_batch(next(it)))
        theirs.append(float(metrics["loss"]))
    trainer = Trainer(gpt2.make_task(cfg), cfg, init_params=init)
    ours_ds, _ = gpt2.datasets(cfg)
    trainer.fit(memory.train_iterator(ours_ds, 16, seed=0), num_steps=5)
    ours = [h["loss"] for h in trainer.history]
    assert len(ours) == 5 and ours[-1] < ours[0]
    np.testing.assert_allclose(ours, theirs, rtol=3e-3, atol=0)


def test_bf16_step_loss_close_to_jax(tiny_params):
    """bf16 compute, f32 masters, both frameworks: the step-0 loss agrees
    to bf16 precision (different rounding points, same policy)."""
    jax_cfg, cfg = tiny(precision="bf16", attention="flash")
    jt = jax_trainer(jax_cfg)
    jt.state = jt.state.replace(params=jax.tree.map(jnp.asarray, tiny_params))
    batch = tiny_batch(2)
    _, j_metrics = jt._train_step(jt.state, jt._put_batch(batch))
    trainer = Trainer(gpt2.make_task(cfg), cfg, init_params=tiny_params)
    metrics = trainer.train_step(batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=1e-2)
    assert all(p.dtype == torch.float32 for p in trainer.state.params.values())


def test_remat_gives_the_same_grads(tiny_params):
    """With dropout on: the recomputed blocks redraw the same masks."""
    _, cfg = tiny(dropout=0.1, attention="flash")
    grads = []
    for remat in (False, True):
        task = gpt2.make_task(cfg.replace(remat=remat))
        leaves = {k.replace("/", "."): torch.tensor(v).requires_grad_()
                  for k, v in convert.flatten_tree(tiny_params).items()}
        loss, _, _ = task.loss_fn(leaves, {}, {"tokens": torch.from_numpy(tiny_batch()["tokens"])},
                                  rng=rng.StepNoise(rng.PRNGKey(9)), train=True)
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dropout_masks_follow_the_step_key(tiny_params):
    _, cfg = tiny(dropout=0.5, attention="flash")
    mcfg = gpt2.model_config(cfg)
    params = transformer.ParamView({k.replace("/", "."): torch.tensor(v)
                                    for k, v in convert.flatten_tree(tiny_params).items()})
    tokens = torch.from_numpy(tiny_batch()["tokens"][:2, :16])
    run = lambda key, train=True: transformer.forward(
        mcfg, params, tokens, train=train, noise=None if key is None else rng.StepNoise(key))
    assert torch.equal(run(rng.PRNGKey(1)), run(rng.PRNGKey(1)))
    assert not torch.equal(run(rng.PRNGKey(1)), run(rng.PRNGKey(2)))
    assert torch.equal(run(rng.PRNGKey(1), train=False), run(None))


# ------------------------------------------------------------ the trainer


def test_bad_step_guard_keeps_state_and_advances_step():
    _, cfg = tiny()
    task = gpt2.make_task(cfg)

    def loss_fn(params, model_state, batch, *, rng, train):
        loss, metrics, ms = task.loss_fn(params, model_state, batch, rng=rng, train=train)
        return loss * batch["scale"].mean(), metrics, ms

    trainer = Trainer(Task("scaled", task.init_fn, loss_fn, task.make_optimizer), cfg)
    good = {**tiny_batch(), "scale": np.ones(16, np.float32)}
    m = trainer.train_step(good)
    assert float(m["bad_step"]) == 0.0
    before = trainer.state
    m = trainer.train_step({**tiny_batch(1), "scale": np.full(16, np.nan, np.float32)})
    assert float(m["bad_step"]) == 1.0 and not np.isfinite(float(m["loss"]))
    after = trainer.state
    assert after.step == before.step + 1
    for k in before.params:
        assert torch.equal(after.params[k], before.params[k])
    for a, b in zip(optimizers.tree_leaves(after.opt_state),
                    optimizers.tree_leaves(before.opt_state)):
        assert torch.equal(a, b)
    m = trainer.train_step(good)
    assert float(m["bad_step"]) == 0.0 and np.isfinite(float(m["loss"]))
    assert not torch.equal(trainer.state.params["wte.embedding"], before.params["wte.embedding"])


def test_batches_equal_the_jax_iterators(tmp_path):
    for split in ("train", "val"):
        ours = sources.load_lm_tokens("", split, seq_len=16, vocab_size=64)
        theirs = jax_sources.load_lm_tokens("", split, seq_len=16, vocab_size=64)
        assert np.array_equal(ours.arrays["tokens"], theirs.arrays["tokens"])
    np.arange(1000, dtype=np.uint16).tofile(tmp_path / "train.bin")
    ours = sources.load_lm_tokens(str(tmp_path), "train", seq_len=16, vocab_size=1000)
    theirs = jax_sources.load_lm_tokens(str(tmp_path), "train", seq_len=16, vocab_size=1000)
    assert np.array_equal(ours.arrays["tokens"], theirs.arrays["tokens"])
    ds = sources.synthetic_tokens(50, 9, 64, seed=3)
    jds = jax_memory.InMemoryDataset(dict(ds.arrays))
    a = memory.train_iterator(ds, 16, seed=7, start_step=2)
    b = jax_memory.train_iterator(jds, 16, seed=7, start_step=2)
    for _ in range(7):  # across an epoch boundary
        assert np.array_equal(next(a)["tokens"], next(b)["tokens"])
    for x, y in zip(memory.eval_batches(ds, 16), jax_memory.eval_batches(jds, 16)):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)


def test_cli_trains_two_steps_on_cpu(capsys):
    rc = cli.main(["--workload", "gpt2", "--device", "cpu", "--vocab_size", "64",
                   "--seq_len", "16", "--num_layers", "1", "--num_heads", "2", "--d_model", "32",
                   "--global_batch_size", "4", "--train_steps", "2", "--warmup_steps", "1",
                   "--log_every", "1", "--eval_every", "0", "--remat", "true"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and out["device"] == "cpu"
    assert np.isfinite(out["loss"]) and np.isfinite(out["eval_nll"])
    args = cli.build_parser().parse_args(["--fused_ce", "false", "--precision", "f32"])
    assert args.fused_ce is False and args.seq_len == 1024 and args.dropout == 0.1


def test_trainer_runs_on_cuda_unless_asked_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(gpt2.make_task(cfg), cfg.replace(device="cuda"))
    assert gpt2.Gpt2Config().device == "cuda"
    assert gpt2.Gpt2Config().fused_ce is True  # the JAX default


# Reference config fields the port has not ported yet, shrinking as they
# land (empty since pipeline parallelism): reported, not failed.
NOT_YET_PORTED = frozenset()
# Defaults that differ on purpose: the port runs on the card.
DEFAULTS_DIFFER = {"device": ("tpu", "cuda")}


@pytest.mark.parametrize("name", ["TrainConfig", "Gpt2Config", "BertGlueConfig", "Cifar10Config",
                                  "MnistConfig", "ImagenetConfig"])
def test_config_defaults_match_the_reference(name):
    """Every default the two packages' configs share is equal, field by
    field (``device`` excepted, by name); a reference field the port
    lacks is reported and is a failure only when it is not on the
    NOT_YET_PORTED list, and a listed field the port has gained must
    leave the list."""
    import dataclasses

    from tensorflow_examples_tpu.train import config as jax_config
    from tensorflow_examples_tpu.workloads import bert_glue as jax_bert_glue
    from tensorflow_examples_tpu.workloads import cifar10 as jax_cifar10
    from tensorflow_examples_tpu.workloads import imagenet as jax_imagenet
    from tensorflow_examples_tpu.workloads import mnist as jax_mnist
    from tensorflow_examples_torch.train import config as torch_config
    from tensorflow_examples_torch.workloads import bert_glue, cifar10, imagenet, mnist

    ref_cls, port_cls = {
        "TrainConfig": (jax_config.TrainConfig, torch_config.TrainConfig),
        "Gpt2Config": (jax_gpt2.Gpt2Config, gpt2.Gpt2Config),
        "BertGlueConfig": (jax_bert_glue.BertGlueConfig, bert_glue.BertGlueConfig),
        "Cifar10Config": (jax_cifar10.Cifar10Config, cifar10.Cifar10Config),
        "MnistConfig": (jax_mnist.MnistConfig, mnist.MnistConfig),
        "ImagenetConfig": (jax_imagenet.ImagenetConfig, imagenet.ImagenetConfig),
    }[name]
    ref, port = ref_cls(), port_cls()
    ref_fields = {f.name for f in dataclasses.fields(ref_cls)}
    port_fields = {f.name for f in dataclasses.fields(port_cls)}
    missing = sorted(ref_fields - port_fields)
    if missing:
        print(f"{name}: reference fields not yet in the port: {missing}")
    assert set(missing) <= NOT_YET_PORTED, sorted(set(missing) - NOT_YET_PORTED)
    assert not (NOT_YET_PORTED & port_fields), sorted(NOT_YET_PORTED & port_fields)
    assert not port_fields - ref_fields, sorted(port_fields - ref_fields)
    differ = {n: (getattr(ref, n), getattr(port, n)) for n in sorted(ref_fields & port_fields)
              if getattr(ref, n) != getattr(port, n)}
    assert differ == {k: v for k, v in DEFAULTS_DIFFER.items() if k in differ}, differ
    assert set(DEFAULTS_DIFFER) <= set(differ)


def test_gpt2_124m_shapes_on_meta():
    cfg = gpt2.Gpt2Config()
    model = transformer.GPT2(gpt2.model_config(cfg), device="meta")
    assert sum(p.numel() for p in model.parameters()) == 124_439_808
    assert (cfg.global_batch_size, cfg.seq_len, cfg.precision, cfg.dropout) == (16, 1024, "bf16",
                                                                                  0.1)


def test_port_trained_weights_carry_back_to_jax_eval(tiny_params):
    """Train 3 steps in the port, carry the params back as a numpy tree,
    and the JAX eval_fn gives the port's eval NLL."""
    jax_cfg, cfg = tiny()
    trainer = Trainer(gpt2.make_task(cfg), cfg, init_params=tiny_params)
    train_ds, eval_ds = gpt2.datasets(cfg)
    trainer.fit(memory.train_iterator(train_ds, 16, seed=0), num_steps=3)
    ours = trainer.evaluate(memory.eval_batches(eval_ds, 16))["nll"]
    tree = convert.to_param_tree(trainer.state.params)
    assert set(convert.flatten_tree(tree)) == set(convert.flatten_tree(tiny_params))
    jax_task = jax_gpt2.make_task(jax_cfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    nll, weight = 0.0, 0.0
    for batch in jax_memory.eval_batches(eval_ds, 16):
        m = jax_task.eval_fn(jparams, {}, jax.tree.map(jnp.asarray, batch))
        nll += float(m["nll"]) * float(m["weight"])
        weight += float(m["weight"])
    np.testing.assert_allclose(ours, nll / weight, rtol=1e-5)
    assert abs(ours - trainer.evaluate(memory.eval_batches(eval_ds, 16))["nll"]) == 0
    module = convert.model_from_params(gpt2.model_config(cfg), tree)
    assert torch.equal(module.wte.embedding, trainer.state.params["wte.embedding"])
