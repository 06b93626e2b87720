"""BERT GLUE fine-tuning in the port against the JAX package (PyTorch/CUDA port).

At ``tests/test_bert.py``'s tiny widths (2 layers, d 16, 2 heads, d_ff
32, seq 32), f32 and dropout 0, the same flax params and inputs go
through both packages:

* ``BertClassifier`` logits within 2e-4 and every gradient within 5e-4
  of flax's, on both attention paths (the plain softmax and the flash
  kernels non-causal with the padding mask as their key bias; the JAX
  flash path runs its Pallas kernels in interpret mode, as its own tests
  do), on ragged masks;
* ``import_bert`` from a random ``transformers``
  ``BertForSequenceClassification`` saved to a directory (safetensors and
  ``pytorch_model.bin``) equal to the JAX import, and the port's logits
  on it equal to HF's;
* 5-step ``bert_glue`` trajectories (SST-2 and the STS-B regression
  head) against the JAX ``Trainer`` at rtol 3e-3;
* the eval means and ``eval_finalize``'s MCC, F1 and Pearson against
  the JAX ``Trainer.evaluate``, and the GLUE metric functions directly;
* the CLI: ``--workload bert_glue --device cpu`` trains, checkpoints and
  evaluates, and a ``pretrained`` directory keeps a fresh head when its
  own does not fit the task.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.data import memory as jax_memory
from tensorflow_examples_tpu.models import bert as jax_bert
from tensorflow_examples_tpu.models import hf_import as jax_hf
from tensorflow_examples_tpu.ops import glue_metrics as jax_glue
from tensorflow_examples_tpu.sharding import ShardingConfig
from tensorflow_examples_tpu.train import loop as jax_loop
from tensorflow_examples_tpu.workloads import bert_glue as jax_bert_glue
from tensorflow_examples_torch.data import memory
from tensorflow_examples_torch.models import bert, convert, hf_import
from tensorflow_examples_torch.models.transformer import ParamView
from tensorflow_examples_torch.ops import glue_metrics
from tensorflow_examples_torch.train import cli
from tensorflow_examples_torch.train import eval as eval_cli
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.workloads import bert_glue


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODEL = dict(vocab_size=50, max_len=32, num_layers=2, num_heads=2, d_model=16, d_ff=32,
             dropout=0.0)


def tiny(**kw):
    """``tests/test_bert.py``'s tiny_cfg at seq 32, as (JAX, port) configs."""
    base = dict(task="sst2", seq_len=32, vocab_size=120, num_layers=2, num_heads=2, d_model=16,
                d_ff=32, dropout=0.0, global_batch_size=16, train_steps=40, warmup_steps=4,
                learning_rate=3e-4, log_every=1, eval_every=0, precision="f32")
    base.update(kw)
    return (jax_bert_glue.BertGlueConfig(checkpoint_every=0, **base),
            bert_glue.BertGlueConfig(device="cpu", telemetry_sinks="", **base))


def jax_trainer(cfg):
    sc = ShardingConfig(mesh={"data": 1})
    mesh = sc.build_mesh()
    return jax_loop.Trainer(jax_bert_glue.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree):
    return {k.replace("/", "."): torch.tensor(v) for k, v in convert.flatten_tree(tree).items()}


def ragged_inputs(seed=1, b=3, s=32, lengths=(32, 20, 7)):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 50, (b, s)).astype(np.int32)
    mask = (np.arange(s)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    types = (np.arange(s)[None] >= np.asarray(lengths)[:, None] // 2).astype(np.int32) * mask
    return tokens, mask, types


@pytest.fixture(scope="module")
def tiny_params():
    model = jax_bert.BertClassifier(jax_bert.BertConfig(**MODEL), num_labels=2)
    params = model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32), jnp.int32))
    return numpy_tree(params["params"])


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_logits_and_every_grad_match_flax(tiny_params, impl):
    tokens, mask, types = ragged_inputs()
    jm = jax_bert.BertClassifier(jax_bert.BertConfig(**MODEL, attention=impl), num_labels=2)
    args = tuple(jnp.asarray(x) for x in (tokens, mask, types))
    loss = lambda p: jnp.sum(jm.apply({"params": p}, *args) ** 2)
    theirs = jm.apply({"params": tiny_params}, *args)
    j_grads = jax.grad(loss)(jax.tree.map(jnp.asarray, tiny_params))

    cfg = bert.BertConfig(**MODEL, attention=impl)
    leaves = {k: v.requires_grad_() for k, v in flat(tiny_params).items()}
    ours = bert.forward(cfg, ParamView(leaves), *(torch.from_numpy(x) for x in
                                                  (tokens, mask, types)))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (3, 2)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), atol=2e-4, rtol=2e-4)
    grads = dict(zip(leaves, torch.autograd.grad((ours ** 2).sum(), list(leaves.values()))))
    for path, g in convert.flatten_tree(numpy_tree(j_grads)).items():
        np.testing.assert_allclose(grads[path.replace("/", ".")].numpy(), g, atol=5e-4,
                                   rtol=5e-4, err_msg=path)


def test_padded_keys_do_not_move_the_logits(tiny_params):
    """Tokens past a row's length change nothing, on both paths."""
    tokens, mask, types = ragged_inputs()
    other = tokens.copy()
    other[1, 25] = 7
    other[2, 10:] = 3
    for impl in ("xla", "flash"):
        cfg = bert.BertConfig(**MODEL, attention=impl)
        run = lambda t: bert.forward(cfg, ParamView(flat(tiny_params)), torch.from_numpy(t),
                                     torch.from_numpy(mask), torch.from_numpy(types))
        np.testing.assert_allclose(run(tokens).numpy(), run(other).numpy(), atol=1e-6)


def test_module_init_has_the_reference_tree():
    cfg = bert.BertConfig(**MODEL)
    ours = {k: tuple(p.shape) for k, p in bert.BertClassifier(cfg, 3, seed=0).named_parameters()}
    jm = jax_bert.BertClassifier(jax_bert.BertConfig(**MODEL), num_labels=3)
    tree = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32))["params"]
    theirs = {k.replace("/", "."): tuple(np.shape(v))
              for k, v in convert.flatten_tree(numpy_tree(tree)).items()}
    assert ours == theirs
    meta = bert.BertClassifier(bert.bert_base(), 2, device="meta")
    assert sum(p.numel() for p in meta.parameters()) == 109_483_778
    with pytest.raises(ValueError, match="attention"):
        bert.BertConfig(attention="ring")


# ------------------------------------------------------------- hf import


def _hf_bert(tmp_path, safe: bool):
    transformers = pytest.importorskip("transformers")
    config = transformers.BertConfig(vocab_size=60, hidden_size=16, num_hidden_layers=2,
                                     num_attention_heads=2, intermediate_size=32,
                                     max_position_embeddings=512, num_labels=2)
    torch.manual_seed(0)
    model = transformers.BertForSequenceClassification(config).eval()
    model.save_pretrained(tmp_path, safe_serialization=safe)
    return model


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
def test_import_bert_equals_the_jax_import_and_hf_logits(tmp_path, safe):
    hf = _hf_bert(tmp_path, safe)
    cfg, params = hf_import.import_bert(str(tmp_path))
    j_cfg, j_params = jax_hf.import_bert(hf)
    assert (cfg.vocab_size, cfg.max_len, cfg.num_layers, cfg.num_heads, cfg.d_model, cfg.d_ff,
            cfg.layer_norm_eps) == (j_cfg.vocab_size, j_cfg.max_len, j_cfg.num_layers,
                                    j_cfg.num_heads, j_cfg.d_model, j_cfg.d_ff,
                                    j_cfg.layer_norm_eps)
    ours, theirs = convert.flatten_tree(params), convert.flatten_tree(numpy_tree(j_params))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert np.array_equal(ours[k], theirs[k]), k
    assert convert.flatten_tree(hf_import.import_bert(hf)[1]).keys() == ours.keys()
    tokens, mask, types = ragged_inputs(b=2, s=24, lengths=(24, 9))
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(tokens).long(), attention_mask=torch.from_numpy(mask),
                  token_type_ids=torch.from_numpy(types).long()).logits
    model = convert.load_params(bert.BertClassifier(cfg, 2, device="meta").to_empty(device="cpu"),
                                params)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), torch.from_numpy(mask), torch.from_numpy(types))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_pretrained_keeps_a_fresh_head_when_its_own_does_not_fit(tmp_path):
    hf = _hf_bert(tmp_path, True)
    _, cfg = tiny(vocab_size=60, task="mnli")  # 3 labels against the checkpoint's 2
    cfg = cfg.replace(pretrained=str(tmp_path))
    fresh = bert_glue.make_task(cfg.replace(pretrained="")).init_fn(cfg.seed, torch.device("cpu"))
    got = bert_glue.make_task(cfg).init_fn(cfg.seed, torch.device("cpu"))["params"]
    assert torch.equal(got["classifier.kernel"], fresh["params"]["classifier.kernel"])
    want = hf.state_dict()["bert.encoder.layer.1.output.dense.weight"].T
    assert torch.equal(got["bert.layer_1.ffn_out.kernel"], want)
    same = bert_glue.make_task(cfg.replace(task="sst2")).init_fn(0, torch.device("cpu"))["params"]
    assert torch.equal(same["classifier.kernel"], hf.state_dict()["classifier.weight"].T)


# ------------------------------------------------------------- training


@pytest.mark.parametrize("task", ["sst2", "stsb"])
def test_five_step_trajectory_matches_jax_trainer(task):
    jax_cfg, cfg = tiny(task=task)
    jt = jax_trainer(jax_cfg)
    init = numpy_tree(jt.state.params)
    train_ds, _ = jax_bert_glue.datasets(jax_cfg)
    it = jax_memory.train_iterator(train_ds, 16, seed=0)
    state, theirs = jt.state, []
    for _ in range(5):
        state, metrics = jt._train_step(state, jt._put_batch(next(it)))
        theirs.append(float(metrics["loss"]))
    trainer = Trainer(bert_glue.make_task(cfg), cfg, init_params=init)
    ours_ds, _ = bert_glue.datasets(cfg)
    trainer.fit(memory.train_iterator(ours_ds, 16, seed=0), num_steps=5)
    ours = [h["loss"] for h in trainer.history]
    assert len(ours) == 5 and ours[-1] < ours[0]
    np.testing.assert_allclose(ours, theirs, rtol=3e-3, atol=0)
    if task == "sst2":
        assert "accuracy" in trainer.history[0]


@pytest.mark.parametrize("task,score", [("cola", "mcc"), ("mrpc", "f1"), ("stsb", "pearson"),
                                        ("mnli", None)])
def test_eval_finalize_matches_jax_evaluate(task, score):
    jax_cfg, cfg = tiny(task=task)
    jt = jax_trainer(jax_cfg)
    init = numpy_tree(jt.state.params)
    _, eval_ds = jax_bert_glue.datasets(jax_cfg)
    theirs = jt.evaluate(jax_memory.eval_batches(eval_ds, 48))  # 256 rows: a padded last batch
    trainer = Trainer(bert_glue.make_task(cfg), cfg, init_params=init)
    ours = trainer.evaluate(memory.eval_batches(bert_glue.eval_dataset(cfg), 48))
    assert ours.keys() == theirs.keys()
    if score is not None:
        assert score in ours
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_glue_metric_functions_match_jax():
    rng = np.random.default_rng(3)
    preds, labels = rng.integers(0, 2, 64), rng.integers(0, 2, 64)
    w = (rng.random(64) > 0.2).astype(np.float32)
    ours = glue_metrics.confusion_rates(torch.from_numpy(preds), torch.from_numpy(labels),
                                        torch.from_numpy(w))
    theirs = jax_glue.confusion_rates(jnp.asarray(preds), jnp.asarray(labels), jnp.asarray(w))
    means = {k: float(v) for k, v in ours.items()}
    for k in ours:
        np.testing.assert_allclose(means[k], float(theirs[k]), rtol=1e-6)
    assert glue_metrics.mcc_from_rates(means) == pytest.approx(jax_glue.mcc_from_rates(means))
    assert glue_metrics.f1_from_rates(means) == pytest.approx(jax_glue.f1_from_rates(means))
    x, y = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    m = {k: float(v) for k, v in glue_metrics.moment_means(torch.from_numpy(x),
                                                          torch.from_numpy(x + y), None).items()}
    jm = jax_glue.moment_means(jnp.asarray(x), jnp.asarray(x + y), None)
    for k in m:
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-5, atol=1e-7)
    assert glue_metrics.pearson_from_moments(m) == pytest.approx(
        np.corrcoef(x, x + y)[0, 1], rel=1e-4)
    zero = {"tp": 0.0, "fp": 0.0, "fn": 0.0, "tn": 1.0, "x": 1.0, "y": 1.0, "xx": 1.0,
            "yy": 1.0, "xy": 1.0}
    assert glue_metrics.mcc_from_rates(zero) == glue_metrics.f1_from_rates(zero) == 0.0
    assert glue_metrics.pearson_from_moments(zero) == 0.0


def test_config_flags_and_cli_train_then_eval(tmp_path, capsys):
    args = cli.build_parser("bert_glue").parse_args(["--task", "cola", "--attention", "flash"])
    assert (args.task, args.attention, args.seq_len, args.learning_rate) == ("cola", "flash",
                                                                             128, 2e-5)
    model = ["--workload", "bert_glue", "--device", "cpu", "--task", "cola", "--seq_len", "16",
             "--vocab_size", "120", "--num_layers", "1", "--num_heads", "2", "--d_model", "16",
             "--d_ff", "32", "--workdir", str(tmp_path), "--telemetry_sinks", ""]
    assert cli.main(model + ["--global_batch_size", "8", "--train_steps", "2",
                             "--warmup_steps", "1", "--log_every", "1", "--eval_every", "0",
                             "--attention", "flash"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and out["workload"] == "bert_glue"
    assert {"eval_mcc", "eval_accuracy", "eval_loss"} <= out.keys()
    assert not {"eval_tp", "eval_fp"} & out.keys()
    assert eval_cli.main(model) == 0
    evaluated = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert evaluated["step"] == 2
    assert evaluated["eval_mcc"] == pytest.approx(out["eval_mcc"], abs=1e-6)
