"""Pretrained GPT-2 weights and ``remat_policy`` in the port (PyTorch/CUDA
port). A random-init HF ``GPT2LMHeadModel`` built from a ``GPT2Config``
in the test (no download, as ``tests/test_transformer.py`` does) goes
through the port's ``import_gpt2`` and the reference's: the trees are
equal and the port's logits equal HF's; the same model saved with
``save_pretrained`` loads from its directory without ``transformers``,
and ``export_gpt2`` writes a directory HF loads back. Every remat policy
gives no-remat's gradients.
"""

import numpy as np
import pytest
import torch
from transformers import GPT2Config, GPT2LMHeadModel

from tensorflow_examples_tpu.models import hf_import as jax_hf_import
from tensorflow_examples_torch.core import rng
from tensorflow_examples_torch.models import convert, hf_import, transformer
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.workloads import gpt2

WIDTHS = dict(vocab_size=64, n_positions=16, n_embd=32, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def hf_model():
    torch.manual_seed(0)
    return GPT2LMHeadModel(GPT2Config(**WIDTHS)).eval()


@pytest.fixture(scope="module")
def saved(hf_model, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hf_gpt2"))
    hf_model.save_pretrained(path)
    return path


def _logits(cfg, tree, tokens):
    model = convert.model_from_params(cfg, tree)
    with torch.no_grad():
        return transformer.forward(cfg, model, tokens)


def test_import_matches_the_reference_and_hf_logits(hf_model):
    cfg, tree = hf_import.import_gpt2(hf_model)
    jcfg, jtree = jax_hf_import.import_gpt2(hf_model)
    assert (cfg.vocab_size, cfg.max_len, cfg.num_layers, cfg.num_heads, cfg.d_model) == (
        jcfg.vocab_size, jcfg.max_len, jcfg.num_layers, jcfg.num_heads, jcfg.d_model)
    ours, theirs = convert.flatten_tree(tree), convert.flatten_tree(jtree)
    assert ours.keys() == theirs.keys()
    assert all(np.array_equal(ours[k], theirs[k]) for k in ours)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 16)))
    with torch.no_grad():
        ref = hf_model(tokens).logits
    torch.testing.assert_close(_logits(cfg, tree, tokens), ref, atol=1e-5, rtol=1e-5)


def test_directory_round_trips(hf_model, saved, tmp_path):
    _, want = hf_import.import_gpt2(hf_model)
    cfg, got = hf_import.import_gpt2(saved)  # safetensors, read without transformers
    flat_w, flat_g = convert.flatten_tree(want), convert.flatten_tree(got)
    assert all(np.array_equal(flat_w[k], flat_g[k]) for k in flat_w)
    out = str(tmp_path / "exported")
    hf_import.export_gpt2(got, cfg, out)
    back = GPT2LMHeadModel.from_pretrained(out).eval()
    tokens = torch.arange(16)[None] % 64
    with torch.no_grad():
        torch.testing.assert_close(back(tokens).logits, hf_model(tokens).logits, atol=0, rtol=0)
    torch.save(hf_model.state_dict(), str(tmp_path / "pytorch_model.bin"))
    (tmp_path / "config.json").write_text(open(f"{saved}/config.json").read())
    _, from_bin = hf_import.import_gpt2(str(tmp_path))
    assert all(np.array_equal(flat_w[k], v) for k, v in convert.flatten_tree(from_bin).items())


def test_pretrained_replaces_the_init(hf_model, saved):
    cfg = gpt2.Gpt2Config(device="cpu", vocab_size=64, seq_len=16, num_layers=2, num_heads=4,
                          d_model=32, pretrained=saved, precision="f32")
    trainer = Trainer(gpt2.make_task(cfg), cfg)
    _, tree = hf_import.import_gpt2(hf_model)
    for k, v in convert.flatten_tree(tree).items():
        assert np.array_equal(trainer.state.params[k.replace("/", ".")].numpy(), v), k
    with pytest.raises(ValueError, match="pretrained="):
        gpt2.make_task(cfg.replace(num_layers=3)).init_fn(0, torch.device("cpu"))


@pytest.mark.parametrize("policy", ["none", "dots", "dots_no_batch"])
@pytest.mark.parametrize("attention", ["flash", "xla"])
def test_remat_policy_gives_no_remat_grads(policy, attention):
    cfg = gpt2.Gpt2Config(device="cpu", vocab_size=64, seq_len=16, num_layers=2, num_heads=2,
                          d_model=32, dropout=0.1, attention=attention, precision="f32")
    grads = []
    for remat in (False, True):
        c = cfg.replace(remat=remat, remat_policy=policy)
        trainer = Trainer(gpt2.make_task(c), c)
        tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (4, 17)))
        leaves = {k: p.detach().requires_grad_() for k, p in trainer.state.params.items()}
        loss, _, _ = trainer.task.loss_fn(leaves, {}, {"tokens": tokens},
                                          rng=rng.StepNoise(trainer.step_key(0)),
                                          train=True)
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_remat_policy_is_validated():
    with pytest.raises(ValueError, match="remat_policy='everything'"):
        gpt2.model_config(gpt2.Gpt2Config(remat_policy="everything"))
