"""The port's GPT-2 module and weight bridge against the JAX model
(PyTorch/CUDA port).

Weights come from a flax init of the smoke model
(``tools/serve_bench.SMOKE_MODEL``: vocab 211, d 32, 2 layers, 2 heads,
max_len 64), handed to the port as nested dicts of numpy arrays; logits
of the port's ``forward_full`` must match the JAX engine's at atol 1e-5.

Decoding: ``core/rng.split`` equals ``jax.random.split`` bit for bit;
the port's ``generate`` gives the JAX ``transformer.generate``'s greedy
stream token for token (flash-decode through the plain version on the
CPU, the Pallas kernel in interpret mode on the JAX side), and its
sampled stream (temperature 0.8, top_k 5, the same key) may part from
the JAX one only at a near-tie: where the two best Gumbel-perturbed
scores are within 1e-4 (XLA's CPU ``log`` is not correctly rounded).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.models import transformer as jax_transformer
from tensorflow_examples_tpu.serving import engine as jax_engine
from tensorflow_examples_torch import generate as generate_cli
from tensorflow_examples_torch.core import rng
from tensorflow_examples_torch.models import convert, transformer
from tensorflow_examples_torch.serving import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import serve_bench  # noqa: E402 — needs the tools path above


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run beside timing-sensitive
    serving tests in other workers and must not starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_cfgs():
    jax_cfg = jax_transformer.TransformerConfig(**serve_bench.SMOKE_MODEL)
    keys = ("vocab_size", "max_len", "num_layers", "num_heads", "d_model")
    return jax_cfg, transformer.TransformerConfig(**{k: getattr(jax_cfg, k) for k in keys})


@pytest.fixture(scope="module")
def flax_params():
    jax_cfg, _ = smoke_cfgs()
    params = jax_transformer.Transformer(jax_cfg).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 8), jnp.int32)
    )["params"]
    return jax.tree.map(np.asarray, params)


def test_param_count_gpt2_124m_on_meta():
    model = transformer.GPT2(transformer.gpt2_124m(), device="meta")
    assert sum(p.numel() for p in model.parameters()) == 124_439_808


def test_state_dict_paths_and_layouts_are_the_jax_tree(flax_params):
    _, cfg = smoke_cfgs()
    ours = {k.replace(".", "/"): tuple(t.shape)
            for k, t in transformer.GPT2(cfg, device="meta").state_dict().items()}
    theirs = {k: v.shape for k, v in convert.flatten_tree(flax_params).items()}
    assert ours == theirs
    assert ours["h_0/attn/qkv/kernel"] == (32, 3, 2, 16)
    assert ours["h_0/attn/proj/kernel"] == (2, 16, 32)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_full_matches_jax_engine(flax_params, impl):
    """Logits and the per-layer K/V a prefill writes, through the weight
    bridge; ``flash`` runs the JAX Pallas kernel in interpret mode and the
    port's kernel wrapper (its plain version on the CPU)."""
    jax_cfg, cfg = smoke_cfgs()
    model = convert.model_from_params(cfg, flax_params)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 48))
    j_logits, j_ks, j_vs = jax_engine.forward_full(
        jax_cfg, jax.tree.map(jnp.asarray, flax_params), jnp.asarray(tokens, jnp.int32),
        impl=impl,
    )
    with torch.no_grad():
        logits, ks, vs = engine.forward_full(model, torch.from_numpy(tokens), impl=impl)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ks.numpy(), np.asarray(j_ks), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(vs.numpy(), np.asarray(j_vs), atol=1e-5, rtol=1e-5)


def test_module_forward_matches_flax_apply(flax_params):
    jax_cfg, cfg = smoke_cfgs()
    model = convert.model_from_params(cfg, flax_params)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 30))
    ref = jax_transformer.Transformer(jax_cfg).apply(
        {"params": flax_params}, jnp.asarray(tokens, jnp.int32)
    )
    with torch.no_grad():
        ours = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_npz_round_trip(flax_params, tmp_path):
    _, cfg = smoke_cfgs()
    path = tmp_path / "params.npz"
    convert.save_npz(str(path), flax_params)
    flat = convert.load_npz(str(path))
    assert all("/" in k for k in flat)
    a = convert.model_from_params(cfg, flax_params).state_dict()
    b = convert.model_from_params(cfg, flat).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_bridge_names_missing_and_misshapen_paths(flax_params):
    _, cfg = smoke_cfgs()
    flat = convert.flatten_tree(flax_params)
    flat.pop("h_1/ln_2/scale")
    with pytest.raises(ValueError, match="h_1/ln_2/scale"):
        convert.model_from_params(cfg, flat)
    flat = convert.flatten_tree(flax_params)
    flat["wpe/embedding"] = flat["wpe/embedding"][:10]
    with pytest.raises(ValueError, match="wpe/embedding"):
        convert.model_from_params(cfg, flat)


def test_random_init_follows_the_reference_scheme():
    cfg = transformer.TransformerConfig(vocab_size=4000, max_len=512, num_layers=4,
                                        num_heads=4, d_model=128)
    m = transformer.GPT2(cfg, seed=3)
    std = lambda t: float(t.detach().std())
    assert std(m.wte.embedding) == pytest.approx(0.02, rel=0.02)
    assert std(m.wpe.embedding) == pytest.approx(0.01, rel=0.02)
    assert std(m.h_0.mlp_fc.kernel) == pytest.approx(0.02, rel=0.02)
    for t in (m.h_2.attn.proj.kernel, m.h_2.mlp_proj.kernel):
        assert std(t) == pytest.approx(0.02 / (2 * cfg.num_layers) ** 0.5, rel=0.05)
    assert float(m.h_1.attn.qkv.bias.detach().abs().max()) == 0.0
    assert torch.equal(m.ln_f.scale, torch.ones(cfg.d_model))
    again = transformer.GPT2(cfg, seed=3)
    other = transformer.GPT2(cfg, seed=4)
    assert torch.equal(m.h_3.attn.qkv.kernel, again.h_3.attn.qkv.kernel)
    assert not torch.equal(m.h_3.attn.qkv.kernel, other.h_3.attn.qkv.kernel)


# ---------------------------------------------------------------- decoding

NEAR_TIE = 1e-4


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_rng_split_matches_jax_bit_for_bit(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    for num in (1, 2, 3, 31, 1000):
        assert np.array_equal(rng.split(np.asarray(key), num),
                              np.asarray(jax.random.split(key, num)))
    assert np.array_equal(rng.split(rng.PRNGKey(seed)), np.asarray(
        jax.random.split(jax.random.PRNGKey(seed))))


def _generate_both(flax_params, impl, temperature, top_k, num_tokens=12):
    jax_cfg, cfg = smoke_cfgs()
    jax_cfg = dataclasses.replace(jax_cfg, attention=impl)
    cfg = dataclasses.replace(cfg, attention=impl)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 10))
    theirs = np.asarray(jax_transformer.generate(
        jax_transformer.Transformer(jax_cfg), jax.tree.map(jnp.asarray, flax_params),
        jnp.asarray(prompt, jnp.int32), num_tokens=num_tokens, rng=jax.random.PRNGKey(3),
        temperature=temperature, top_k=top_k))
    model = convert.model_from_params(cfg, flax_params)
    ours = transformer.generate(cfg, model, torch.from_numpy(prompt), num_tokens=num_tokens,
                                key=rng.PRNGKey(3), temperature=temperature, top_k=top_k)
    return cfg, model, prompt, ours.numpy(), theirs


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_greedy_generate_matches_jax(flax_params, impl):
    _, _, prompt, ours, theirs = _generate_both(flax_params, impl, 0.0, 0)
    assert ours.shape == (2, 22) and np.array_equal(ours[:, :10], prompt)
    assert np.array_equal(ours, theirs)


def test_sampled_generate_matches_jax_up_to_near_ties(flax_params):
    temp, top_k, n = 0.8, 5, 12
    cfg, model, prompt, ours, theirs = _generate_both(flax_params, "xla", temp, top_k, n)
    key, first = rng.split(rng.PRNGKey(3))
    keys = [first, *rng.split(key, n - 1)]
    for b in range(2):
        diff = np.nonzero(ours[b, 10:] != theirs[b, 10:])[0]
        if not len(diff):
            continue
        i = int(diff[0])
        with torch.no_grad():
            logits = model(torch.from_numpy(theirs[b:b + 1, :10 + i]))[0, -1].float() / temp
        kth = torch.sort(logits).values[-top_k]
        logits = torch.where(logits < kth, -1e30, logits)
        scores = rng.gumbel(keys[i], (2, cfg.vocab_size))[b] + logits
        top2 = torch.topk(scores, 2).values
        assert float(top2[0] - top2[1]) < NEAR_TIE, (b, i, ours[b], theirs[b])
    assert len(set(ours[0, 10:].tolist())) > 1  # sampling, not a constant


def test_generate_rejects_a_stream_past_max_len(flax_params):
    _, cfg = smoke_cfgs()
    model = convert.model_from_params(cfg, flax_params)
    with pytest.raises(ValueError, match="exceeds max_len"):
        transformer.generate(cfg, model, torch.zeros(1, 60, dtype=torch.long), num_tokens=5,
                             key=rng.PRNGKey(0), temperature=0.0)


def test_generate_cli_and_serve_restore_the_checkpoint(tmp_path, capsys):
    """Train two steps into a workdir through the training CLI; the
    generate CLI's stream equals ``generate`` on the restored params, and
    ``serve --workdir`` restores the same params."""
    from tensorflow_examples_torch import serve
    from tensorflow_examples_torch.train import cli
    from tensorflow_examples_torch.workloads import gpt2

    flags = ["--device", "cpu", "--vocab_size", "256", "--seq_len", "32", "--num_layers", "1",
             "--num_heads", "2", "--d_model", "32", "--workdir", str(tmp_path)]
    assert cli.main(flags + ["--global_batch_size", "4", "--train_steps", "2",
                             "--warmup_steps", "1", "--log_every", "1", "--eval_every", "0"]) == 0
    capsys.readouterr()
    assert generate_cli.main(flags + ["--prompt", "the ", "--num_tokens", "6",
                                      "--temperature", "0"]) == 0
    out = capsys.readouterr().out.splitlines()
    toks = [int(t) for t in out[0].split(":", 1)[1].strip(" []").split(",")]
    cfg = gpt2.Gpt2Config(device="cpu", vocab_size=256, seq_len=32, num_layers=1, num_heads=2,
                          d_model=32, workdir=str(tmp_path))
    model, step = generate_cli.restore_model(gpt2.model_config(cfg), str(tmp_path), "cpu")
    want = transformer.generate(gpt2.model_config(cfg), model,
                                torch.tensor([list(b"the ")]), num_tokens=6,
                                key=rng.PRNGKey(cfg.seed), temperature=0.0)
    assert step == 2 and toks == want[0].tolist() and len(out) == 2
    with pytest.raises(SystemExit):
        generate_cli.main(flags[:-2])  # no --workdir: a usage error
    args = serve.build_parser().parse_args(["--workdir", str(tmp_path)])
    assert args.workdir == str(tmp_path)
    with pytest.raises(SystemExit):
        serve.build_parser().parse_args(["--workdir", "a", "--params_npz", "b"])
