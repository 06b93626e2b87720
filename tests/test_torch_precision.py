"""The port's precision registry and quantized serving against the JAX
package (PyTorch/CUDA port).

* int8 and fp8 ``quantize_rows`` (the device path and the load-time host
  path) give ``q`` bytes and ``scale`` bit-identical to the JAX package's;
* ``quantize_tree`` quantizes the same paths, with the same bytes, and
  ``tree_precision_stats`` gives the same numbers;
* a ``precision.json`` written by either package loads in the other;
* at the smoke model with the same flax-initialized weights, a
  weight-int8 engine's prefill and decode logits are within atol 1e-5 of
  the JAX weight-int8 engine's (f32), its ``byte_breakdown`` and
  ``precision_stats`` equal the JAX engine's, and fp8 KV (with f32 and
  with fp8 weights) gives the JAX engine's first token.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.core import precision as jax_precision
from tensorflow_examples_tpu.models import transformer as jax_transformer
from tensorflow_examples_tpu.serving import engine as jax_engine
from tensorflow_examples_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from tensorflow_examples_torch.core import precision
from tensorflow_examples_torch.models import transformer
from tensorflow_examples_torch.serving import paged_kv
from tensorflow_examples_torch.serving.batcher import ContinuousBatcher
from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
from tensorflow_examples_torch.telemetry.registry import MetricsRegistry
from tensorflow_examples_torch.telemetry.schema import SERVING_KEYS_V8, SERVING_KEYS_V11

SMOKE = dict(vocab_size=211, max_len=64, num_layers=2, num_heads=2, d_model=32)
BASE = dict(max_slots=4, prefill_bucket_floor=16, kv_bucket_floor=32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flax_params():
    cfg = jax_transformer.TransformerConfig(**SMOKE, dropout=0.0, attention="xla")
    params = jax_transformer.Transformer(cfg).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def port(params, **kw):
    return InferenceEngine(transformer.TransformerConfig(**SMOKE), params,
                           cfg=ServeConfig(**BASE, **kw), registry=MetricsRegistry(),
                           device="cpu")


def jax_eng(params, **kw):
    cfg = jax_transformer.TransformerConfig(**SMOKE, dropout=0.0, attention="xla")
    return jax_engine.InferenceEngine(cfg, jax.tree.map(jnp.asarray, params),
                                      cfg=jax_engine.ServeConfig(**BASE, **kw),
                                      registry=JaxRegistry())


def _rows(seed):
    """Rows across magnitudes, a zero row and exact ties at the rounding
    boundary of the int8 grid."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((300, 64)) * rng.uniform(1e-3, 1e2, (300, 1))
    x[7] = 0.0
    x[8, :3] = [127.0, 0.5, -0.5]
    return x.astype(np.float32)


def _bytes(t):
    """A one-byte payload's bytes (torch int8/fp8 or their numpy twins)."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_quantize_rows_bit_identical_to_jax(name):
    x = _rows(1)
    jdt = jnp.int8 if name == "int8" else jax_precision.fp8_dtype()
    jq, js = jax_precision.quantize_rows(jnp.asarray(x), jdt)
    q, s = precision.quantize_rows(torch.from_numpy(x), precision.store_dtype(name))
    np.testing.assert_array_equal(_bytes(q), _bytes(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    hq, hs = jax_precision._quantize_rows_host(x, name)
    pq, ps = precision.quantize_rows_host(x, name)
    np.testing.assert_array_equal(_bytes(pq), _bytes(hq))
    np.testing.assert_array_equal(ps.numpy(), hs)
    np.testing.assert_array_equal(precision.dequantize_rows(q, s).numpy(),
                                  np.asarray(jax_precision.dequantize_rows(jq, js)))


@pytest.mark.parametrize("cfg_name", ["int8", "fp8", "mixed"])
def test_quantize_tree_and_stats_match_jax(flax_params, cfg_name):
    config = {
        "int8": dict(rules=tuple((p, "int8") for p in precision.WEIGHT_PATTERNS)),
        "fp8": dict(rules=tuple((p, "fp8") for p in precision.WEIGHT_PATTERNS)),
        "mixed": dict(rules=(("^wte/", ""), ("mlp_fc", "bf16"), ("/kernel$", "fp8")),
                      default="int8"),
    }[cfg_name]
    ours = precision.quantize_tree(flax_params, precision.PrecisionConfig(**config))
    theirs = jax_precision.quantize_tree(flax_params, jax_precision.PrecisionConfig(**config))
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            theirs, is_leaf=lambda x: isinstance(x, jax_precision.QuantizedWeight))[0]:
        flat["/".join(str(p.key) for p in path)] = leaf
    assert sorted(ours) == sorted(flat)
    quantized = sorted(p for p, leaf in ours.items() if isinstance(leaf, precision.QuantizedWeight))
    assert quantized == sorted(p for p, leaf in flat.items()
                               if isinstance(leaf, jax_precision.QuantizedWeight))
    assert quantized, "the config quantized nothing"
    for path, leaf in ours.items():
        if isinstance(leaf, precision.QuantizedWeight):
            np.testing.assert_array_equal(_bytes(leaf.q), _bytes(flat[path].q))
            np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(flat[path].scale))
        else:
            assert str(leaf.dtype).split(".")[-1] == np.asarray(flat[path]).dtype.name, path
    assert precision.tree_precision_stats(ours) == jax_precision.tree_precision_stats(theirs)


def test_precision_json_loads_across_packages(tmp_path):
    configs = [precision.PrecisionConfig.weight_only("int8", kv_dtype="fp8"),
               precision.PrecisionConfig(rules=(("h_0/", ""), ("/kernel$", "fp8")),
                                         default="bf16", kv_dtype="int8")]
    for i, ours in enumerate(configs):
        path = str(tmp_path / f"ours{i}.json")
        ours.save(path)
        theirs = jax_precision.PrecisionConfig.load(path)
        assert theirs.to_json_dict() == ours.to_json_dict()
        back = str(tmp_path / f"theirs{i}.json")
        theirs.save(back)
        assert precision.PrecisionConfig.load(back) == ours
        assert open(path).read() == open(back).read()
        assert [ours.dtype_for(p) for p in ("wte/embedding", "h_0/attn/qkv/kernel", "ln_f/scale")] \
            == [theirs.dtype_for(p) for p in ("wte/embedding", "h_0/attn/qkv/kernel", "ln_f/scale")]
        assert ours.quantizes == theirs.quantizes
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"rules": [["/kernel$", "int8"]]}))
    assert precision.PrecisionConfig.load(str(bare)).rules == (("/kernel$", "int8"),)
    for bad in ({"rules": [["x"]]}, {"rules": [], "bogus": 1}, {"default": "int4"}, []):
        with pytest.raises(ValueError):
            precision.PrecisionConfig.from_json_dict(bad)
    with pytest.raises(ValueError, match="weight dtype"):
        precision.PrecisionConfig.weight_only("bf16")


@pytest.fixture(scope="module")
def int8_engines(flax_params):
    return port(flax_params, weight_dtype="int8"), jax_eng(flax_params, weight_dtype="int8")


def test_weight_int8_logits_match_jax(int8_engines):
    """Prefill and two decode steps of three requests: logits within 1e-5
    of the JAX weight-int8 engine's (both dequantize in the matmul)."""
    ours, theirs = int8_engines
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(0, 211, n)] for n in (4, 18, 33)]
    toks = {}
    for eng, label in ((ours, "port"), (theirs, "jax")):
        slots, logits = [], []
        for p in prompts:
            slot = eng.pool.alloc()
            tok, last = eng.prefill(slot, p)
            slots.append(slot)
            logits.append(np.asarray(last))
        toks[label] = [eng.decode([(s, 3, 0, 0.0, 0) for s in slots])]
        toks[label].append(eng.decode([(s, toks[label][0][s], 0, 0.0, 0) for s in slots]))
        toks[label + "_logits"] = logits
        for s in slots:
            eng.pool.free(s)
    np.testing.assert_allclose(np.stack(toks["port_logits"]), np.stack(toks["jax_logits"]),
                               atol=1e-5, rtol=0)
    assert toks["port"] == toks["jax"]
    # The cacheless reference reads the same dequantized weights.
    np.testing.assert_allclose(ours.reference_logits(prompts[1]).numpy(), toks["port_logits"][1],
                               atol=1e-5, rtol=0)


def test_byte_breakdown_and_precision_stats_match_jax(int8_engines, flax_params):
    ours, theirs = int8_engines
    assert ours.precision_stats() == theirs.precision_stats()
    assert ours.precision_stats()["weight_bits"] == 8
    mine, ref = ours.byte_breakdown(), theirs.byte_breakdown()
    assert mine == ref
    assert mine["params_bytes"] < 0.35 * mine["params_bytes_f32"]
    plain = port(flax_params)
    assert plain.precision_stats() is None and not plain.quantized_weights
    assert plain.byte_breakdown()["params_bytes"] == plain.byte_breakdown()["params_bytes_f32"]
    gauges = ours.registry.gauge_values()
    assert gauges["precision/weight_bits"] == 8
    assert gauges["precision/quantized_params"] == ours.precision_stats()["quantized_params"]
    line = ContinuousBatcher(ours).stats_line()["serving"]
    assert all(line[k] == ours.precision_stats()[k] for k in SERVING_KEYS_V11)
    assert not any(k in line for k in SERVING_KEYS_V8)
    assert not any(k in ContinuousBatcher(plain).stats_line()["serving"] for k in SERVING_KEYS_V11)


@pytest.mark.parametrize("weights", ["", "fp8"])
def test_fp8_kv_first_token_matches_jax(flax_params, weights):
    kw = dict(kv_block_size=8, kv_dtype="fp8", weight_dtype=weights)
    ours, theirs = port(flax_params, **kw), jax_eng(flax_params, **kw)
    assert ours.pool.k.dtype == torch.float8_e4m3fn and ours.pool.kv_bits == 8
    rng = np.random.default_rng(4)
    for n in (5, 23, 40):
        prompt = [int(t) for t in rng.integers(0, 211, n)]
        firsts = []
        for eng in (ours, theirs):
            slot = eng.pool.alloc()
            tok, _ = eng.prefill(slot, prompt, seed=1)
            firsts.append((tok, eng.decode([(slot, tok, 1, 0.0, 0)])[slot]))
            eng.pool.free(slot)
        assert firsts[0] == firsts[1], (n, firsts)
    # The fp8 pool's written rows dequantize to the JAX pool's values.
    np.testing.assert_array_equal(_bytes(ours.pool.k[:, 1:4]), _bytes(theirs.pool.k[:, 1:4]))
    assert ours.byte_breakdown()["kv_cache_bytes"] == 0


def test_fp8_pool_bytes_and_guards(flax_params):
    pool = paged_kv.PagedKVPool(num_layers=2, num_slots=2, num_heads=2, max_len=64, head_dim=16,
                                block_size=8, kv_dtype="fp8", registry=MetricsRegistry())
    slot = pool.alloc()
    pool.assign(slot, pool.alloc_blocks(3))
    # Payload 1 byte a value plus an f32 scale a row, K and V, every layer.
    assert pool.used_bytes() == 3 * 2 * 2 * (8 * 2 * 16 + 8 * 2 * 4)
    old = pool.k
    pool.reallocate()
    assert pool.k is not old and pool.k.dtype == torch.float8_e4m3fn
    with pytest.raises(ValueError, match="paged_flash"):
        port(flax_params, kv_block_size=8, kv_dtype="fp8", attention="paged_flash")
    with pytest.raises(ValueError, match="kv_dtype"):
        paged_kv.PagedKVPool(num_layers=1, num_slots=1, num_heads=1, max_len=8, head_dim=4,
                             block_size=8, kv_dtype="int4")
