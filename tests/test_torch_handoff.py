"""The KV-page hand-off of the port against the JAX package's
(PyTorch/CUDA port).

* The port's ``encode_pages`` of given arrays is the reference's payload
  key for key, base64 for base64, for f32, bf16, int8 and fp8 arrays, and
  each package's ``decode_pages`` reads the other's; every malformation
  of ``tests/test_scheduler.py`` raises the reference's message.
* Pages cross packages both ways: a JAX prefill-role engine's export
  imported by a port decode-role engine, and the reverse, decode to the
  tokens of a JAX mixed engine, for f32 and int8 KV, greedy and sampled.
* The delta hand-off ships fewer blocks and decodes the same tokens; a
  cold importer refuses a delta loudly.
* ``prefix_digest()`` (keys, counts, truncation and bloom) equals the
  reference pool's after the same traffic, past ``DIGEST_MAX_KEYS`` too.

The engines run the smoke model of ``tests/test_torch_warmup.py`` (two
layers, d_model 32) on the paged pool with block 16, on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.models import transformer as jax_transformer
from tensorflow_examples_tpu.serving import engine as jax_engine
from tensorflow_examples_tpu.serving import paged_kv as jax_paged_kv
from tensorflow_examples_tpu.serving import scheduler as jax_scheduler
from tensorflow_examples_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from tensorflow_examples_torch.models import transformer
from tensorflow_examples_torch.serving import paged_kv, scheduler
from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
from tensorflow_examples_torch.telemetry.registry import MetricsRegistry

SMOKE = dict(vocab_size=211, max_len=64, num_layers=2, num_heads=2, d_model=32)
BASE = dict(max_slots=4, prefill_bucket_floor=16, kv_bucket_floor=32, kv_block_size=16)


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
        {"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def port_engine(params, **kw):
    cfg = ServeConfig(**{**BASE, "attention": "paged_flash", **kw})
    return InferenceEngine(transformer.TransformerConfig(**SMOKE), params, cfg=cfg,
                           registry=MetricsRegistry(), device="cpu")


def jax_engine_for(params, **kw):
    cfg = jax_transformer.TransformerConfig(**SMOKE, dropout=0.0, attention="xla")
    return jax_engine.InferenceEngine(cfg, jax.tree.map(jnp.asarray, params),
                                      cfg=jax_engine.ServeConfig(**{**BASE, **kw}),
                                      registry=JaxRegistry())


def decode_from(engine, slot, prompt, first, n, *, seed, temperature, top_k):
    toks = [int(first)]
    while len(toks) < n:
        toks.append(int(engine.decode([(slot, toks[-1], seed, temperature, top_k)])[slot]))
    engine.pool.free(slot)
    return toks


def mixed_stream(engine, prompt, n, **sampling):
    slot = engine.pool.alloc()
    first, _ = engine.prefill(slot, prompt, **sampling)
    return decode_from(engine, slot, prompt, first, n, **sampling)


def handoff_stream(exporter, importer, prompt, n, *, skip_tokens=0, **sampling):
    """Prefill on ``exporter``, ship the pages as JSON, import into
    ``importer`` and decode there: (tokens, the wire payload)."""
    slot = exporter.pool.alloc()
    first, _ = exporter.prefill(slot, prompt, **sampling)
    payload = exporter.export_kv_pages(slot, prompt, skip_tokens=skip_tokens)
    exporter.pool.free(slot)
    payload = json.loads(json.dumps(payload))
    slot = importer.pool.alloc()
    importer.import_kv_pages(slot, payload, prompt)
    return decode_from(importer, slot, prompt, first, n, **sampling), payload


# ------------------------------------------------------------------ codec

META = dict(block_size=4, num_layers=2, num_heads=3, head_dim=5, length=7, kv_bits=32)
NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16, "int8": np.int8,
             "float8_e4m3fn": ml_dtypes.float8_e4m3fn}


def _codec_arrays(name):
    """The same values as numpy (what the JAX engine encodes) and torch."""
    rng = np.random.default_rng(7)
    shape = (2, 2, 3, 4, 5)
    if name == "int8":
        np_k = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        np_k = rng.standard_normal(shape).astype(np.float32).astype(NP_DTYPES[name])
    np_scale = rng.random(shape[:-1]).astype(np.float32)
    to_torch = lambda a: torch.from_numpy(a.view(np.uint8).copy()).view(
        scheduler.WIRE_DTYPES[str(a.dtype)])
    np_arrays = {"k": np_k, "v": np_k[::-1].copy(), "k_scale": np_scale, "v_scale": np_scale}
    return np_arrays, {key: to_torch(a) for key, a in np_arrays.items()}


@pytest.mark.parametrize("name", sorted(NP_DTYPES))
def test_codec_payload_is_the_reference_byte_for_byte(name):
    np_arrays, t_arrays = _codec_arrays(name)
    meta = dict(META, kv_bits=8 * np.dtype(NP_DTYPES[name]).itemsize, start_block=1)
    theirs = jax_scheduler.encode_pages(meta, np_arrays)
    ours = scheduler.encode_pages(meta, t_arrays)
    assert ours == theirs
    assert ours["arrays"]["k"]["dtype"] == name and ours["start_block"] == 1
    wire = json.loads(json.dumps(theirs))
    meta_ours, read = scheduler.decode_pages(wire)
    assert meta_ours == jax_scheduler.decode_pages(wire)[0]
    for key, a in np_arrays.items():
        assert read[key].dtype == t_arrays[key].dtype and tuple(read[key].shape) == a.shape
        assert read[key].view(torch.uint8).numpy().tobytes() == a.tobytes()
    _, read_theirs = jax_scheduler.decode_pages(json.loads(json.dumps(ours)))
    for key, a in np_arrays.items():
        assert read_theirs[key].dtype == a.dtype and read_theirs[key].tobytes() == a.tobytes()


def _error(fn, payload):
    with pytest.raises(ValueError) as e:
        fn(payload)
    return str(e.value)


def test_codec_malformations_raise_the_reference_messages():
    np_arrays, t_arrays = _codec_arrays("float32")
    wire = json.loads(json.dumps(scheduler.encode_pages(META, t_arrays)))
    cases = [dict(wire, version=99), dict(wire, arrays={}), [1, 2],
             dict(wire, block_size=0), dict(wire, start_block=2), dict(wire, start_block=-1),
             dict(wire, arrays={"k": 1, "v": 2})]
    for name, key, value in (("k", "shape", [1, 1, 1, 1, 1]), ("v", "data", "@@not-base64@@"),
                             ("k", "dtype", "complex512"), ("v", "shape", None)):
        bad = json.loads(json.dumps(wire))
        bad["arrays"][name][key] = value
        cases.append(bad)
    for bad in cases:
        ours = _error(scheduler.decode_pages, bad)
        theirs = _error(jax_scheduler.decode_pages, bad)
        if "complex512" in json.dumps(bad):
            # numpy's own wording of an unknown dtype differs; the lead is the same.
            assert ours.split(":")[0] == theirs.split(":")[0] == "malformed pages array 'k'"
        else:
            assert ours == theirs
    for fn in (scheduler.encode_pages, jax_scheduler.encode_pages):
        with pytest.raises(ValueError, match="page meta missing"):
            fn({"block_size": 4}, {})


def test_bloom_and_chain_keys_match_the_reference():
    prompt = list(range(100))
    assert scheduler.prompt_chain_keys(prompt, 16) == jax_scheduler.prompt_chain_keys(prompt, 16)
    keys = scheduler.prompt_chain_keys(prompt, 4)
    bloom = scheduler.encode_bloom(keys)
    assert bloom == jax_scheduler.encode_bloom(keys)
    ours, theirs = scheduler.decode_bloom(bloom), jax_scheduler.decode_bloom(bloom)
    assert all(k in ours and k in theirs for k in keys)
    probe = scheduler.prompt_chain_keys(list(range(7, 90)), 4)
    assert [k in ours for k in probe] == [k in theirs for k in probe]
    assert scheduler.affinity_blocks(keys, ours) == jax_scheduler.affinity_blocks(keys, theirs)
    for bad in ({"m": 7, "k": 1, "n": 0, "bits": ""}, {"m": 8}, "x"):
        assert _error(scheduler.decode_bloom, bad) == _error(jax_scheduler.decode_bloom, bad)


# ------------------------------------------------------- engine hand-off

SAMPLING = {"greedy": dict(seed=0, temperature=0.0, top_k=0),
            "sampled": dict(seed=5, temperature=0.8, top_k=40)}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kv_dtype", ["", "int8"])
@pytest.mark.parametrize("mode", sorted(SAMPLING))
def test_pages_cross_packages_both_ways(flax_params, kv_dtype, mode):
    """JAX prefill -> port decode and port prefill -> JAX decode give a
    JAX mixed engine's tokens (prompts of 1, 2 and 3 blocks and a ragged
    tail)."""
    sampling = SAMPLING[mode]
    jax_pre = jax_engine_for(flax_params, kv_dtype=kv_dtype, role="prefill")
    jax_dec = jax_engine_for(flax_params, kv_dtype=kv_dtype, role="decode")
    jax_mixed = jax_engine_for(flax_params, kv_dtype=kv_dtype)
    port_pre = port_engine(flax_params, kv_dtype=kv_dtype, role="prefill")
    port_dec = port_engine(flax_params, kv_dtype=kv_dtype, role="decode")
    rng = np.random.default_rng(11)
    for n in (5, 16, 40):
        prompt = [int(t) for t in rng.integers(0, 211, n)]
        want = mixed_stream(jax_mixed, prompt, 8, **sampling)
        got, payload = handoff_stream(jax_pre, port_dec, prompt, 8, **sampling)
        assert got == want, (n, "jax -> port")
        assert payload["kv_bits"] == (8 if kv_dtype else 32)
        got, payload = handoff_stream(port_pre, jax_dec, prompt, 8, **sampling)
        assert got == want, (n, "port -> jax")
        assert set(payload["arrays"]) == ({"k", "v", "k_scale", "v_scale"} if kv_dtype
                                          else {"k", "v"})
    counters = port_dec.registry.counter_values()
    assert counters["serving/kv_pages_imported"] == 1 + 1 + 3
    assert port_pre.registry.counter_values()["serving/kv_pages_exported"] == 1 + 1 + 3
    assert port_dec.pool.active_slots == 0


@pytest.mark.timeout(300)
def test_delta_handoff_and_the_cold_importers_loud_reject(flax_params):
    port_pre = port_engine(flax_params, role="prefill")
    port_dec = port_engine(flax_params, role="decode")
    jax_mixed = jax_engine_for(flax_params)
    rng = np.random.default_rng(2)
    prefix = [int(t) for t in rng.integers(0, 211, 32)]
    a, b = prefix + [1, 2, 3], prefix + [9, 8, 7, 6, 5]
    got, full = handoff_stream(port_pre, port_dec, a, 6, **SAMPLING["greedy"])
    assert got == mixed_stream(jax_mixed, a, 6, **SAMPLING["greedy"])
    assert "start_block" not in full
    # The skip the router's digest exchange computes from the decode
    # replica's /health digest.
    digest = frozenset(port_dec.pool.prefix_digest()["keys"])
    skip = scheduler.affinity_blocks(scheduler.prompt_chain_keys(b, 16), digest) * 16
    assert skip == 32
    got, delta = handoff_stream(port_pre, port_dec, b, 6, skip_tokens=skip,
                                **SAMPLING["sampled"])
    assert delta["start_block"] == 2 and delta["arrays"]["k"]["shape"][1] == 1
    assert got == mixed_stream(jax_mixed, b, 6, **SAMPLING["sampled"])
    assert port_pre.registry.counter_values()["serving/kv_pages_delta_skipped"] == 2
    # A JAX importer that holds the prefix takes the port's delta too.
    jax_dec = jax_engine_for(flax_params, role="decode")
    handoff_stream(port_pre, jax_dec, a, 2, **SAMPLING["greedy"])
    got, _ = handoff_stream(port_pre, jax_dec, b, 6, skip_tokens=skip, **SAMPLING["greedy"])
    assert got == mixed_stream(jax_mixed, b, 6, **SAMPLING["greedy"])
    # A cold importer cannot honour the skip: both packages refuse alike.
    for cold in (port_engine(flax_params), jax_engine_for(flax_params)):
        slot = cold.pool.alloc()
        with pytest.raises(ValueError, match="re-send full pages"):
            cold.import_kv_pages(slot, delta, b)
        cold.pool.free(slot)
        assert cold.pool.active_slots == 0


@pytest.mark.timeout(120)
def test_import_refuses_what_the_reference_refuses(flax_params):
    """Geometry, length and dtype mismatches raise the reference's
    messages, before any block is claimed."""
    port_pre = port_engine(flax_params)
    prompt = list(range(20))
    slot = port_pre.pool.alloc()
    port_pre.prefill(slot, prompt)
    payload = json.loads(json.dumps(port_pre.export_kv_pages(slot, prompt)))
    retyped = json.loads(json.dumps(payload))  # same width, another kind
    for name in ("k", "v"):
        retyped["arrays"][name]["dtype"] = "int32"
    cases = [(port_engine(flax_params, kv_block_size=8, prefill_bucket_floor=16),
              jax_engine_for(flax_params, kv_block_size=8), payload, prompt),
             (port_engine(flax_params, kv_dtype="int8"),
              jax_engine_for(flax_params, kv_dtype="int8"), payload, prompt),
             (port_engine(flax_params), jax_engine_for(flax_params), payload, prompt[:-1]),
             (port_engine(flax_params), jax_engine_for(flax_params), retyped, prompt)]
    for ours, theirs, body, p in cases:
        msgs = []
        for eng in (ours, theirs):
            s = eng.pool.alloc()
            with pytest.raises(ValueError) as e:
                eng.import_kv_pages(s, body, p)
            msgs.append(str(e.value))
            eng.pool.free(s)
            assert eng.pool.paged_stats()["blocks_used"] == 0
        assert msgs[0] == msgs[1]
    assert msgs[0] == ("pages dtype mismatch: 'k' is int32 but this replica's cache "
                       "stores float32")


# ----------------------------------------------------------- the digest


def test_prefix_digest_equals_the_reference_pools_past_the_cap():
    kw = dict(num_layers=1, num_slots=2, num_heads=1, max_len=64, head_dim=2, block_size=4,
              num_blocks=1200)
    ours = paged_kv.PagedKVPool(registry=MetricsRegistry(), **kw)
    theirs = jax_paged_kv.PagedKVPool(registry=JaxRegistry(), **kw)
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(0, 50, 8)]
    checked_small = False
    for i in range(100):
        prompt = shared + [int(t) for t in rng.integers(0, 50, 28 + i % 5)]
        for pool in (ours, theirs):
            slot = pool.alloc()
            pool.claim_prompt_blocks(slot, prompt)
            pool.insert_prefix(slot, prompt)
            pool.free(slot)
        if not checked_small and ours.prefix_digest()["blocks"] > 40:
            assert ours.prefix_digest(max_keys=16) == theirs.prefix_digest(max_keys=16)
            checked_small = True
    d_ours, d_theirs = ours.prefix_digest(), theirs.prefix_digest()
    assert d_ours["truncated"] and "bloom" in d_ours
    assert d_ours == d_theirs
    assert ours.paged_stats() == theirs.paged_stats()
    assert ours.paged_stats()["digest_truncated"] == 1 and checked_small
