"""The port's sharded engine in the KV-page hand-off and on ``fsdp``
meshes, against the JAX package's.

Spawned gloo worlds (``core/distributed.run_world``, a timeout on each)
run the port: one of 2 ranks on ``{model: 2}`` and then ``{fsdp: 2}``,
one of 4 ranks on ``{fsdp: 2, model: 2}``. The JAX side runs the same
mesh shapes over its fake CPU devices. Weights are one numpy-seeded
param tree in the reference's layout at ``tests/test_sharding.py``'s
smoke widths (``TestShardedServing``), loaded through
``models/convert.py``; the paged pool has block 16, as
``tests/test_torch_handoff.py``'s engines do.

* **Export.** A sharded prefill-role engine's pages, f32 and int8 KV, full
  and delta, for prompts of 1, 2 and 3 blocks with a ragged tail, against
  the JAX sharded engine's export of the same prompts: the meta equal,
  f32 pages within atol 1e-5, int8 pages within one quantization level
  and their scales within rtol 1e-5; every rank returns the same payload,
  on ``{model: 2}`` and on ``{fsdp: 2, model: 2}`` (gathered over
  ``model`` in each ``fsdp`` group).
* **Both directions, both packages.** Port sharded prefill -> JAX decode
  and -> port one-rank decode; JAX prefill -> port sharded decode and
  port one-rank prefill -> port sharded decode, each the JAX mixed
  engine's stream, greedy and sampled, f32 and int8. The sharded
  engines' counters and pool host state are a one-rank engine's after
  the same requests, on every rank. A refused payload (geometry, dtype,
  a cold delta) fails with the reference's message on rank 0 and raises
  ``ValueError`` on the other ranks too; the world serves on after it.
* **fsdp.** On ``{fsdp: 2}`` and ``{fsdp: 2, model: 2}``: the JAX
  engine's ``param_sharding_digest`` on the same mesh, the six batcher
  streams of ``test_batched_token_identity_and_zero_recompiles`` equal
  to the JAX sharded engine's ``reference_generate``, greedy output equal
  to the one-rank port engine's, and ``paged_flash`` with int8 KV, and
  int8 weights, giving the one-rank engine's streams.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from tensorflow_examples_torch.core import distributed
from tensorflow_examples_torch.models import transformer
from tensorflow_examples_torch.serving import scheduler
from tensorflow_examples_torch.serving.batcher import ContinuousBatcher, Request
from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
from tensorflow_examples_torch.serving.mesh_driver import MeshDriver
from tensorflow_examples_torch.sharding import ShardingConfig
from tensorflow_examples_torch.telemetry.registry import MetricsRegistry

WORLD_TIMEOUT_S = 240
# tests/test_sharding.py:548's smoke model and serve config.
SMOKE = dict(vocab_size=211, max_len=64, num_layers=2, num_heads=2, d_model=32)
SERVE = dict(max_slots=4, prefill_bucket_floor=16, kv_bucket_floor=32)
# tests/test_torch_handoff.py's paged pool.
PAGED = dict(SERVE, kv_block_size=16, attention="paged_flash")
KV_DTYPES = ("", "int8")
SAMPLING = {"greedy": dict(seed=0, temperature=0.0, top_k=0),
            "sampled": dict(seed=5, temperature=0.8, top_k=40)}
LENGTHS = (5, 16, 40)   # 1, 2 and 3 blocks of 16, ragged tails
NEW = 8                 # tokens a handed-off request yields, the first included
DELTA_SKIP = 16         # the delta hand-off's skipped tokens (start_block 1)
FSDP_ROUTES = {
    "paged_flash_int8_prefix": dict(kv_block_size=8, attention="paged_flash", kv_dtype="int8"),
    "weights_int8": dict(weight_dtype="int8"),
}
MESHES = {"model": {"data": 1, "model": 2}, "fsdp": {"data": 1, "fsdp": 2},
          "fsdp_model": {"data": 1, "fsdp": 2, "model": 2}}


def prompts() -> dict[int, list[int]]:
    rng = np.random.default_rng(11)
    return {n: [int(t) for t in rng.integers(0, SMOKE["vocab_size"], n)] for n in LENGTHS}


def six_requests() -> list[Request]:
    """``test_batched_token_identity_and_zero_recompiles``'s requests."""
    return [
        Request(prompt=[7], max_new_tokens=5, seed=3),
        Request(prompt=[1, 2, 3, 4, 5], max_new_tokens=6, seed=11, temperature=0.9, top_k=13),
        Request(prompt=list(range(1, 20)), max_new_tokens=4, seed=5, temperature=0.7),
        Request(prompt=[9, 8, 7], max_new_tokens=6, seed=21),
        Request(prompt=list(range(40, 2, -1)), max_new_tokens=5, seed=8, temperature=1.1,
                top_k=7),
        Request(prompt=[3, 1], max_new_tokens=6, seed=13),
    ]


def prefix_requests() -> list[Request]:
    """Sent after :func:`six_requests`: two prompts whose first 16 tokens
    are the 19-token prompt's, which the prefix cache then holds."""
    return [Request(prompt=list(range(1, 17)) + [50, 60, 70], max_new_tokens=5, seed=2),
            Request(prompt=list(range(1, 20)) + [8], max_new_tokens=4, seed=4,
                    temperature=0.8)]


def seeded_tree(seed: int = 2) -> dict:
    """A param tree in the reference's layout at the smoke widths, made
    from a numpy seed (LayerNorm scales near 1, small biases, the rest at
    std 0.05)."""
    import jax

    from tensorflow_examples_tpu.models import transformer as jax_transformer

    model = jax_transformer.Transformer(jax_transformer.TransformerConfig(
        **SMOKE, dropout=0.0, attention="xla"))
    shapes = jax.eval_shape(lambda r: model.init({"params": r}, np.zeros((1, 8), np.int32)),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        scale, base = {"scale": (0.1, 1.0), "bias": (0.02, 0.0)}.get(path[-1].key, (0.05, 0.0))
        return (base + scale * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def gpt2_sharding(mesh: dict):
    """``tests/test_sharding.py``'s config: the JAX GPT-2 rules embedded."""
    from tensorflow_examples_tpu.models import transformer as jax_transformer
    from tensorflow_examples_tpu.sharding import ShardingConfig as JaxShardingConfig
    from tensorflow_examples_tpu.sharding.config import rules_to_json

    return JaxShardingConfig(mesh=mesh, rules=rules_to_json(jax_transformer.GPT2_RULES))


def jax_engine(tree, sharding=None, **kw):
    import jax
    import jax.numpy as jnp

    from tensorflow_examples_tpu.models import transformer as jax_transformer
    from tensorflow_examples_tpu.serving import engine as jax_engine_mod
    from tensorflow_examples_tpu.telemetry.registry import MetricsRegistry as JaxRegistry

    kw = {k: v for k, v in kw.items() if k != "attention"}  # the reference's prefill is XLA
    cfg = jax_transformer.TransformerConfig(**SMOKE, dropout=0.0, attention="xla")
    return jax_engine_mod.InferenceEngine(cfg, jax.tree.map(jnp.asarray, tree),
                                          cfg=jax_engine_mod.ServeConfig(**{**SERVE, **kw}),
                                          registry=JaxRegistry(), sharding=sharding)


def port_engine(tree, sharding_json=None, **kw):
    sharding = None if sharding_json is None else ShardingConfig.from_json_dict(sharding_json)
    return InferenceEngine(transformer.TransformerConfig(**SMOKE), tree,
                           cfg=ServeConfig(**{**SERVE, **kw}), registry=MetricsRegistry(),
                           device="cpu", sharding=sharding)


# ---------------------------------------------------- the served rounds
#
# Each round runs on rank 0's leader (the other ranks replay it) and on a
# one-rank engine alike, one request at a time, so both take the same
# blocks in the same order.


def one_at_a_time(engine, requests) -> list:
    """Each request through a ContinuousBatcher after the last finished:
    its Result, or the message of the ValueError that refused it."""
    batcher = ContinuousBatcher(engine).start()
    out = []
    try:
        for req in requests:
            try:
                out.append(batcher.submit(req).result(timeout=120))
            except ValueError as e:
                out.append(str(e))
    finally:
        batcher.close()
    return out


def prefill_requests(prompt_of) -> list[Request]:
    """Every prompt in each sampling mode, then the delta of the longest."""
    reqs = [Request(prompt=prompt_of[n], kind="prefill", **SAMPLING[mode])
            for mode in sorted(SAMPLING) for n in LENGTHS]
    return reqs + [Request(prompt=prompt_of[max(LENGTHS)], kind="prefill",
                           skip_tokens=DELTA_SKIP, **SAMPLING["greedy"])]


def prefill_round(engine, prompt_of) -> dict:
    results = one_at_a_time(engine, prefill_requests(prompt_of))
    return {"handoffs": [(r.tokens[0], r.pages) for r in results],
            "counters": engine.registry.counter_values()}


def resume(first_and_pages, prompt, mode) -> Request:
    first, pages = first_and_pages
    return Request(prompt=prompt, kind="resume", pages=pages, first_token=first,
                   max_new_tokens=NEW, **SAMPLING[mode])


def refused_payloads(source) -> dict:
    """A geometry mismatch, f32 arrays relabelled int32 (the right width,
    another kind) and, to a cold importer, a delta."""
    first, pages = source[("greedy", max(LENGTHS))]
    retyped = json.loads(json.dumps(pages))
    for spec in retyped["arrays"].values():
        if spec["dtype"] == "float32":
            spec["dtype"] = "int32"
    return {"geometry": (first, dict(pages, block_size=8)), "dtype": (first, retyped),
            "cold_delta": source["delta"]}


def decode_requests(prompt_of, sources: dict) -> list[Request]:
    """The refused payloads first (the pool is cold), then every source's
    hand-offs, then the delta again (its prefix now cached)."""
    longest = prompt_of[max(LENGTHS)]
    reqs = [resume(p, longest, "greedy") for p in refused_payloads(sources["port"]).values()]
    for name in sorted(sources):
        reqs += [resume(sources[name][(mode, n)], prompt_of[n], mode)
                 for mode in sorted(SAMPLING) for n in LENGTHS]
    return reqs + [resume(sources["port"]["delta"], longest, "greedy")]


def decode_round(engine, prompt_of, sources) -> dict:
    results = one_at_a_time(engine, decode_requests(prompt_of, sources))
    return {"results": [r if isinstance(r, str) else r.tokens for r in results],
            "counters": engine.registry.counter_values(),
            "host_state": engine.pool.host_state()}


# ------------------------------------------------------------ rank workers

_EXPORTED: list = []


def _export_here(engine, prompt, skip):
    """On every rank: prefill ``prompt`` and export its pages; each rank
    keeps its payload."""
    slot = engine.pool.alloc()
    first, _ = engine.prefill(slot, prompt)
    payload = engine.export_kv_pages(slot, prompt, skip_tokens=skip)
    engine.pool.free(slot)
    _EXPORTED.append((first, payload))
    return first, payload


def _lead(rank, engine, fn, *args) -> dict:
    """``fn(leader, *args)`` on rank 0 while the other ranks replay it;
    every rank's pool host state, published or replayed calls, and the
    replayed calls that raised."""
    driver = MeshDriver()
    if rank == 0:
        out = fn(driver.leader(engine), *args)
        out["exported"] = list(_EXPORTED)
        driver.stop()
        out["calls"] = driver.calls
    else:
        out = {"calls": driver.follow(engine), "raised": dict(driver.raised),
               "exported": list(_EXPORTED)}
    out["host_state"] = engine.pool.host_state()
    out["counters"] = engine.registry.counter_values()
    out["digest"] = engine.param_sharding_digest
    out["local_heads"] = engine.local_heads
    out["post_warmup_recompiles"] = engine.post_warmup_recompiles()
    _EXPORTED.clear()
    return out


def _export_round(leader, prompt_of) -> dict:
    """The served prefills, then one export made on every rank."""
    out = prefill_round(leader, prompt_of)
    leader.driver.run(leader.engine, _export_here, prompt_of[max(LENGTHS)], 0)
    return out


def _fsdp_round(leader, rounds, greedy: bool) -> dict:
    """Warmup, each round's requests at once through a batcher, and the
    greedy drive."""
    leader.warmup()
    out = {"streams": []}
    batcher = ContinuousBatcher(leader).start()
    try:
        for reqs in rounds:
            out["streams"] += [f.result(timeout=120).tokens
                               for f in [batcher.submit(r) for r in reqs]]
    finally:
        batcher.close()
    if greedy:
        out["greedy"] = drive_greedy(leader)
    out["prefix_hits"] = getattr(leader.pool, "prefix_hits", None)
    return out


def drive_greedy(engine) -> list[int]:
    """``test_sharded_matches_replicated_engine``'s drive: a prefill and
    four decode steps."""
    slot = engine.pool.alloc()
    tok, _ = engine.prefill(slot, [5, 4, 3], seed=2)
    out = [tok]
    for _ in range(4):
        out.append(engine.decode([(slot, out[-1], 2, 0.0, 0)])[slot])
    engine.pool.free(slot)
    return out


def _fsdp_configs(rank, case, mesh_name) -> dict:
    sj = case["sharding"][mesh_name]
    out = {"main": _lead(rank, port_engine(case["tree"], sj), _fsdp_round, [six_requests()],
                         True)}
    for name, kw in FSDP_ROUTES.items():
        out[name] = _lead(rank, port_engine(case["tree"], sj, **kw), _fsdp_round,
                          [six_requests(), prefix_requests()], False)
    return out


def _handoff_engines(rank, case, mesh_name, kv) -> dict:
    sj = case["sharding"][mesh_name]
    pre = port_engine(case["tree"], sj, role="prefill", kv_dtype=kv, **PAGED)
    dec = port_engine(case["tree"], sj, role="decode", kv_dtype=kv, **PAGED)
    return {"prefill": _lead(rank, pre, _export_round, case["prompts"]),
            "decode": _lead(rank, dec, decode_round, case["prompts"], case["sources"][kv])}


def _two_rank_worker(rank: int, case: dict) -> dict:
    torch.set_num_threads(1)
    return {"handoff": {kv: _handoff_engines(rank, case, "model", kv) for kv in KV_DTYPES},
            "fsdp": _fsdp_configs(rank, case, "fsdp")}


def _four_rank_worker(rank: int, case: dict) -> dict:
    torch.set_num_threads(1)
    return {"handoff": {"": _handoff_engines(rank, case, "fsdp_model", "")},
            "fsdp": _fsdp_configs(rank, case, "fsdp_model")}


# ----------------------------------------------------------------- fixtures


def handoffs_of(engine, prompt_of) -> dict:
    """An unsharded prefill engine's hand-offs, as :func:`prefill_requests`
    makes them: ``{(mode, n): (first, payload), "delta": ...}``, each
    payload through JSON."""
    out = {}

    def one(prompt, sampling, skip=0):
        slot = engine.pool.alloc()
        first, _ = engine.prefill(slot, prompt, **sampling)
        pages = engine.export_kv_pages(slot, prompt, skip_tokens=skip)
        engine.pool.free(slot)
        return int(first), json.loads(json.dumps(pages))

    for mode in sorted(SAMPLING):
        for n in LENGTHS:
            out[(mode, n)] = one(prompt_of[n], SAMPLING[mode])
    out["delta"] = one(prompt_of[max(LENGTHS)], SAMPLING["greedy"], DELTA_SKIP)
    return out


@pytest.fixture(scope="module")
def case():
    tree = seeded_tree()
    prompt_of = prompts()
    sources = {kv: {"port": handoffs_of(port_engine(tree, role="prefill", kv_dtype=kv,
                                                    **PAGED), prompt_of),
                    "jax": handoffs_of(jax_engine(tree, role="prefill", kv_dtype=kv, **PAGED),
                                       prompt_of)}
               for kv in KV_DTYPES}
    return {"tree": tree, "prompts": prompt_of, "sources": sources,
            "sharding": {name: gpt2_sharding(m).to_json_dict() for name, m in MESHES.items()}}


@pytest.fixture(scope="module")
def worlds(case, tmp_path_factory):
    return {"2": distributed.run_world(_two_rank_worker, 2, case, timeout_s=WORLD_TIMEOUT_S,
                                       store_dir=str(tmp_path_factory.mktemp("w2"))),
            "4": distributed.run_world(_four_rank_worker, 4, case, timeout_s=WORLD_TIMEOUT_S,
                                       store_dir=str(tmp_path_factory.mktemp("w4")))}


@pytest.fixture(scope="module")
def mixed_streams(case):
    """The JAX mixed engine's stream of every prompt, mode and KV dtype."""
    out = {}
    for kv in KV_DTYPES:
        engine = jax_engine(case["tree"], kv_dtype=kv, **PAGED)
        for mode in sorted(SAMPLING):
            for n in LENGTHS:
                slot = engine.pool.alloc()
                first, _ = engine.prefill(slot, case["prompts"][n], **SAMPLING[mode])
                out[(kv, mode, n)] = decode_from(engine, slot, first, **SAMPLING[mode])
    return out


def decode_from(engine, slot, first, *, seed, temperature, top_k) -> list[int]:
    toks = [int(first)]
    while len(toks) < NEW:
        toks.append(int(engine.decode([(slot, toks[-1], seed, temperature, top_k)])[slot]))
    engine.pool.free(slot)
    return toks


def import_and_decode(engine, handoff, prompt, mode) -> list[int]:
    first, pages = handoff
    slot = engine.pool.alloc()
    engine.import_kv_pages(slot, json.loads(json.dumps(pages)), prompt)
    return decode_from(engine, slot, first, **SAMPLING[mode])


HANDOFF_CASES = [("2", "model", ""), ("2", "model", "int8"), ("4", "fsdp_model", "")]


def _pages(payload) -> tuple[dict, dict]:
    meta = {k: v for k, v in payload.items() if k != "arrays"}
    _, arrays = scheduler.decode_pages(payload)
    return meta, arrays


# -------------------------------------------------------------------- tests


@pytest.mark.timeout(300)
@pytest.mark.parametrize("world,mesh,kv", HANDOFF_CASES)
def test_sharded_export_matches_the_jax_sharded_export(case, worlds, world, mesh, kv):
    ranks = [r["handoff"][kv]["prefill"] for r in worlds[world]]
    theirs = handoffs_of(jax_engine(case["tree"], gpt2_sharding(MESHES[mesh]), role="prefill",
                                    kv_dtype=kv, **PAGED), case["prompts"])
    keys = [(mode, n) for mode in sorted(SAMPLING) for n in LENGTHS] + ["delta"]
    for key, (first, pages) in zip(keys, ranks[0]["handoffs"]):
        want_first, want_pages = theirs[key]
        assert first == want_first, key
        meta, arrays = _pages(pages)
        want_meta, want_arrays = _pages(want_pages)
        assert meta == want_meta, key
        assert meta["num_heads"] == SMOKE["num_heads"] and sorted(arrays) == sorted(want_arrays)
        for name, a in arrays.items():
            b = want_arrays[name]
            assert a.dtype == b.dtype and a.shape == b.shape, (key, name)
            if a.dtype == torch.int8:
                assert int((a.int() - b.int()).abs().max()) <= 1, (key, name)
            elif name.endswith("scale"):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, err_msg=str(key))
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=str(key))
    assert "start_block" not in ranks[0]["handoffs"][0][1]
    assert ranks[0]["handoffs"][-1][1]["start_block"] == DELTA_SKIP // PAGED["kv_block_size"]
    # The export every rank made returns the same payload on every rank.
    exported = [r["exported"] for r in ranks]
    assert len(exported[0]) == 1 and all(e == exported[0] for e in exported)
    # Counted as on one rank: a one-rank engine after the same round.
    one = port_engine(case["tree"], role="prefill", kv_dtype=kv, **PAGED)
    prefill_round(one, case["prompts"])
    _export_here(one, case["prompts"][max(LENGTHS)], 0)
    _EXPORTED.clear()
    want = one.registry.counter_values()
    for r in ranks:
        for name in ("serving/kv_pages_exported", "serving/kv_pages_delta_skipped"):
            assert r["counters"][name] == want[name], name
        assert r["host_state"] == ranks[0]["host_state"] == one.pool.host_state()
        assert r["local_heads"] == SMOKE["num_heads"] // 2


@pytest.mark.timeout(300)
@pytest.mark.parametrize("mode", sorted(SAMPLING))
@pytest.mark.parametrize("world,mesh,kv", HANDOFF_CASES)
def test_sharded_prefill_hands_off_to_jax_and_one_rank_decode(case, worlds, mixed_streams,
                                                               world, mesh, kv, mode):
    handoffs = worlds[world][0]["handoff"][kv]["prefill"]["handoffs"]
    keys = [(m, n) for m in sorted(SAMPLING) for n in LENGTHS]
    importers = {"jax": jax_engine(case["tree"], role="decode", kv_dtype=kv, **PAGED),
                 "port": port_engine(case["tree"], role="decode", kv_dtype=kv, **PAGED)}
    for (m, n), handoff in zip(keys, handoffs):
        if m != mode:
            continue
        for name, importer in importers.items():
            got = import_and_decode(importer, handoff, case["prompts"][n], mode)
            assert got == mixed_streams[(kv, mode, n)], (name, n)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("world,mesh,kv", HANDOFF_CASES)
def test_sharded_decode_takes_jax_and_one_rank_pages(case, worlds, mixed_streams, world, mesh,
                                                     kv):
    """JAX prefill -> port sharded decode and port one-rank prefill ->
    port sharded decode, after three refused payloads."""
    ranks = [r["handoff"][kv]["decode"] for r in worlds[world]]
    results = ranks[0]["results"]
    refused = refused_payloads(case["sources"][kv]["port"])
    longest = case["prompts"][max(LENGTHS)]
    for (what, (_, pages)), message in zip(refused.items(), results[:3]):
        theirs = jax_engine(case["tree"], role="decode", kv_dtype=kv, **PAGED)
        slot = theirs.pool.alloc()
        with pytest.raises(ValueError) as e:
            theirs.import_kv_pages(slot, json.loads(json.dumps(pages)), longest)
        assert message == str(e.value), what
    assert "re-send full pages" in results[2] and "geometry mismatch" in results[0]
    streams = iter(results[3:])
    for source in sorted(case["sources"][kv]):
        for mode in sorted(SAMPLING):
            for n in LENGTHS:
                assert next(streams) == mixed_streams[(kv, mode, n)], (source, mode, n)
    assert next(streams) == mixed_streams[(kv, "greedy", max(LENGTHS))]  # the honoured delta
    # Every rank raised on the refusals as rank 0 did, and served on.
    for r in ranks[1:]:
        assert r["raised"] == {"ValueError": 3}
        assert r["calls"] == ranks[0]["calls"]
    one = port_engine(case["tree"], role="decode", kv_dtype=kv, **PAGED)
    want = decode_round(one, case["prompts"], case["sources"][kv])
    assert results == want["results"]
    for r in ranks:
        assert r["host_state"] == want["host_state"]
        for name in ("serving/kv_pages_imported", "serving/prefix_reused_tokens",
                     "serving/decode_tokens"):
            assert r["counters"].get(name) == want["counters"].get(name), name
        assert r["counters"].get("serving/prefill_tokens", 0) == 0
    assert ranks[0]["counters"]["serving/kv_pages_imported"] > 0


FSDP_CASES = [("2", "fsdp"), ("4", "fsdp_model")]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("world,mesh", FSDP_CASES)
def test_fsdp_serving_matches_the_jax_engine(case, worlds, world, mesh):
    theirs = jax_engine(case["tree"], gpt2_sharding(MESHES[mesh]))
    ranks = [r["fsdp"]["main"] for r in worlds[world]]
    lead = ranks[0]
    for req, tokens in zip(six_requests(), lead["streams"]):
        assert tokens == theirs.reference_generate(
            req.prompt, max_new=req.max_new_tokens, seed=req.seed, temperature=req.temperature,
            top_k=req.top_k), req.prompt
    assert lead["greedy"] == drive_greedy(port_engine(case["tree"]))
    heads = SMOKE["num_heads"] // MESHES[mesh].get("model", 1)
    for r in ranks:
        assert r["digest"] == theirs.param_sharding_digest
        assert r["local_heads"] == heads
        assert r["post_warmup_recompiles"] == 0
        assert r["host_state"] == lead["host_state"]
        assert r["calls"] == lead["calls"] and not r.get("raised")


@pytest.mark.timeout(300)
@pytest.mark.parametrize("route", sorted(FSDP_ROUTES))
@pytest.mark.parametrize("world,mesh", FSDP_CASES)
def test_fsdp_routes_match_the_one_rank_engine(case, worlds, world, mesh, route):
    kw = FSDP_ROUTES[route]
    one = port_engine(case["tree"], **kw)
    want = _fsdp_round(one, [six_requests(), prefix_requests()], False)
    ranks = [r["fsdp"][route] for r in worlds[world]]
    assert ranks[0]["streams"] == want["streams"]
    for r in ranks:
        assert r["host_state"] == ranks[0]["host_state"]
        assert r["post_warmup_recompiles"] == 0
    if route == "paged_flash_int8_prefix":
        assert ranks[0]["prefix_hits"] == one.pool.prefix_hits > 0
    if route == "weights_int8":
        theirs = jax_engine(case["tree"], gpt2_sharding(MESHES[mesh]), weight_dtype="int8")
        assert all(r["digest"] == theirs.param_sharding_digest for r in ranks)
