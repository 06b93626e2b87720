"""The port's serving stack against the JAX engine (PyTorch/CUDA port).

At the smoke model (``tools/serve_bench.SMOKE_MODEL``) with the same
flax-initialized weights, the port's engine — dense pool under
``attention="flash"`` and paged pool under ``attention="paged_flash"``,
on the CPU through the kernels' plain versions — must produce greedy
streams token-identical to the JAX ``InferenceEngine`` in the same
configuration (its Pallas kernels in interpret mode). A stream may
differ only where the reference's top-2 logits are within 1e-4 of each
other (a near-tie, decided by the summation order). Then the port's own
goldens: the continuous batcher equals the unbatched
``reference_generate``, a prefix-cache hit changes no token, the HTTP
contract, the paged pool's allocator, import purity and device policy.
"""

import ast
import dataclasses
import json
import os
import sys
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.models import transformer as jax_transformer
from tensorflow_examples_tpu.serving import engine as jax_engine
from tensorflow_examples_tpu.serving import kv_cache as jax_kv
from tensorflow_examples_tpu.serving import scheduler as jax_scheduler
from tensorflow_examples_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from tensorflow_examples_torch.models import transformer
from tensorflow_examples_torch.serving import kv_cache, paged_kv, scheduler
from tensorflow_examples_torch.serving.batcher import (
    ContinuousBatcher,
    Draining,
    QueueFull,
    Request,
)
from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
from tensorflow_examples_torch.serving.frontend import ServingFrontend
from tensorflow_examples_torch.telemetry.registry import MetricsRegistry

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

NEAR_TIE = 1e-4
CONFIGS = {
    "flash": dict(attention="flash"),
    "paged_flash": dict(attention="paged_flash", kv_block_size=8),
}


def smoke_cfgs(**kw):
    jax_cfg = jax_transformer.TransformerConfig(**{**serve_bench.SMOKE_MODEL, **kw})
    keys = ("vocab_size", "max_len", "num_layers", "num_heads", "d_model")
    return jax_cfg, transformer.TransformerConfig(**{k: getattr(jax_cfg, k) for k in keys})


@pytest.fixture(scope="module")
def flax_params():
    jax_cfg, _ = smoke_cfgs()
    params = jax_transformer.Transformer(jax_cfg).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 8), jnp.int32)
    )["params"]
    return jax.tree.map(np.asarray, params)


def port_engine(params, **kw):
    _, cfg = smoke_cfgs()
    serve = dict(max_slots=4, prefill_bucket_floor=16, kv_bucket_floor=32, max_delay_s=0.002)
    serve.update(kw)
    return InferenceEngine(cfg, params, cfg=ServeConfig(**serve), registry=MetricsRegistry(),
                           device="cpu")


def jax_engine_for(params, **kw):
    jax_cfg, _ = smoke_cfgs()
    serve = dict(max_slots=4, prefill_bucket_floor=16, kv_bucket_floor=32)
    serve.update(kw)
    return jax_engine.InferenceEngine(
        jax_cfg, jax.tree.map(jnp.asarray, params),
        cfg=jax_engine.ServeConfig(**serve), registry=JaxRegistry(),
    )


def drive(engine, prompts, max_new):
    """Greedy streams of ``prompts`` served together: prefill each into
    its own slot, then decode steps over the whole active set; a slot is
    freed as soon as its stream is complete. Works for either engine."""
    slots, streams = {}, {}
    for i, p in enumerate(prompts):
        slots[i] = engine.pool.alloc()
        streams[i] = [engine.prefill(slots[i], p, seed=i)[0]]
    while True:
        live = [i for i in streams if len(streams[i]) < max_new]
        for i in list(slots):
            if i not in live:
                engine.pool.free(slots.pop(i))
        if not live:
            return [streams[i] for i in range(len(prompts))]
        out = engine.decode([(slots[i], streams[i][-1], i, 0.0, 0) for i in live])
        for i in live:
            streams[i].append(out[slots[i]])


def assert_same_or_near_tie(port, prompt, ours, theirs):
    """Streams equal, or first differing where the reference's top-2
    logits are within NEAR_TIE (after which the streams legitimately
    part)."""
    for i, (a, b) in enumerate(zip(ours, theirs)):
        if a != b:
            top2 = torch.topk(port.reference_logits(list(prompt) + theirs[:i]), 2).values
            gap = float(top2[0] - top2[1])
            assert gap < NEAR_TIE, (
                f"prompt_len={len(prompt)}: streams differ at token {i} "
                f"(top-2 gap {gap:.3e}): {ours} vs {theirs}"
            )
            return
    assert len(ours) == len(theirs)


def prompts_for(n, *, seed=0, lengths=(5, 12, 20, 30)):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 211, ln)] for ln in lengths[:n]]


# --------------------------------------------------------- JAX parity


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_streams_match_jax_engine(flax_params, name):
    prompts = prompts_for(4)
    port = port_engine(flax_params, **CONFIGS[name])
    ours = drive(port, prompts, max_new=8)
    theirs = drive(jax_engine_for(flax_params, **CONFIGS[name]), prompts, max_new=8)
    for prompt, a, b in zip(prompts, ours, theirs):
        assert_same_or_near_tie(port, prompt, a, b)
    assert port.pool.active_slots == 0


@pytest.mark.timeout(300)
def test_prefix_cache_hit_matches_jax_and_reference(flax_params):
    """Request B reuses A's two cached prefix blocks and prefills only
    its tail (the extend path): its tokens equal the JAX engine's, which
    takes the same hit, and the port's cacheless reference; A's shared
    blocks are not written (copy-on-write)."""
    prefix = prompts_for(1, seed=11, lengths=(16,))[0]
    a, b = prefix + [3, 1, 4], prefix + [9, 2, 6, 5]
    port = port_engine(flax_params, **CONFIGS["paged_flash"])
    jax_eng = jax_engine_for(flax_params, **CONFIGS["paged_flash"])
    streams = {}
    for label, eng in (("port", port), ("jax", jax_eng)):
        streams[label] = [drive(eng, [a], max_new=4)[0]]
        if label == "port":
            shared = [bid for bid, key in port.pool._cache_key.items()
                      if list(key[1]) in (prefix[:8], prefix[8:])]
            k_before = port.pool.k[:, shared].clone()
        hits = eng.pool.prefix_hits
        streams[label].append(drive(eng, [b], max_new=4)[0])
        assert eng.pool.prefix_hits == hits + 1
    assert len(shared) == 2
    assert torch.equal(port.pool.k[:, shared], k_before)
    for prompt, ours, theirs in zip((a, b), streams["port"], streams["jax"]):
        assert_same_or_near_tie(port, prompt, ours, theirs)
        assert ours == port.reference_generate(prompt, max_new=4)


def test_chain_keys_and_ladders_match_jax():
    assert scheduler.chain_key("", [1, 2, 3]) == jax_scheduler.chain_key("", [1, 2, 3])
    parent = jax_scheduler.chain_key("", range(8))
    assert scheduler.chain_key(parent, [5] * 8) == jax_scheduler.chain_key(parent, [5] * 8)
    for floor, max_len in ((16, 64), (64, 1024), (5, 7)):
        assert kv_cache.bucket_ladder(floor, max_len) == jax_kv.bucket_ladder(floor, max_len)
    assert kv_cache.pick_bucket([16, 32, 64], 17) == jax_kv.pick_bucket([16, 32, 64], 17)


def test_varlen_decode_attention_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 2, 16)).astype(np.float32)
    blocks = rng.standard_normal((2, 7, 2, 8, 16)).astype(np.float32)
    lengths = np.array([3, 9, 24], np.int32)
    tables = np.array([[1, 0, 0], [2, 3, 0], [4, 5, 6]], np.int32)
    ours = kv_cache.varlen_decode_attention(
        torch.from_numpy(q), torch.from_numpy(blocks[0]), torch.from_numpy(blocks[1]),
        torch.from_numpy(lengths), block_tables=torch.from_numpy(tables),
    )
    theirs = jax_kv.varlen_decode_attention(
        jnp.asarray(q), jnp.asarray(blocks[0]), jnp.asarray(blocks[1]),
        jnp.asarray(lengths), block_tables=jnp.asarray(tables),
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-6, rtol=2e-6)


# ------------------------------------------------------- port goldens


def mixed_requests(n, cfg, *, max_new=4, seed=123):
    """n mixed-length requests across the prefill buckets, a third of
    them sampling (temperature / top-k) rather than greedy."""
    rng = np.random.default_rng(seed)
    cap = cfg.max_len - max_new
    reqs = []
    for i in range(n):
        ln = int(rng.integers(1, cap + 1)) if 0 < i < n - 1 else (1, cap)[i > 0]
        temp, top_k = ((0.0, 0), (0.9, 0), (1.0, 7))[i % 3]
        reqs.append(Request(prompt=[int(t) for t in rng.integers(0, cfg.vocab_size, ln)],
                            max_new_tokens=max_new, temperature=temp, top_k=top_k, seed=i))
    return reqs


@pytest.mark.timeout(240)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batcher_golden_equals_unbatched_reference(flax_params, name):
    """12 concurrent mixed requests through the continuous batcher equal
    12 unbatched cacheless replays token for token, sampled ones too:
    the sampling noise is a pure function of (seed, position)."""
    eng = port_engine(flax_params, **CONFIGS[name])
    reqs = mixed_requests(12, eng.model_cfg)
    batcher = ContinuousBatcher(eng).start()
    try:
        results = [f.result(timeout=120) for f in [batcher.submit(r) for r in reqs]]
    finally:
        batcher.close(drain=True)
    for req, res in zip(reqs, results):
        assert res.tokens == eng.reference_generate(
            req.prompt, max_new=req.max_new_tokens, seed=req.seed,
            temperature=req.temperature, top_k=req.top_k,
        ), f"prompt_len={len(req.prompt)} temp={req.temperature}"
        assert res.truncated is None and res.ttft_s is not None
    assert eng.pool.active_slots == 0
    hists = eng.registry.histogram_summaries()
    for h in ("serving/queue_wait", "serving/ttft", "serving/tpot", "serving/e2e"):
        assert hists[h]["count"] > 0


@pytest.mark.timeout(120)
def test_int8_kv_bounded_divergence(flax_params):
    """int8 KV under the fused kernel's path: first token exact (the
    prefill attends fresh unquantized K/V) and >= 75% stream agreement
    with the f32 reference, the bound tests/test_serving.py uses."""
    eng = port_engine(flax_params, attention="paged_flash", kv_block_size=8, kv_dtype="int8")
    assert eng.pool.kv_bits == 8
    prompts = prompts_for(4, seed=5, lengths=(5, 11, 17, 23))
    for prompt, seq in zip(prompts, drive(eng, prompts, max_new=6)):
        ref = eng.reference_generate(prompt, max_new=6, seed=0)
        assert seq[0] == ref[0]
        assert sum(x == y for x, y in zip(seq, ref)) >= 0.75 * len(ref), (seq, ref)


def test_eos_and_deadline_retire_early(flax_params):
    eng = port_engine(flax_params)
    ref = eng.reference_generate([9, 3, 5], max_new=6, seed=4, temperature=1.0)
    j = next(i for i, t in enumerate(ref) if i and t not in ref[:i])
    batcher = ContinuousBatcher(eng).start()
    try:
        res = batcher.submit(Request(prompt=[9, 3, 5], max_new_tokens=6, eos_id=ref[j],
                                     temperature=1.0, seed=4)).result(timeout=60)
        expired = batcher.submit(Request(prompt=[1, 2], deadline_s=0.0))
        with pytest.raises(Exception, match="deadline"):
            expired.result(timeout=60)
    finally:
        batcher.close(drain=True)
    assert res.tokens == ref[:j + 1] and res.truncated is None


def test_admission_rejects_sheds_and_drains(flax_params):
    eng = port_engine(flax_params, max_queue=1)
    batcher = ContinuousBatcher(eng)  # not started: requests stay queued
    over = batcher.submit(Request(prompt=[1] * 60, max_new_tokens=8))
    with pytest.raises(ValueError, match="max_len"):
        over.result(timeout=1)
    with pytest.raises(ValueError, match="token ids"):
        batcher.submit(Request(prompt=[211])).result(timeout=1)
    queued = batcher.submit(Request(prompt=[1, 2]))
    with pytest.raises(QueueFull):
        batcher.submit(Request(prompt=[3]))
    batcher.close(drain=False)
    with pytest.raises(Draining):
        queued.result(timeout=1)
    with pytest.raises(Draining):
        batcher.submit(Request(prompt=[1]))
    counters = eng.registry.counter_values()
    assert counters["serving/shed_total"] == 1
    assert counters["serving/rejected_total"] == 3


def test_block_exhaustion_at_admission_is_a_rejection(flax_params):
    """A prompt the paged pool cannot back fails with BlockExhausted
    (HTTP 503 upstream) and the engine keeps serving."""
    eng = port_engine(flax_params, kv_block_size=8, kv_blocks=3)  # 2 usable blocks
    frontend = ServingFrontend(ContinuousBatcher(eng).start())
    try:
        status, reply = frontend.handle_request({"prompt": list(range(20)), "max_new_tokens": 2})
        assert status == 503 and reply["exhausted"]
        status, reply = frontend.handle_request({"prompt": [5, 6, 7], "max_new_tokens": 3})
        assert status == 200
        assert reply["tokens"] == eng.reference_generate([5, 6, 7], max_new=3)
    finally:
        frontend.batcher.close(drain=True)
    assert eng.pool.used_bytes() == 0


def _http(url, body=None, timeout=60):
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.timeout(120)
def test_generate_over_http(flax_params):
    eng = port_engine(flax_params, **CONFIGS["paged_flash"])
    batcher = ContinuousBatcher(eng).start()
    frontend = ServingFrontend(batcher).start()
    try:
        status, text = _http(frontend.url(), {"prompt": [4, 8, 15, 16, 23, 42],
                                              "max_new_tokens": 5, "slo": "batch"})
        assert status == 200
        reply = json.loads(text)
        assert reply["tokens"] == eng.reference_generate([4, 8, 15, 16, 23, 42], max_new=5)
        assert reply["prompt_len"] == 6 and reply["truncated"] is None
        assert reply["total_s"] >= reply["ttft_s"] >= reply["queue_wait_s"] >= 0
        status, text = _http(frontend.url("/health"))
        health = json.loads(text)
        assert status == 200 and health["ok"] and health["slots"] == 4
        assert "kv_block_occupancy" in health
        status, text = _http(frontend.url("/metrics"))
        assert status == 200 and 'serving_ttft_seconds{host="0",quantile="0.5"}' in text
        assert "serving_completed_total" in text
        for bad in ({"prompt": []}, {"prompt": [1], "bogus": 1}, {"text": "hi"},
                    {"prompt": [1], "max_new_tokens": 1.5}, {"prompt": [1], "seed": -1}):
            assert _http(frontend.url(), bad)[0] == 400, bad
        assert _http(frontend.url(), b"{not json")[0] == 400
        assert _http(frontend.url("/nope"))[0] == 404
    finally:
        frontend.close()
        batcher.close(drain=True)


# ------------------------------------------------------------- paged pool


class TestPagedPool:
    def _pool(self, *, slots=3, blocks=0, **kw):
        return paged_kv.PagedKVPool(num_layers=1, num_slots=slots, num_heads=2, max_len=64,
                                    head_dim=4, block_size=8, num_blocks=blocks,
                                    registry=MetricsRegistry(), **kw)

    def test_exhaustion_is_loud_and_all_or_nothing(self):
        pool = self._pool(blocks=4)  # 3 usable
        slot = pool.alloc()
        pool.assign(slot, pool.alloc_blocks(2))
        with pytest.raises(paged_kv.BlockExhausted, match="exhausted"):
            pool.alloc_blocks(2)
        assert pool._reg().counter_values()["serving/kv_exhausted_total"] == 1
        assert len(pool.alloc_blocks(1)) == 1  # the failed claim leaked nothing
        with pytest.raises(paged_kv.BlockExhausted):
            pool.ensure_position(slot, 16)
        assert pool.block_tables[slot, 2] == paged_kv.NULL_BLOCK
        pool.free(slot)

    def test_reset_leaves_unique_free_ids_and_null_block_never_handed_out(self):
        pool = self._pool(slots=2, blocks=5)
        s = pool.alloc()
        pool.assign(s, pool.alloc_blocks(1))
        pool.insert_prefix(s, list(range(8)))
        pool.free(s)  # published + unreferenced: parked evictable
        pool.reset()
        assert sorted(pool._free_blocks) == [1, 2, 3, 4]
        got = pool.alloc_blocks(4)  # every usable block, evicting the cache
        assert sorted(got) == [1, 2, 3, 4] and paged_kv.NULL_BLOCK not in got
        with pytest.raises(paged_kv.BlockExhausted):
            pool.alloc_blocks(1)

    def test_prefix_lookup_caps_below_the_prompt_and_chain_hashes_match_jax(self):
        pool = self._pool(slots=3, blocks=33)
        prompt = list(range(20))
        assert pool.prefix_lookup(prompt) == ([], 0)
        slot = pool.alloc()
        pool.assign(slot, pool.alloc_blocks(3))
        pool.insert_prefix(slot, prompt)
        hit, c = pool.prefix_lookup(list(range(16)) + [99])
        assert c == 16 and hit == list(pool.block_tables[slot, :2])
        pool.release_prefix(hit)
        hb, c = pool.prefix_lookup(list(range(16)))  # exact blocks: cap at n - 1
        assert c == 8
        pool.release_prefix(hb)
        assert len(pool._cache) == 2  # the partial tail is never published
        assert sorted(pool._chain_hash.values()) == sorted(
            jax_scheduler.prompt_chain_keys(prompt, 8)
        )
        pool.free(slot)


# ----------------------------------------------------- purity and policy


def _imports(path, *, top_level: bool = False):
    """The modules ``path`` imports; with ``top_level``, only those run at
    import time (outside every function body)."""
    tree = ast.parse(open(path).read())
    todo = [tree]
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        if top_level and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        todo.extend(ast.iter_child_nodes(node))


def test_port_imports_no_jax():
    paths = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "chip_probe.py")]
    for root, _, files in os.walk(os.path.join(REPO, "tensorflow_examples_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 15
    rel = {os.path.relpath(p, REPO) for p in paths}
    for new in ("serving/speculative.py", "telemetry/compilation.py", "core/precision.py",
                "utils/faults.py", "utils/diagnostics.py", "data/prefetch.py",
                "telemetry/profiling.py", "models/hf_import.py", "train/graphs.py",
                "serving/overload.py", "telemetry/timeseries.py", "data/tokenizers.py",
                "models/bert.py", "models/resnet.py", "models/mlp.py", "ops/glue_metrics.py",
                "data/augment.py", "native.py", "workloads/bert_glue.py",
                "workloads/cifar10.py", "workloads/mnist.py", "telemetry/tracing.py",
                "telemetry/slo.py", "serving/router.py", "serving/journal.py",
                "serving/supervisor.py", "serving/prober.py", "serving/chaos.py",
                "serve_fleet.py", "data/workers.py", "data/imagenet.py", "data/sources.py",
                "workloads/imagenet.py", "telemetry/memory.py", "telemetry/serve.py",
                "core/distributed.py", "core/mesh.py", "core/collectives.py",
                "core/sharding.py", "sharding/config.py", "sharding/resolve.py",
                "sharding/layout.py", "parallel/ring.py", "parallel/attention.py",
                "telemetry/fleet.py", "serving/mesh_driver.py"):
        assert f"tensorflow_examples_torch/{new}" in rel
    banned = ("jax", "flax", "optax", "absl", "tensorflow_examples_tpu", "tensorflow")
    bad = [(os.path.relpath(p, REPO), m) for p in paths for m in _imports(p)
           if m.split(".")[0] in banned]
    assert not bad, ("the port must not import JAX, its libraries, TensorFlow or the JAX "
                     f"package: {bad}")
    # PIL only inside a function (the CPU tests' plain JPEG decode): the
    # card's machine has none.
    eager_pil = [(os.path.relpath(p, REPO), m) for p in paths
                 for m in _imports(p, top_level=True) if m.split(".")[0] == "PIL"]
    assert not eager_pil, f"PIL imported at import time: {eager_pil}"
    lazy_pil = {os.path.relpath(p, REPO) for p in paths
                if any(m.split(".")[0] == "PIL" for m in _imports(p))}
    assert lazy_pil == {"tensorflow_examples_torch/data/imagenet.py"}


def test_engine_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = smoke_cfgs()
    model = transformer.GPT2(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(cfg, model)
    assert InferenceEngine(cfg, model, device="cpu").device.type == "cpu"


def test_engine_guards():
    _, cfg = smoke_cfgs()
    model = transformer.GPT2(cfg, seed=0)
    for kw, match in ((dict(attention="paged_flash"), "paged pool"),
                      (dict(kv_dtype="int8"), "paged pool"),
                      (dict(attention="ring"), "attention"),
                      (dict(kv_block_size=32, prefill_bucket_floor=16), "divide")):
        with pytest.raises(ValueError, match=match):
            InferenceEngine(cfg, model, cfg=ServeConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        paged_kv.PagedKVPool(num_layers=1, num_slots=1, num_heads=1, max_len=48,
                             head_dim=4, block_size=12)


def test_serve_cli_flags_cover_the_config():
    from tensorflow_examples_torch import serve

    args = serve.build_parser().parse_args(
        ["--num_layers", "2", "--kv_block_size", "16", "--attention", "paged_flash",
         "--prefix_cache", "false", "--max_delay_s", "0.01", "--device", "cpu",
         "--weight_dtype", "int8", "--kv_dtype", "fp8", "--spec_decode_k", "4",
         "--draft_ngram", "2", "--prefill_chunk_tokens", "64", "--cache_dtype", "float32",
         "--compile_warmup", "2"]
    )
    assert (args.num_layers, args.d_model, args.vocab_size) == (2, 768, 50257)
    assert (args.kv_block_size, args.attention, args.prefix_cache) == (16, "paged_flash", False)
    assert args.max_delay_s == 0.01 and args.init_seed == 0 and args.params_npz is None
    assert (args.weight_dtype, args.kv_dtype, args.spec_decode_k, args.draft_ngram,
            args.prefill_chunk_tokens) == ("int8", "fp8", 4, 2, 64)
    assert (args.cache_dtype, args.compile_warmup, args.draft) == ("float32", 2, "ngram")
    with pytest.raises(SystemExit):
        serve.build_parser().parse_args(["--weight_dtype", "int4"])
    # Every ServeConfig field is a flag, so serve.py can pass them all on.
    parsed = vars(serve.build_parser().parse_args([]))
    assert all(f.name in parsed for f in dataclasses.fields(ServeConfig))


# The reference's ServeConfig fields the port does not have yet: none
# since the replica process brought the fleet role, the watchdog and
# brownout.
OWED_TO_A5 = ()


def test_serve_config_has_the_reference_fields_and_defaults():
    ours = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jax_engine.ServeConfig)}
    assert sorted(theirs.keys() - ours.keys()) == sorted(OWED_TO_A5)
    assert not ours.keys() - theirs.keys()
    assert {k: v for k, v in theirs.items() if k in ours} == ours


def test_reference_classify_matches_jax(flax_params):
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    ours = port_engine(flax_params).reference_classify(prompt, top_n=5)
    theirs = jax_engine_for(flax_params).reference_classify(prompt, top_n=5)
    assert [t["token"] for t in ours] == [t["token"] for t in theirs]
    np.testing.assert_allclose([t["logprob"] for t in ours],
                               [t["logprob"] for t in theirs], atol=1e-5)


def test_metrics_rendering_matches_jax():
    from tensorflow_examples_tpu.telemetry.serve import render_prometheus as jax_render
    from tensorflow_examples_torch.telemetry.serve import json_safe, render_prometheus

    regs = (MetricsRegistry(), JaxRegistry())
    for reg in regs:
        reg.counter("serving/requests_total").inc(3)
        reg.gauge("serving/kv_occupancy").set(0.25)
        for s in (0.5, 0.1, 0.3):
            reg.histogram("serving/ttft").record(s)
        reg.histogram("serving/e2e")  # empty: not rendered
    assert render_prometheus(regs[0]) == jax_render(regs[1])
    assert json_safe({"a": [float("nan"), 1.0]}) == {"a": [None, 1.0]}
