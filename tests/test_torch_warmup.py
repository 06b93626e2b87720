"""The warmed zero-recompile contract of the port's serving engine
(PyTorch/CUDA port).

* ``warmup()`` returns the JAX engine's rung names and counts for the
  same config (dense and paged pools, the extend rungs, the verify
  rungs), and ``expected_compiles()`` matches;
* ``post_warmup_recompiles()`` is 0 after mixed traffic and 1 after a
  signature outside the ladder, and the sentinel names the changed axis
  as the reference's does;
* an injected step failure raises ``EngineStepError``, leaves a
  reallocated pool, fails every in-flight request in the batcher and the
  engine serves again;
* a CUDA-graph rung's launch tally, against a stand-in graph on the
  CPU: counters move once a replay, by the launches the capture saw;
* ``/health`` reports ``post_warmup_recompiles`` and the serve CLI warms
  before traffic.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.models import transformer as jax_transformer
from tensorflow_examples_tpu.serving import engine as jax_engine
from tensorflow_examples_tpu.telemetry import compilation as jax_compilation
from tensorflow_examples_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from tensorflow_examples_torch.models import transformer
from tensorflow_examples_torch.serving import engine as engine_mod
from tensorflow_examples_torch.serving.batcher import ContinuousBatcher, Request
from tensorflow_examples_torch.serving.engine import EngineStepError, InferenceEngine, ServeConfig
from tensorflow_examples_torch.serving.frontend import ServingFrontend
from tensorflow_examples_torch.telemetry import compilation
from tensorflow_examples_torch.telemetry.registry import MetricsRegistry

SMOKE = dict(vocab_size=211, max_len=64, num_layers=2, num_heads=2, d_model=32)
BASE = dict(max_slots=4, prefill_bucket_floor=16, kv_bucket_floor=32)
LADDERS = {
    "dense": {},
    "dense_spec": dict(spec_decode_k=3),
    "paged_spec_chunked": dict(kv_block_size=8, spec_decode_k=3, prefill_chunk_tokens=16),
    "paged_no_prefix_cache": dict(kv_block_size=8, prefix_cache=False),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return transformer.GPT2(transformer.TransformerConfig(**SMOKE), seed=1)


def port(model, **kw):
    return InferenceEngine(transformer.TransformerConfig(**SMOKE), model,
                           cfg=ServeConfig(**BASE, max_delay_s=0.002, **kw),
                           registry=MetricsRegistry(), device="cpu")


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", sorted(LADDERS))
def test_warmup_counts_match_jax(model, name):
    kw = LADDERS[name]
    ours = port(model, **kw)
    counts = ours.warmup()
    jax_cfg = jax_transformer.TransformerConfig(**SMOKE, dropout=0.0, attention="xla")
    params = jax_transformer.Transformer(jax_cfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32))["params"]
    theirs = jax_engine.InferenceEngine(jax_cfg, params, cfg=jax_engine.ServeConfig(**BASE, **kw),
                                        registry=JaxRegistry())
    assert counts == theirs.warmup()
    assert ours.expected_compiles() == theirs.expected_compiles() == sum(counts.values())
    assert set(counts.values()) == {1}
    assert ours.post_warmup_recompiles() == theirs.post_warmup_recompiles() == 0
    assert ours.pool.active_slots == 0 and ours.warmed


@pytest.mark.timeout(300)
def test_no_recompile_under_mixed_traffic_then_one_outside_the_ladder(model):
    eng = port(model, kv_block_size=8, spec_decode_k=3, prefill_chunk_tokens=16)
    eng.warmup()
    rng = np.random.default_rng(2)
    reqs = [Request(prompt=[int(t) for t in rng.integers(0, 211, n)], max_new_tokens=m,
                    temperature=(0.0, 0.9)[i % 2], seed=i)
            for i, (n, m) in enumerate(((1, 3), (17, 9), (40, 12), (60, 4), (33, 20), (5, 50)))]
    batcher = ContinuousBatcher(eng).start()
    try:
        for f in [batcher.submit(r) for r in reqs]:
            f.result(timeout=120)
    finally:
        batcher.close(drain=True)
    assert eng.post_warmup_recompiles() == 0
    assert eng.registry.counter_values().get("compile/recompiles", 0) == 0
    # A decode step at a batch the ladder never holds: one recompile, and
    # the sentinel's event names the axis (as the reference's would).
    s = eng.cfg.max_slots + 1
    eng._decode_fns[32](np.zeros(s, np.int64), np.zeros(s, np.int64),
                        np.zeros((s, 4), np.int32))
    assert eng.post_warmup_recompiles() == 1
    assert eng.registry.counter_values()["compile/recompiles"] == 1
    assert "axis 0: 4->5" in eng.sentinel.events[-1]["delta"]


def test_sentinel_signatures_and_deltas_match_jax():
    old = ((np.zeros((4, 8), np.int32), 3),)
    new = ((np.zeros((4, 16), np.int32), 3),)
    ours = compilation.describe_delta(compilation.abstract_signature(old, {}),
                                      compilation.abstract_signature(new, {}))
    assert "shape (4, 8)->(4, 16) (axis 1: 8->16)" in ours
    theirs = jax_compilation.describe_delta(jax_compilation.abstract_signature(old, {}),
                                            jax_compilation.abstract_signature(new, {}))
    assert "shape (4, 8)->(4, 16) (axis 1: 8->16)" in theirs
    assert compilation.describe_delta(None, new) == jax_compilation.describe_delta(None, new)
    assert compilation.fast_signature(old, {}) == compilation.fast_signature(
        ((np.ones((4, 8), np.int32), 7),), {})
    sentinel = compilation.CompilationSentinel(warmup=1, registry=MetricsRegistry())
    fn = sentinel.wrap(lambda x: x, "f")
    for shape in ((2,), (2,), (3,)):
        fn(np.zeros(shape))
    assert sentinel.compile_counts() == {"f": 2} and sentinel.post_warmup_recompiles() == 1
    sentinel.invalidate("f")
    fn(np.zeros((3,)))
    assert sentinel.post_warmup_recompiles() == 2
    assert sentinel.wrap(None, "none") is None


def test_step_failure_reallocates_and_fails_the_batch(model):
    eng = port(model, kv_block_size=8)
    eng.warmup()
    slot = eng.pool.alloc()
    tok, _ = eng.prefill(slot, [1, 2, 3, 4, 5, 6, 7, 8, 9])
    old_k = eng.pool.k
    orig = eng._decode_fns

    def boom(*a, **kw):
        raise RuntimeError("device lost")

    eng._decode_fns = {kb: boom for kb in orig}
    try:
        with pytest.raises(EngineStepError, match="decode step"):
            eng.decode([(slot, tok, 0, 0.0, 0)])
    finally:
        eng._decode_fns = orig
    assert eng.pool.k is not old_k and not eng.pool.k.any()
    assert not eng.pool._cache  # the prefix cache lived in the old arrays
    eng.pool.free(slot)
    slot = eng.pool.alloc()
    tok, _ = eng.prefill(slot, [1, 2, 3])
    assert eng.decode([(slot, tok, 0, 0.0, 0)])[slot] == eng.reference_generate([1, 2, 3],
                                                                                max_new=2)[1]
    eng.pool.free(slot)
    # In the batcher: a failed step fails every in-flight request.
    eng._decode_fns = {kb: boom for kb in orig}
    batcher = ContinuousBatcher(eng).start()
    try:
        futs = [batcher.submit(Request(prompt=[i + 1, 2, 3], max_new_tokens=4)) for i in range(3)]
        for f in futs:
            with pytest.raises(EngineStepError):
                f.result(timeout=60)
    finally:
        batcher.close(drain=False)
        eng._decode_fns = orig
    assert eng.pool.active_slots == 0


class _StubGraph:
    """A CUDA graph stand-in: a replay runs no Python, so the kernel
    wrappers' counters do not move by themselves."""

    replays = 0

    def replay(self):
        _StubGraph.replays += 1


def _kernel():
    _kernel.launches += 1
    _kernel.split_launches += 2


_kernel.launches = _kernel.split_launches = 0


def test_graph_rung_launch_tally_on_a_stub_graph():
    import contextlib

    def step(x):
        for _ in range(3):
            _kernel()
        return x * 2

    rung = engine_mod.GraphRung(step, torch.device("cpu"), kernels=[_kernel],
                                graph_cls=_StubGraph, capture=lambda g: contextlib.nullcontext())
    out = rung(np.array([5]))
    # Warm-up run (3 real launches), capture (taken back out), first replay.
    assert (_kernel.launches, _kernel.split_launches) == (6, 12)
    for _ in range(4):
        rung(np.array([7]))
    assert (_kernel.launches, _kernel.split_launches) == (6 + 12, 12 + 24)
    assert _StubGraph.replays == 5 and rung.captured == 1 and int(out[0]) == 10
    assert rung.tallies() == [{"_kernel.launches": 3, "_kernel.split_launches": 6}]
    rung(np.array([1, 2]))  # a new signature: a second graph
    assert rung.captured == 2
    rung.reset()
    assert rung.captured == 0


class _Stop(Exception):
    pass


def test_health_reports_recompiles_and_serve_warms(model, monkeypatch):
    eng = port(model, kv_block_size=8)
    eng.warmup()
    batcher = ContinuousBatcher(eng).start()
    frontend = ServingFrontend(batcher).start()
    try:
        with urllib.request.urlopen(frontend.url("/health"), timeout=30) as r:
            health = json.loads(r.read())
        assert health["post_warmup_recompiles"] == 0
        line = batcher.stats_line()
        assert line["kind"] == "serving" and line["serving"]["post_warmup_recompiles"] == 0
    finally:
        frontend.close()
        batcher.close(drain=True)
    from tensorflow_examples_torch import serve

    warmed = []
    monkeypatch.setattr(InferenceEngine, "warmup", lambda self: warmed.append(self) or {})

    def stop(engine):  # the batcher starts after the warmup: stop there
        assert warmed == [engine]
        raise _Stop

    monkeypatch.setattr(serve, "ContinuousBatcher", stop)
    with pytest.raises(_Stop):
        serve.main(["--device", "cpu", "--num_layers", "1", "--d_model", "32", "--num_heads",
                    "2", "--vocab_size", "64", "--max_len", "64"])
    assert len(warmed) == 1
