"""Speculative decoding and chunked prefill in the port's serving engine,
against the JAX engine (PyTorch/CUDA port).

At the smoke model (``tools/serve_bench.SMOKE_MODEL``: 2 layers, d 32, 2
heads, max_len 64) with the same flax-initialized weights, on the CPU:

* the n-gram drafter and the acceptance rule equal the JAX package's on
  seeded sequences;
* the verify forward's logits, dense and paged, f32 and int8 KV, are
  within atol 1e-5 of the JAX engine's on the same cache;
* streams with ``spec_decode_k=3`` (greedy, and sampled at temperature
  0.8, top-k 20) are token-identical to the JAX engine's speculative
  streams, to the port's streams with speculation off and to the
  cacheless ``reference_generate``, on the dense and the paged pool, and
  an eos inside a verify window drops the window's later tokens;
* with ``prefill_chunk_tokens=16`` (block 8) a stream equals the
  unchunked one and the JAX engine's, and a chunked prefill that decode
  steps interleave with gives the cacheless logits within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.models import transformer as jax_transformer
from tensorflow_examples_tpu.serving import engine as jax_engine
from tensorflow_examples_tpu.serving import speculative as jax_spec
from tensorflow_examples_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from tensorflow_examples_torch.models import transformer
from tensorflow_examples_torch.serving import engine as port_engine_mod
from tensorflow_examples_torch.serving import speculative
from tensorflow_examples_torch.serving.batcher import ContinuousBatcher, Request
from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
from tensorflow_examples_torch.telemetry.registry import MetricsRegistry

SMOKE = dict(vocab_size=211, max_len=64, num_layers=2, num_heads=2, d_model=32)
BASE = dict(max_slots=4, prefill_bucket_floor=16, kv_bucket_floor=32, max_delay_s=0.002)
POOLS = {"dense": {}, "paged": dict(kv_block_size=8)}
K = 3


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
                           cfg=ServeConfig(**{**BASE, **kw}), registry=MetricsRegistry(),
                           device="cpu")


def jax_eng(params, **kw):
    kw = {k: v for k, v in {**BASE, **kw}.items() if k != "max_delay_s"}
    cfg = jax_transformer.TransformerConfig(**SMOKE, dropout=0.0, attention="xla")
    return jax_engine.InferenceEngine(cfg, jax.tree.map(jnp.asarray, params),
                                      cfg=jax_engine.ServeConfig(**kw), registry=JaxRegistry())


class OracleDraft(speculative.DraftSource):
    """Proposes each request's known continuation: every draft is
    accepted, so verify windows commit k + 1 tokens."""

    def __init__(self, continuations: dict):
        self.cont, self.done = continuations, {}

    def begin(self, slot, ctx):
        self.done[slot] = 1

    def extend(self, slot, tokens):
        self.done[slot] += len(tokens)

    def propose(self, slot, k):
        return list(self.cont[slot][self.done[slot]:self.done[slot] + k])

    def end(self, slot):
        self.done.pop(slot, None)


def spec_drive(engine, requests, draft, k=K):
    """The batcher's speculative loop over either package's engine
    (``k=0``: plain decode steps only): ``requests`` are (prompt,
    max_new, temperature, top_k, seed, eos_id); returns each stream and
    the step commits of request 0."""
    slots, streams, commits = [], [], []
    for prompt, _, temp, top_k, seed, _ in requests:
        slot = engine.pool.alloc()
        tok, _ = engine.prefill(slot, prompt, seed=seed, temperature=temp, top_k=top_k)
        slots.append(slot)
        streams.append([tok])
        draft.begin(slot, list(prompt) + [tok])
    live = [i for i, r in enumerate(requests) if not (r[5] is not None and streams[i][0] == r[5])
            and r[1] > 1]
    while live:
        entries = []
        for i in live:
            _, max_new, temp, top_k, seed, _ = requests[i]
            k_eff = min(k, max_new - len(streams[i]) - 1)
            drafts = draft.propose(slots[i], k_eff) if k_eff > 0 else []
            entries.append((slots[i], streams[i][-1], drafts, seed, temp, top_k))
        if any(e[2] for e in entries):
            out = engine.verify(entries)
        else:
            out = {s: [t] for s, t in engine.decode(
                [(s, t, seed, temp, tk) for s, t, _, seed, temp, tk in entries]).items()}
        for i in list(live):
            toks, eos = out[slots[i]], requests[i][5]
            if i == 0:
                commits.append(list(toks))
            kept = []
            for t in toks:
                kept.append(t)
                if eos is not None and t == eos:
                    break
            streams[i] += kept
            draft.extend(slots[i], kept)
            if len(streams[i]) >= requests[i][1] or (eos is not None and kept[-1] == eos):
                live.remove(i)
    for slot in slots:
        draft.end(slot)
        engine.pool.free(slot)
    return streams, commits


def motif_requests(seed, *, temp=0.0, top_k=0, max_new=12):
    rng = np.random.default_rng(seed)
    motif = [int(t) for t in rng.integers(0, 211, 5)]
    return [((motif * 10)[:n], max_new, temp, top_k, 10 + i, None)
            for i, n in enumerate((6, 13, 21, 34))]


# ------------------------------------------------------------- drafter


def test_ngram_draft_and_acceptance_match_jax():
    rng = np.random.default_rng(0)
    for trial in range(20):
        period = int(rng.integers(1, 6))
        base = [int(t) for t in rng.integers(0, 9, period)]
        ctx = (base * 12)[:int(rng.integers(1, 40))] + [int(t) for t in rng.integers(0, 9, 3)]
        ours = speculative.NgramDraft(max_ngram=3)
        theirs = jax_spec.NgramDraft(max_ngram=3)
        ours.begin(0, ctx[:5])
        theirs.begin(0, ctx[:5])
        ours.extend(0, ctx[5:])
        theirs.extend(0, ctx[5:])
        for k in (0, 1, 3, 7):
            assert ours.propose(0, k) == theirs.propose(0, k), (trial, ctx, k)
        drafts = [int(t) for t in rng.integers(0, 4, 4)]
        sampled = [int(t) for t in rng.integers(0, 4, 5)]
        for limit in (1, 2, 5):
            assert speculative.accept_drafts(drafts, sampled, limit=limit) == \
                jax_spec.accept_drafts(drafts, sampled, limit=limit)
    cfg = ServeConfig(draft_ngram=4)
    assert speculative.make_draft(cfg).max_ngram == 4
    with pytest.raises(ValueError, match="draft"):
        speculative.make_draft(ServeConfig(draft="model"))


# ------------------------------------------------------ verify forward


@pytest.mark.parametrize("name", ["dense", "paged", "paged_int8"])
def test_verify_forward_logits_match_jax(flax_params, name):
    """The same prompts prefilled into both engines, then one verify
    forward over the same [S, T] tokens: logits within 1e-5."""
    kw = {"dense": {}, "paged": dict(kv_block_size=8),
          "paged_int8": dict(kv_block_size=8, kv_dtype="int8")}[name]
    ours, theirs = port(flax_params, spec_decode_k=K, **kw), jax_eng(flax_params, spec_decode_k=K, **kw)
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, 211, n)] for n in (3, 17, 29)]
    for eng in (ours, theirs):
        for p in prompts:
            eng.prefill(eng.pool.alloc(), p)
    s_n, t_n = BASE["max_slots"], K + 1
    tokens = rng.integers(0, 211, (s_n, t_n))
    positions = np.array([len(p) for p in prompts] + [0])
    kb = 64
    if name == "dense":
        logits = port_engine_mod._verify_forward(
            ours.model, ours.pool.k, ours.pool.v, torch.from_numpy(tokens),
            torch.from_numpy(positions), kv_bucket=kb)
        _, _, ref = jax_engine._verify_forward(
            theirs.model_cfg, theirs.params, theirs.pool.k, theirs.pool.v,
            jnp.asarray(tokens, jnp.int32), jnp.asarray(positions, jnp.int32), kv_bucket=kb)
    else:
        for eng in (ours, theirs):
            for slot, p in enumerate(prompts):
                eng.pool.ensure_position(slot, len(p) + t_n - 1)
        tables = np.ascontiguousarray(ours.pool.block_tables[:, :kb // 8])
        np.testing.assert_array_equal(tables, theirs.pool.block_tables[:, :kb // 8])
        logits = port_engine_mod._paged_verify_forward(
            ours.model, ours.pool.kv_state(), torch.from_numpy(tokens),
            torch.from_numpy(positions), torch.from_numpy(tables), block_size=8)
        _, ref = jax_engine._paged_verify_forward(
            theirs.model_cfg, theirs.params, theirs.pool.kv_state(),
            jnp.asarray(tokens, jnp.int32), jnp.asarray(positions, jnp.int32),
            jnp.asarray(tables), block_size=8)
    assert logits.shape == (s_n, t_n, 211)
    np.testing.assert_allclose(logits[:3].numpy(), np.asarray(ref)[:3], atol=1e-5, rtol=0)


# --------------------------------------------------------------- streams


@pytest.mark.timeout(300)
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_spec_streams_match_jax_plain_and_reference(flax_params, pool, sampled):
    kw = POOLS[pool]
    reqs = motif_requests(3, temp=0.8 if sampled else 0.0, top_k=20 if sampled else 0)
    ours = port(flax_params, spec_decode_k=K, **kw)
    streams, _ = spec_drive(ours, reqs, speculative.NgramDraft(max_ngram=3))
    theirs, _ = spec_drive(jax_eng(flax_params, spec_decode_k=K, **kw), reqs,
                           jax_spec.NgramDraft(max_ngram=3))
    plain, _ = spec_drive(port(flax_params, **kw), reqs, speculative.NgramDraft(), k=0)
    counters = ours.registry.counter_values()
    assert counters["serving/spec_drafted_total"] > 0
    if not sampled:
        assert counters["serving/spec_accepted_total"] > 0
    for (prompt, max_new, temp, top_k, seed, _), a, b, c in zip(reqs, streams, theirs, plain):
        ref = ours.reference_generate(prompt, max_new=max_new, seed=seed, temperature=temp,
                                      top_k=top_k)
        assert a == b == c == ref, (len(prompt), a, b, c, ref)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_eos_inside_a_verify_window(flax_params, pool):
    """Every draft accepted (the drafter knows the continuation), so a
    step commits k + 1 tokens; an eos in the middle of such a window ends
    the stream there, in both packages, as it ends the reference's."""
    kw = POOLS[pool]
    ours = port(flax_params, spec_decode_k=K, **kw)
    prompt = motif_requests(5)[2][0]
    ref = ours.reference_generate(prompt, max_new=14, seed=4, temperature=0.8, top_k=20)
    # A token whose first appearance sits inside a full window (stream
    # index 1 + 4w + i, i in 0..2), not at its end.
    j = next(j for j in range(2, 12) if (j - 1) % (K + 1) != K and ref[j] not in ref[:j])
    reqs = [(prompt, 14, 0.8, 20, 4, ref[j])]
    streams = {}
    for label, eng in (("port", ours), ("jax", jax_eng(flax_params, spec_decode_k=K, **kw))):
        streams[label], commits = spec_drive(eng, reqs, OracleDraft({0: ref}))
        assert any(len(c) == K + 1 for c in commits)
        assert any(ref[j] in c[:-1] for c in commits), commits  # eos mid-window
    assert streams["port"][0] == streams["jax"][0] == ref[:j + 1]


@pytest.mark.timeout(300)
def test_batcher_spec_and_chunks_equal_reference(flax_params):
    """The batcher's propose / verify / commit loop and its chunk turns
    together (paged, spec_decode_k=3, chunks of 16): 8 concurrent mixed
    requests, greedy and sampled, equal the cacheless replays; drafts are
    accepted and chunked prefills ran beside decode steps."""
    eng = port(flax_params, kv_block_size=8, spec_decode_k=K, prefill_chunk_tokens=16)
    eng.warmup()
    rng = np.random.default_rng(11)
    reqs = []
    for i, n in enumerate((4, 45, 9, 37, 20, 50, 14, 33)):
        motif = [int(t) for t in rng.integers(0, 211, 1 + i % 4)]
        temp, top_k = ((0.0, 0), (0.8, 20))[i % 2]
        reqs.append(Request(prompt=(motif * 60)[:n], max_new_tokens=10, temperature=temp,
                            top_k=top_k, seed=i))
    batcher = ContinuousBatcher(eng).start()
    try:
        results = [f.result(timeout=120) for f in [batcher.submit(r) for r in reqs]]
        line = batcher.stats_line()
    finally:
        batcher.close(drain=True)
    for req, res in zip(reqs, results):
        assert res.tokens == eng.reference_generate(
            req.prompt, max_new=req.max_new_tokens, seed=req.seed,
            temperature=req.temperature, top_k=req.top_k), len(req.prompt)
    counters = eng.registry.counter_values()
    assert counters["serving/spec_accepted_total"] == sum(r.spec_accepted for r in results) > 0
    assert counters["serving/chunked_prefills"] >= 3
    assert counters["serving/prefill_chunks"] > counters["serving/chunked_prefills"]
    assert line["serving"]["spec_k"] == K and line["serving"]["draft_hit_rate"] > 0
    assert line["serving"]["post_warmup_recompiles"] == 0
    assert eng.pool.active_slots == 0


# ------------------------------------------------------- chunked prefill


@pytest.mark.timeout(300)
def test_chunked_prefill_matches_unchunked_and_jax(flax_params):
    rng = np.random.default_rng(21)
    prompt = [int(t) for t in rng.integers(0, 211, 41)]
    streams = {}
    for label, eng in (("chunked", port(flax_params, kv_block_size=8, prefill_chunk_tokens=16)),
                       ("jax", jax_eng(flax_params, kv_block_size=8, prefill_chunk_tokens=16)),
                       ("plain", port(flax_params, kv_block_size=8))):
        slot = eng.pool.alloc()
        state = eng.prefill_open(slot, prompt, seed=2, temperature=0.8, top_k=20)
        if label == "plain":
            assert state is None
            tok, last = eng.prefill(slot, prompt, seed=2, temperature=0.8, top_k=20)
        else:
            assert state.spans == [(0, 16), (16, 32), (32, 41)]
            done = False
            while not done:
                done, tok, last = eng.prefill_step(state)
        seq = [tok]
        for _ in range(7):
            seq.append(eng.decode([(slot, seq[-1], 2, 0.8, 20)])[slot])
        eng.pool.free(slot)
        streams[label] = (seq, np.asarray(last))
    assert streams["chunked"][0] == streams["jax"][0] == streams["plain"][0]
    np.testing.assert_allclose(streams["chunked"][1], streams["jax"][1], atol=1e-5, rtol=0)


def test_chunks_interleaved_with_decode_keep_their_cache(flax_params):
    """A decode step of another slot between chunks must not write into
    the prefilling slot's blocks: the chunked logits stay within 1e-5 of
    the cacheless forward's."""
    eng = port(flax_params, kv_block_size=8, prefill_chunk_tokens=16)
    rng = np.random.default_rng(5)
    other, prompt = [int(t) for t in rng.integers(0, 211, 5)], [int(t) for t in rng.integers(0, 211, 40)]
    a = eng.pool.alloc()
    tok_a, _ = eng.prefill(a, other)
    b = eng.pool.alloc()
    state = eng.prefill_open(b, prompt)
    done = False
    while not done:
        tok_a = eng.decode([(a, tok_a, 0, 0.0, 0)])[a]
        done, _, last = eng.prefill_step(state)
    np.testing.assert_allclose(last, eng.reference_logits(prompt).numpy(), atol=1e-5, rtol=0)
    for slot in (a, b):
        eng.pool.free(slot)


def test_config_guards():
    model = transformer.GPT2(transformer.TransformerConfig(**SMOKE), seed=0)
    for kw, match in ((dict(spec_decode_k=-1), "spec_decode_k"),
                      (dict(spec_decode_k=16), "prefill_bucket_floor"),
                      (dict(prefill_chunk_tokens=16), "paged pool"),
                      (dict(prefill_chunk_tokens=16, kv_block_size=8, prefix_cache=False),
                       "prefix_cache"),
                      (dict(prefill_chunk_tokens=12, kv_block_size=8), "multiple"),
                      (dict(prefill_chunk_tokens=-1), ">= 0")):
        with pytest.raises(ValueError, match=match):
            InferenceEngine(transformer.TransformerConfig(**SMOKE), model,
                            cfg=ServeConfig(**kw), device="cpu")
    eng = port(model)
    with pytest.raises(RuntimeError, match="spec_decode_k"):
        eng.verify([(0, 1, [2], 0, 0.0, 0)])
