"""The port's serving replica (engine, batcher, frontend) against the JAX
package's (PyTorch/CUDA port).

* Every endpoint answers a table of bodies (valid and malformed ones,
  ``text`` with and without a tokenizer, ``top_n``, the hand-off verbs,
  an oversized ``/resume``) with the reference frontend's status codes
  and reply keys; greedy tokens are equal; ``/classify``'s ``top``
  equals the reference's at 1e-5; ``/health`` carries the reference's
  keys.
* SLO classes: an interactive arrival preempts a batch request, whose
  tokens equal its unpreempted stream; the brownout ladder sheds batch
  before interactive and clears. ``stats_line()`` carries the V10 keys
  and passes the reference's ``telemetry/schema.validate_line``.
* The reference's ``serving.router.Router``, unmodified and in-process,
  serves ``/generate`` over a port prefill-role and a port decode-role
  replica through ``/prefill`` -> ``/resume``: a JAX mixed engine's
  tokens, and a second prompt on the same prefix travels as a delta.
* The drain (``run_until_preempted``) and the serve faults.

The smoke model of ``tests/test_torch_warmup.py`` (two layers, d_model
32) on the paged pool with block 16, on the CPU.
"""

import concurrent.futures
import http.client
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_examples_tpu.models import transformer as jax_transformer
from tensorflow_examples_tpu.serving import engine as jax_engine
from tensorflow_examples_tpu.serving.batcher import ContinuousBatcher as JaxBatcher
from tensorflow_examples_tpu.serving.frontend import ServingFrontend as JaxFrontend
from tensorflow_examples_tpu.serving.router import Router, RouterConfig
from tensorflow_examples_tpu.telemetry import schema as jax_schema
from tensorflow_examples_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from tensorflow_examples_torch.data.tokenizers import ByteTokenizer
from tensorflow_examples_torch.models import transformer
from tensorflow_examples_torch.serving.batcher import ContinuousBatcher, QueueFull, Request
from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
from tensorflow_examples_torch.serving.frontend import ServingFrontend, run_until_preempted
from tensorflow_examples_torch.telemetry.registry import MetricsRegistry
from tensorflow_examples_torch.telemetry.schema import SERVING_KEYS_V10
from tensorflow_examples_torch.utils import faults

SMOKE = dict(vocab_size=211, max_len=64, num_layers=2, num_heads=2, d_model=32)
BASE = dict(max_slots=4, prefill_bucket_floor=16, kv_bucket_floor=32, kv_block_size=16,
            max_delay_s=0.002)


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
        {"params": jax.random.PRNGKey(5)}, jnp.zeros((1, 8), jnp.int32))["params"]
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


class Stack:
    """Engine + started batcher + started frontend."""

    def __init__(self, engine, batcher_cls, frontend_cls, tokenizer=None):
        self.engine = engine
        self.batcher = batcher_cls(engine).start()
        self.frontend = frontend_cls(self.batcher, tokenizer=tokenizer).start()

    def url(self, path="/generate"):
        return self.frontend.url(path)

    def close(self):
        self.frontend.close()
        self.batcher.close(drain=True)


def port_stack(params, tokenizer=None, **kw):
    return Stack(port_engine(params, **kw), ContinuousBatcher, ServingFrontend, tokenizer)


def jax_stack(params, tokenizer=None, **kw):
    return Stack(jax_engine_for(params, **kw), JaxBatcher, JaxFrontend, tokenizer)


@pytest.fixture(scope="module")
def stacks(flax_params):
    pair = {"port": port_stack(flax_params, tokenizer=ByteTokenizer()),
            "jax": jax_stack(flax_params, tokenizer=ByteTokenizer())}
    yield pair
    for s in pair.values():
        s.close()


def _http(url, body=None, timeout=60):
    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                    timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _declared_length(url, path, length):
    """POST with a Content-Length header and no body: the size check
    answers before reading."""
    host, port = url.split("//")[1].split("/")[0].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    conn.putrequest("POST", path)
    conn.putheader("Content-Length", str(length))
    conn.endheaders()
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


# ----------------------------------------------------------- the table

P = [int(t) for t in np.random.default_rng(1).integers(0, 211, 21)]
TABLE = [
    ("generate", {"prompt": P, "max_new_tokens": 4}),
    ("generate", {"prompt": P[:5], "max_new_tokens": 3, "slo": "batch", "top_n": 2,
                  "request_id": "r1", "resume_from": 0, "probe": True, "trace": {"x": 1}}),
    ("generate", {"text": "hello there", "max_new_tokens": 3}),
    ("generate", {"text": 5}),
    ("generate", {"prompt": []}),
    ("generate", {"prompt": [1], "bogus": 1}),
    ("generate", {"prompt": [1], "skip_tokens": 16}),
    ("generate", {"prompt": [1], "max_new_tokens": 1.5}),
    ("generate", {"prompt": [1], "seed": -1}),
    ("generate", {"prompt": [1], "slo": "gold"}),
    ("generate", {"prompt": [True]}),
    ("generate", {"prompt": [300]}),
    ("generate", {"prompt": [1] * 60, "max_new_tokens": 8}),
    ("generate", {"prompt": [1], "deadline_s": 0.0}),
    ("generate", [1, 2]),
    ("classify", {"prompt": P, "top_n": 3}),
    ("classify", {"prompt": P, "max_new_tokens": 60}),
    ("classify", {"prompt": P, "top_n": 0}),
    ("prefill", {"prompt": P, "seed": 3, "temperature": 0.8, "top_k": 40}),
    ("prefill", {"prompt": P, "skip_tokens": 16}),
    ("prefill", {"prompt": P, "skip_tokens": -1}),
    ("prefill", {"prompt": P, "pages": {}}),
    ("resume", {"prompt": P}),
    ("resume", {"prompt": P, "pages": [], "first_token": 1}),
    ("resume", {"prompt": P, "pages": {}, "first_token": True}),
    ("resume", {"prompt": P, "pages": {}, "first_token": 300}),
    ("resume", {"prompt": P, "pages": {"version": 9}, "first_token": 3}),
    ("resume", {"prompt": P, "pages": {}, "first_token": 3, "skip_tokens": 16}),
]


def _compare(stacks, kind, body):
    replies = {}
    for name, stack in stacks.items():
        replies[name] = stack.frontend.handle_request(body, kind=kind)
    (s_ours, r_ours), (s_theirs, r_theirs) = replies["port"], replies["jax"]
    assert s_ours == s_theirs, (kind, body, r_ours, r_theirs)
    assert set(r_ours) == set(r_theirs), (kind, body)
    return replies


@pytest.mark.timeout(300)
def test_every_endpoint_answers_the_reference_contract(stacks, flax_params):
    for kind, body in TABLE:
        replies = _compare(stacks, kind, body)
        status, ours = replies["port"]
        theirs = replies["jax"][1]
        if status == 200 and kind == "generate":
            assert ours["tokens"] == theirs["tokens"] and ours["text"] == theirs["text"]
        if status == 200 and kind == "prefill":
            assert ours["first_token"] == theirs["first_token"]
            assert json.loads(json.dumps(ours["pages"]))["arrays"]["k"]["shape"] == \
                theirs["pages"]["arrays"]["k"]["shape"]
    # Without a tokenizer, text is refused alike.
    for stack in stacks.values():
        stack.frontend.tokenizer = None
    try:
        _compare(stacks, "generate", {"text": "hello"})
        _compare(stacks, "generate", {"prompt": P[:3], "max_new_tokens": 2})
    finally:
        for stack in stacks.values():
            stack.frontend.tokenizer = ByteTokenizer()
    # The hand-off pair within each package, and across them.
    pages = {name: s.frontend.handle_request({"prompt": P}, kind="prefill")[1]
             for name, s in stacks.items()}
    for src in ("port", "jax"):
        body = {"prompt": P, "max_new_tokens": 5, "pages": pages[src]["pages"],
                "first_token": pages[src]["first_token"]}
        replies = _compare(stacks, "resume", body)
        assert replies["port"][0] == 200
        assert replies["port"][1]["tokens"] == replies["jax"][1]["tokens"] == \
            stacks["port"].frontend.handle_request({"prompt": P, "max_new_tokens": 5})[1]["tokens"]
    # Another pool's geometry: a 400 naming it, in both packages.
    other = port_engine(flax_params, kv_block_size=8, prefill_bucket_floor=16)
    slot = other.pool.alloc()
    first, _ = other.prefill(slot, P)
    wrong = json.loads(json.dumps(other.export_kv_pages(slot, P)))
    replies = _compare(stacks, "resume", {"prompt": P, "pages": wrong, "first_token": first})
    assert replies["port"] == (400, {"error": "pages geometry mismatch: block_size=8 but "
                                              "this replica serves block_size=16"})
    assert replies["port"] == replies["jax"]


@pytest.mark.timeout(120)
def test_http_surface_matches_the_reference(stacks):
    for path in ("/nope", "/"):
        got = {n: _http(s.url(path)) for n, s in stacks.items()}
        assert got["port"] == got["jax"] and got["port"][0] == 404
    got = {n: _http(s.url("/nope"), {"prompt": [1]}) for n, s in stacks.items()}
    assert got["port"] == got["jax"] and got["port"][0] == 404
    assert {_http(s.url(), b"{not json")[0] for s in stacks.values()} == {400}
    for path, size in (("/resume", (256 << 20) + 1), ("/generate", (1 << 20) + 1)):
        got = {n: _declared_length(s.url(), path, size) for n, s in stacks.items()}
        assert got["port"] == got["jax"] and got["port"][0] == 413
    for path in ("/window", "/series", "/metrics"):
        assert {_http(s.url(path))[0] for s in stacks.values()} == {200}
    window = json.loads(_http(stacks["port"].url("/window"))[1])
    assert window["kind"] == "serving" and window["schema_version"] == 14
    health = {n: json.loads(_http(s.url("/health"))[1]) for n, s in stacks.items()}
    assert set(health["port"]) == set(health["jax"])
    for key in ("role", "warmed", "brownout_level", "prefix_block_size", "digest_truncated"):
        assert health["port"][key] == health["jax"][key], key
    assert health["port"]["prefix_digest"] == health["jax"]["prefix_digest"] != []


@pytest.mark.timeout(120)
def test_classify_top_matches_the_reference(stacks):
    for prompt in (P, P[:1], P[3:19]):
        replies = _compare(stacks, "classify", {"prompt": prompt, "top_n": 7})
        ours, theirs = replies["port"][1]["top"], replies["jax"][1]["top"]
        assert [t["token"] for t in ours] == [t["token"] for t in theirs]
        np.testing.assert_allclose([t["logprob"] for t in ours],
                                   [t["logprob"] for t in theirs], atol=1e-5)


@pytest.mark.timeout(120)
def test_health_with_a_watchdog_and_the_roles(flax_params):
    ours = port_stack(flax_params, watchdog_secs=30.0, role="decode")
    theirs = jax_stack(flax_params, watchdog_secs=30.0, role="decode")
    try:
        a, b = ours.frontend.health_payload(), theirs.frontend.health_payload()
        assert a[0] == b[0] == 200 and set(a[1]) == set(b[1])
        assert a[1]["role"] == "decode" and a[1]["phase"].startswith("serve_")
    finally:
        ours.close()
        theirs.close()
    with pytest.raises(ValueError, match="role="):
        port_engine(flax_params, role="router")


# ------------------------------------------------------- SLO classes


def _wait(cond, timeout=30.0):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, "timed out"
        time.sleep(0.002)


@pytest.mark.timeout(240)
def test_preempted_batch_requests_regenerate_their_tokens(flax_params):
    """Two slots full of batch requests; two interactive arrivals preempt
    them; every batch stream equals its solo replay, sampled ones too.
    The stats line then carries the V10 keys and passes the reference's
    validator."""
    eng = port_engine(flax_params, max_slots=2)
    batcher = ContinuousBatcher(eng).start()
    try:
        batch = [Request(prompt=P[:10 + i], max_new_tokens=40, slo="batch", seed=i,
                         temperature=(0.0, 0.9)[i], top_k=(0, 20)[i]) for i in range(2)]
        futs = [batcher.submit(r) for r in batch]
        _wait(lambda: len(batcher._active) == 2)
        inter = [batcher.submit(Request(prompt=P[:4 + i], max_new_tokens=4, seed=7 + i))
                 for i in range(2)]
        results = [f.result(timeout=120) for f in futs + inter]
    finally:
        batcher.close(drain=True)
    line = batcher.stats_line()
    assert line["serving"]["preempted_batch"] >= 1
    for req, res in zip(batch, results):
        assert res.tokens == eng.reference_generate(req.prompt, max_new=req.max_new_tokens,
                                                    seed=req.seed, temperature=req.temperature,
                                                    top_k=req.top_k)
    # Interactive finished first: it took the preempted slots.
    assert max(r.total_s for r in results[2:]) < min(r.total_s for r in results[:2])
    assert set(SERVING_KEYS_V10) <= set(line["serving"])
    assert jax_schema.validate_line(json.loads(json.dumps(line))) == []
    assert not set(line["serving"]) & set(jax_schema.SERVING_KEYS_V12 + jax_schema.SERVING_KEYS_V13
                                          + jax_schema.SERVING_KEYS_V14)
    assert eng.pool.active_slots == 0 and eng.pool.paged_stats()["blocks_used"] == 0


@pytest.mark.timeout(240)
def test_brownout_sheds_batch_before_interactive_and_clears(flax_params):
    eng = port_engine(flax_params, brownout=True, brownout_queue_hi=4, brownout_hold_s=0.5)
    batcher = ContinuousBatcher(eng)  # not started: the burst queues up
    frontend = ServingFrontend(batcher)
    burst = [batcher.submit(Request(prompt=P[:8], max_new_tokens=24, seed=i)) for i in range(8)]
    batcher.start()
    try:
        _wait(lambda: batcher.brownout_level >= 1)
        status, reply = frontend.handle_request({"prompt": P[:5], "slo": "batch"})
        assert status == 503 and reply["shed"] and "brownout" in reply["error"]
        status, reply = frontend.handle_request({"prompt": P[:5], "max_new_tokens": 2})
        assert status == 200
        assert all(f.result(timeout=120).tokens for f in burst)
        _wait(lambda: batcher.brownout_level == 0, timeout=60)
        status, _ = frontend.handle_request({"prompt": P[:5], "slo": "batch"})
        assert status == 200
    finally:
        batcher.close(drain=True)
    line = batcher.stats_line()["serving"]
    assert line["shed_batch"] >= 1 and line["shed_interactive"] == 0
    assert line["brownout_transitions"] >= 2 and line["brownout_level"] == 0
    with pytest.raises(QueueFull):
        b = ContinuousBatcher(port_engine(flax_params, max_queue=1))
        b.submit(Request(prompt=[1]))
        b.submit(Request(prompt=[2]))
    b.close(drain=False)


# ------------------------------------------------------ the router


@pytest.mark.timeout(300)
def test_reference_router_hands_off_between_port_replicas(flax_params):
    prefill = port_stack(flax_params, role="prefill")
    decode = port_stack(flax_params, role="decode")
    jax_mixed = jax_engine_for(flax_params)
    router = Router([prefill.url(""), decode.url("")], cfg=RouterConfig())
    try:
        router.probe_once()
        prefix = [int(t) for t in np.random.default_rng(8).integers(0, 211, 32)]
        want = {}
        for i, prompt in enumerate((prefix + [4, 5, 6], prefix + [7, 8, 9, 10, 11])):
            body = {"prompt": prompt, "max_new_tokens": 6, "seed": i, "temperature": 0.7,
                    "top_k": 30}
            slot = jax_mixed.pool.alloc()
            first, _ = jax_mixed.prefill(slot, prompt, seed=i, temperature=0.7, top_k=30)
            toks = [first]
            while len(toks) < 6:
                toks.append(int(jax_mixed.decode([(slot, toks[-1], i, 0.7, 30)])[slot]))
            jax_mixed.pool.free(slot)
            want[i] = toks
            status, reply = router.handle(body, kind="generate")
            assert status == 200 and reply["tokens"] == want[i], (i, reply)
            router.probe_once()  # the decode replica's digest now holds the prompt
        counters = router.registry.counter_values()
        assert counters["router/handoffs_total"] == 2
        assert counters["router/handoff_delta_tokens_total"] == 32
        assert counters.get("router/handoff_fallbacks_total", 0) == 0
        pre = prefill.engine.registry.counter_values()
        assert pre["serving/kv_pages_delta_skipped"] == 2
        assert decode.engine.registry.counter_values()["serving/kv_pages_imported"] == 3 + 1
        assert decode.engine.registry.counter_values().get("serving/prefill_tokens", 0) == 0
    finally:
        router.close()
        prefill.close()
        decode.close()


# ------------------------------------------------- drain and faults


class _Guard:
    requested = False

    def install(self):
        return self


@pytest.mark.timeout(120)
def test_drain_finishes_in_flight_requests_and_faults_fire(flax_params):
    stack = port_stack(flax_params, max_slots=2)
    guard = _Guard()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        drained = pool.submit(run_until_preempted, stack.frontend, poll_s=0.01, guard=guard)
        inflight = [pool.submit(stack.frontend.handle_request,
                                {"prompt": P[:6], "max_new_tokens": 30, "seed": i})
                    for i in range(2)]
        _wait(lambda: stack.batcher.active_requests == 2)
        guard.requested = True
        assert drained.result(timeout=60) == 0
        assert [f.result(timeout=60)[0] for f in inflight] == [200, 200]
    assert stack.batcher.draining
    assert stack.frontend.handle_request({"prompt": [1]})[0] == 503
    stack.batcher.close(drain=False)
    stack = port_stack(flax_params)
    faults.serve_install("transport@0:1,badhealth@0:1")
    try:
        with pytest.raises((urllib.error.URLError, ConnectionError, http.client.HTTPException)):
            urllib.request.urlopen(urllib.request.Request(
                stack.url(), data=json.dumps({"prompt": [1]}).encode()), timeout=30).read()
        assert _http(stack.url(), {"prompt": [1], "max_new_tokens": 1})[0] == 200
        assert _http(stack.url("/health")) == (200, b"<<<not json at all>>>")
        assert json.loads(_http(stack.url("/health"))[1])["ok"]
    finally:
        faults.serve_clear()
        stack.close()
