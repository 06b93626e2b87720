"""The port's sharded serving against the JAX package's.

Spawned gloo worlds (``core/distributed.run_world``; a ``file://`` store
under ``tmp_path``, one torch thread a rank, a timeout on every world)
run the port on ``{model: 2}`` and ``{data: 2, model: 2}``; the JAX side
runs the same mesh shape over the first 2 or 4 of its fake CPU devices.
Weights are one numpy-seeded param tree in the reference's layout
(``models/convert.py`` loads it into the port), so both packages serve
the same model:

* ``mesh_decode_attention`` at ``tests/test_parallel.py:98``'s shapes
  against the JAX one, atol 2e-5 as there;
* greedy ``generate`` under a TP mesh at ``tests/test_parallel.py:122``'s
  config and tokens (``attention="flash"``) against the JAX ``generate``
  on a JAX mesh of the same shape, every rank returning the same tokens;
* the sharded engine on ``{model: 2}`` against the JAX
  ``InferenceEngine(..., sharding=...)`` at ``tests/test_sharding.py``'s
  smoke model (``TestShardedServing``): the same
  ``param_sharding_digest``, a rank's qkv and pool holding H/2 heads
  (kept by ``reallocate()``), the six batcher streams of
  ``test_batched_token_identity_and_zero_recompiles`` equal to the JAX
  engine's ``reference_generate``, no recompile after warmup, greedy
  output equal to the one-rank port engine's, the pool's host state
  equal on both ranks;
* ``paged_flash`` with int8 KV and a prefix-cache hit, speculation with
  chunked prefill, and int8 weights on ``{model: 2}``, streams equal to
  the one-rank port engine's (the int8 digest is the JAX engine's too);
* the serve CLI: a ``{model: 2}`` training run's workdir served sharded by
  ``torchrun --nproc_per_node 2``, served as one replica on one process
  with the reference's stderr line, an explicit config that does not fit
  raising, ``off`` serving one replica;
* a follower whose replayed call ends otherwise than rank 0's brings
  its world down;
* the port's ``Router`` hands requests from that workdir served as a
  ``--role prefill`` replica by ``torchrun --nproc_per_node 2`` to a
  one-rank ``--role decode`` replica, the routed streams the JAX mixed
  engine's.

The sharded engine in the KV-page hand-off and on ``fsdp`` meshes is
``tests/test_torch_sharded_handoff.py``'s.

The card's refusal of CUDA graphs over host-staged collectives is a
``cuda`` test (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from tensorflow_examples_torch.core import distributed
from tensorflow_examples_torch.core import rng as rng_mod
from tensorflow_examples_torch.core.sharding import shard, shard_params, unshard
from tensorflow_examples_torch.models import convert, transformer
from tensorflow_examples_torch.parallel.attention import decode_spec, mesh_decode_attention
from tensorflow_examples_torch.serving.batcher import ContinuousBatcher, Request
from tensorflow_examples_torch.serving.engine import InferenceEngine, ServeConfig
from tensorflow_examples_torch.serving.mesh_driver import MeshDriver
from tensorflow_examples_torch.sharding import ShardingConfig
from tensorflow_examples_torch.telemetry.registry import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 240
# tests/test_parallel.py:98 (b, h, max_len, d, length) and :122 (the generate config).
DECODE = (8, 8, 64, 8, 37)
GEN = dict(vocab_size=97, max_len=32, num_layers=2, num_heads=4, d_model=16)
GEN_NEW = 6
# tests/test_sharding.py:548's smoke model and serve config.
SMOKE = dict(vocab_size=211, max_len=64, num_layers=2, num_heads=2, d_model=32)
SERVE = dict(max_slots=4, prefill_bucket_floor=16, kv_bucket_floor=32)
ROUTES = {
    "paged_flash_int8_prefix": dict(kv_block_size=8, attention="paged_flash", kv_dtype="int8"),
    "spec_chunked": dict(kv_block_size=8, spec_decode_k=3, prefill_chunk_tokens=16),
    "weights_int8": dict(weight_dtype="int8"),
}
# The training run the serve CLI serves: GPT-2 on {model: 2}, 2 steps.
TRAIN = dict(vocab_size=64, seq_len=32, num_layers=2, num_heads=4, d_model=32, dropout=0.0,
             attention="xla", global_batch_size=4, train_steps=2, warmup_steps=1,
             learning_rate=3e-3, log_every=1, eval_every=0, checkpoint_every=2,
             precision="f32", watchdog_secs=0, telemetry_sinks="", device="cpu")
CLI_PROMPT = [5, 9, 2, 33, 17, 4]
CLI_NEW = 8


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
    """Sent after :func:`six_requests` finished: two prompts whose first
    16 tokens (two blocks of 8) are the 19-token prompt's, which the
    prefix cache then holds."""
    return [Request(prompt=list(range(1, 17)) + [50, 60, 70], max_new_tokens=5, seed=2),
            Request(prompt=list(range(1, 20)) + [8], max_new_tokens=4, seed=4,
                    temperature=0.8)]


def serve_rounds(engine, rounds) -> list[list[int]]:
    """Each round's requests at once through a ContinuousBatcher, round
    after round; every stream's tokens."""
    batcher = ContinuousBatcher(engine).start()
    try:
        out = []
        for reqs in rounds:
            out += [f.result(timeout=120).tokens for f in [batcher.submit(r) for r in reqs]]
        return out
    finally:
        batcher.close()


def seeded_tree(kw: dict, seed: int) -> dict:
    """A param tree in the reference's layout for the config ``kw``, made
    from a numpy seed: LayerNorm scales near 1, small biases, kernels and
    tables at std 0.05."""
    import jax

    from tensorflow_examples_tpu.models import transformer as jax_transformer

    model = jax_transformer.Transformer(jax_transformer.TransformerConfig(**kw, dropout=0.0))
    shapes = jax.eval_shape(lambda r: model.init({"params": r}, np.zeros((1, 8), np.int32)),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        scale, base = {"scale": (0.1, 1.0), "bias": (0.02, 0.0)}.get(name, (0.05, 0.0))
        return (base + scale * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_mesh(shape: dict):
    import jax

    from tensorflow_examples_tpu.core.mesh import MeshConfig, create_mesh

    n = int(np.prod(list(shape.values())))
    return create_mesh(MeshConfig(**shape), devices=jax.devices()[:n])


def gpt2_sharding(mesh: dict):
    """``tests/test_sharding.py``'s config: the JAX GPT-2 rules embedded."""
    from tensorflow_examples_tpu.models import transformer as jax_transformer
    from tensorflow_examples_tpu.sharding import ShardingConfig as JaxShardingConfig
    from tensorflow_examples_tpu.sharding.config import rules_to_json

    return JaxShardingConfig(mesh=mesh, rules=rules_to_json(jax_transformer.GPT2_RULES))


# ------------------------------------------------------------ rank workers


def _decode_and_generate(mesh, case: dict) -> dict:
    """This rank's mesh_decode_attention over its decode_spec shard, the
    output gathered back; and greedy generate on its param shards."""
    b, h, _, _, length = DECODE
    spec = decode_spec(mesh, b, h)
    q, k, v = (shard(torch.from_numpy(case[n]), spec, mesh) for n in ("q", "k", "v"))
    out = unshard(mesh_decode_attention(q, k, v, length, mesh=mesh), spec, mesh)
    cfg = transformer.TransformerConfig(**GEN, dropout=0.0, attention="flash")
    full = dict(convert.model_from_params(cfg, case["gen_tree"]).named_parameters())
    params = transformer.ParamView(shard_params(full, mesh, transformer.GPT2_RULES))
    tokens = transformer.generate(cfg, params, torch.from_numpy(case["tokens"]).long(),
                                  num_tokens=GEN_NEW, key=rng_mod.PRNGKey(1), temperature=0.0,
                                  mesh=mesh)
    return {"decode": out.numpy(), "generate": tokens.numpy(),
            "gen_qkv_heads": int(params.block(0).attn.qkv.kernel.shape[2])}


def _sharded_engine(tree, sharding_json, **kw):
    return InferenceEngine(transformer.TransformerConfig(**SMOKE), tree,
                           cfg=ServeConfig(**SERVE, **kw), registry=MetricsRegistry(),
                           device="cpu", sharding=ShardingConfig.from_json_dict(sharding_json))


def _drive_greedy(engine) -> list[int]:
    """``test_sharded_matches_replicated_engine``'s drive: a prefill and
    four decode steps."""
    slot = engine.pool.alloc()
    tok, _ = engine.prefill(slot, [5, 4, 3], seed=2)
    out = [tok]
    for _ in range(4):
        out.append(engine.decode([(slot, out[-1], 2, 0.0, 0)])[slot])
    engine.pool.free(slot)
    return out


def _serve_on_mesh(rank: int, engine, rounds) -> dict:
    """Rank 0 leads (warmup, the rounds through a batcher, the greedy
    drive) while the other ranks replay its calls; then every rank's
    pool host state."""
    driver = MeshDriver()
    out = {}
    if rank == 0:
        lead = driver.leader(engine)
        lead.warmup()
        out["streams"] = serve_rounds(lead, rounds)
        out["greedy"] = _drive_greedy(lead)
        driver.stop()
        out["published"] = driver.calls
    else:
        out["replayed"] = driver.follow(engine)
    out["host_state"] = engine.pool.host_state()
    out["post_warmup_recompiles"] = engine.post_warmup_recompiles()
    out["digest"] = engine.param_sharding_digest
    out["local_heads"] = engine.local_heads
    return out


def _train_model2(rank: int, workdir: str) -> None:
    """A ``{model: 2}`` training run of the port into ``workdir``."""
    from tensorflow_examples_torch.train.cli import iterators
    from tensorflow_examples_torch.train.loop import Trainer
    from tensorflow_examples_torch.workloads import gpt2

    cfg = gpt2.Gpt2Config(**TRAIN, workdir=workdir, mesh_model=2)
    sc = ShardingConfig.from_train_config(cfg)
    mesh = sc.build_mesh()
    trainer = Trainer(gpt2.make_task(cfg, mesh=mesh), cfg, mesh=mesh, sharding=sc)
    train_fn, _ = iterators(gpt2, cfg)
    trainer.fit(train_fn)


def _two_rank_worker(rank: int, case: dict, workdir: str) -> dict:
    from tensorflow_examples_torch.core.mesh import MeshConfig, create_mesh

    out = _decode_and_generate(create_mesh(MeshConfig(data=1, model=2)), case)
    engine = _sharded_engine(case["smoke_tree"], case["sharding"])
    qkv = engine.model.block(0).attn.qkv.kernel
    out["qkv_shape"] = tuple(qkv.shape)
    out["pool_heads"] = int(engine.pool.k.shape[2])
    engine.pool.reallocate()
    out["pool_heads_reallocated"] = int(engine.pool.k.shape[2])
    out["main"] = _serve_on_mesh(rank, engine, [six_requests()])
    out["routes"] = {}
    for name, kw in ROUTES.items():
        engine = _sharded_engine(case["smoke_tree"], case["sharding"], **kw)
        out["routes"][name] = _serve_on_mesh(rank, engine, [six_requests(), prefix_requests()])
        out["routes"][name]["prefix_hits"] = getattr(engine.pool, "prefix_hits", None)
    _train_model2(rank, workdir)
    return out


def _raise_on(engine, rank) -> None:
    """Raises on ``rank`` (every rank when None)."""
    if rank is None or torch.distributed.get_rank() == rank:
        raise ValueError(f"raised on rank {torch.distributed.get_rank()}")


def _diverging_worker(rank: int) -> int:
    """Rank 0 publishes a call that raises on every rank (a request's
    failure: the replay goes on), then one that raises on rank 1 alone."""
    driver = MeshDriver()
    if rank > 0:
        return driver.follow(None)
    try:
        driver.run(None, _raise_on, None)
    except ValueError:
        pass
    driver.run(None, _raise_on, 1)
    driver.stop()
    return driver.calls


def _four_rank_worker(rank: int, case: dict) -> dict:
    from tensorflow_examples_torch.core.mesh import MeshConfig, create_mesh

    return _decode_and_generate(create_mesh(MeshConfig(data=2, model=2)), case)


# ----------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    b, h, max_len, d, _ = DECODE
    gen_cfg = dict(GEN, attention="flash")
    return {
        "q": rng.standard_normal((b, h, 1, d)).astype(np.float32),
        "k": rng.standard_normal((b, h, max_len, d)).astype(np.float32),
        "v": rng.standard_normal((b, h, max_len, d)).astype(np.float32),
        "gen_tree": seeded_tree(gen_cfg, 1),
        # tests/test_parallel.py:131's tokens.
        "tokens": np.random.default_rng(0).integers(0, 97, (2, 4)).astype(np.int32),
        "smoke_tree": seeded_tree(dict(SMOKE, attention="xla"), 2),
        "sharding": gpt2_sharding({"data": 1, "model": 2}).to_json_dict(),
    }


@pytest.fixture(scope="module")
def worlds(case, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("model2-run"))
    two = distributed.run_world(_two_rank_worker, 2, case, workdir, timeout_s=WORLD_TIMEOUT_S,
                                store_dir=str(tmp_path_factory.mktemp("w2")))
    four = distributed.run_world(_four_rank_worker, 4, case, timeout_s=WORLD_TIMEOUT_S,
                                 store_dir=str(tmp_path_factory.mktemp("w4")))
    return {"2": two, "4": four, "workdir": workdir}


def one_rank_engine(tree, **kw):
    return InferenceEngine(transformer.TransformerConfig(**SMOKE), tree,
                           cfg=ServeConfig(**SERVE, **kw), registry=MetricsRegistry(),
                           device="cpu")


def jax_engine_on(model_cfg, tree, sharding=None, **kw):
    """The JAX engine of the port's ``model_cfg`` widths on ``tree``."""
    import jax
    import jax.numpy as jnp

    from tensorflow_examples_tpu.models import transformer as jax_transformer
    from tensorflow_examples_tpu.serving import engine as jax_engine_mod
    from tensorflow_examples_tpu.telemetry.registry import MetricsRegistry as JaxRegistry

    cfg = jax_transformer.TransformerConfig(
        **{f: getattr(model_cfg, f) for f in ("vocab_size", "max_len", "num_layers", "num_heads",
                                              "d_model")}, dropout=0.0, attention="xla")
    return jax_engine_mod.InferenceEngine(cfg, jax.tree.map(jnp.asarray, tree),
                                          cfg=jax_engine_mod.ServeConfig(**kw),
                                          registry=JaxRegistry(), sharding=sharding)


def jax_engine(tree, sharding=None, **kw):
    import jax
    import jax.numpy as jnp

    from tensorflow_examples_tpu.models import transformer as jax_transformer
    from tensorflow_examples_tpu.serving import engine as jax_engine_mod
    from tensorflow_examples_tpu.telemetry.registry import MetricsRegistry as JaxRegistry

    cfg = jax_transformer.TransformerConfig(**SMOKE, dropout=0.0, attention="xla")
    return jax_engine_mod.InferenceEngine(cfg, jax.tree.map(jnp.asarray, tree),
                                          cfg=jax_engine_mod.ServeConfig(**SERVE, **kw),
                                          registry=JaxRegistry(), sharding=sharding)


# -------------------------------------------------------------------- tests


@pytest.mark.timeout(300)
@pytest.mark.parametrize("world,shape", [("2", {"model": 2}), ("4", {"data": 2, "model": 2})])
def test_mesh_decode_attention_matches_jax(case, worlds, world, shape):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from tensorflow_examples_tpu.parallel import attention as jax_attention

    b, h, _, _, length = DECODE
    mesh = jax_mesh(shape)
    sharding = NamedSharding(mesh, jax_attention.decode_spec(mesh, b, h))
    args = jax.device_put(tuple(jnp.asarray(case[n]) for n in ("q", "k", "v")), sharding)
    want = np.asarray(jax.jit(lambda q, k, v: jax_attention.mesh_decode_attention(
        q, k, v, jnp.asarray(length), mesh=mesh))(*args))
    for rank in worlds[world]:
        np.testing.assert_allclose(rank["decode"], want, atol=2e-5)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("world,shape", [("2", {"model": 2}), ("4", {"data": 2, "model": 2})])
def test_generate_under_tp_mesh_matches_jax(case, worlds, world, shape):
    import jax
    import jax.numpy as jnp

    from tensorflow_examples_tpu.models import transformer as jax_transformer

    cfg = jax_transformer.TransformerConfig(**GEN, dropout=0.0, attention="flash")
    meshed = jax_transformer.Transformer(cfg, mesh=jax_mesh(shape))
    want = np.asarray(jax_transformer.generate(
        meshed, jax.tree.map(jnp.asarray, case["gen_tree"]), jnp.asarray(case["tokens"]),
        num_tokens=GEN_NEW, rng=jax.random.PRNGKey(1), temperature=0.0))
    for rank in worlds[world]:
        np.testing.assert_array_equal(rank["generate"], want)
        assert rank["gen_qkv_heads"] == GEN["num_heads"] // 2


@pytest.mark.timeout(300)
def test_sharded_engine_matches_jax_sharded_engine(case, worlds):
    """The JAX engine of ``tests/test_sharding.py``'s ``TestShardedServing``
    and the port's on the same tree and config."""
    from tensorflow_examples_tpu.sharding import ShardingConfig as JaxShardingConfig

    theirs = jax_engine(case["smoke_tree"], JaxShardingConfig.from_json_dict(case["sharding"]))
    ranks = worlds["2"]
    heads = SMOKE["num_heads"] // 2
    for r in ranks:
        assert r["main"]["digest"] == theirs.param_sharding_digest
        assert r["qkv_shape"] == (SMOKE["d_model"], 3, heads, SMOKE["d_model"] // 2)
        assert r["pool_heads"] == r["pool_heads_reallocated"] == r["main"]["local_heads"] == heads
        assert r["main"]["post_warmup_recompiles"] == 0
    lead = ranks[0]["main"]
    for req, tokens in zip(six_requests(), lead["streams"]):
        assert tokens == theirs.reference_generate(
            req.prompt, max_new=req.max_new_tokens, seed=req.seed, temperature=req.temperature,
            top_k=req.top_k), req.prompt
    assert lead["greedy"] == _drive_greedy(one_rank_engine(case["smoke_tree"]))
    assert ranks[1]["main"]["replayed"] == lead["published"]
    assert ranks[0]["main"]["host_state"] == ranks[1]["main"]["host_state"]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_sharded_routes_match_one_rank_engine(case, worlds, name):
    kw = ROUTES[name]
    one = one_rank_engine(case["smoke_tree"], **kw)
    one.warmup()
    want = serve_rounds(one, [six_requests(), prefix_requests()])
    lead, follower = (r["routes"][name] for r in worlds["2"])
    assert lead["streams"] == want
    assert lead["host_state"] == follower["host_state"]
    assert lead["post_warmup_recompiles"] == follower["post_warmup_recompiles"] == 0
    if name == "paged_flash_int8_prefix":
        assert lead["prefix_hits"] == follower["prefix_hits"] == one.pool.prefix_hits > 0
    if name == "weights_int8":
        from tensorflow_examples_tpu.sharding import ShardingConfig as JaxShardingConfig

        theirs = jax_engine(case["smoke_tree"], JaxShardingConfig.from_json_dict(
            case["sharding"]), weight_dtype="int8")
        assert lead["digest"] == theirs.param_sharding_digest


@pytest.mark.timeout(120)
def test_a_diverging_follower_brings_the_world_down(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as info:
        distributed.run_world(_diverging_worker, 2, timeout_s=60, store_dir=str(tmp_path))
    assert "ReplayDiverged: rank 1: call 1 (run._raise_on) ended with ValueError here but " \
           "with success on rank 0" in str(info.value)


# ------------------------------------------------------------ the serve CLI


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_args(workdir: str, *extra) -> list[str]:
    return ["--device", "cpu", "--workdir", workdir, "--vocab_size", str(TRAIN["vocab_size"]),
            "--max_len", str(TRAIN["seq_len"]), "--num_layers", str(TRAIN["num_layers"]),
            "--num_heads", str(TRAIN["num_heads"]), "--d_model", str(TRAIN["d_model"]),
            "--stats_every", "0", *extra]


def worker_pid(parent: int, *, rank: int) -> int | None:
    """The pid of ``torchrun``'s worker of ``rank`` (read from /proc)."""
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{entry}/environ", "rb") as f:
                env = f.read().split(b"\0")
        except OSError:
            continue
        if ppid == parent and f"RANK={rank}".encode() in env:
            return int(entry)
    return None


def post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def start_in_process(workdir: str, *extra):
    """The CLI's start in this process (one rank): its frontend."""
    from tensorflow_examples_torch import serve

    return serve._start(serve.build_parser().parse_args(cli_args(workdir, "--port", "0",
                                                                 *extra)))


def serve_in_process(workdir: str, *extra):
    """The CLI's start in this process (one rank): its /generate tokens
    and /health, the frontend closed after."""
    frontend = start_in_process(workdir, *extra)
    try:
        tokens = post(frontend.url(), {"prompt": CLI_PROMPT, "max_new_tokens": CLI_NEW})["tokens"]
        with urllib.request.urlopen(frontend.url("/health"), timeout=30) as r:
            return tokens, json.loads(r.read())
    finally:
        frontend.close()
        frontend.batcher.close()


@pytest.mark.timeout(300)
def test_serve_cli_on_one_process(worlds, capsys):
    workdir = worlds["workdir"]
    with open(os.path.join(workdir, "sharding.json")) as f:
        assert json.load(f)["config"]["mesh"]["model"] == 2
    auto, health = serve_in_process(workdir)
    err = capsys.readouterr().err
    assert "sharding.json does not fit this host" in err and "serving with replicated params" in err
    assert "param_sharding_digest" not in health
    off, _ = serve_in_process(workdir, "--serve_sharding_config", "off")
    assert auto == off and len(auto) == CLI_NEW
    with pytest.raises(ValueError, match="available devices 1"):
        serve_in_process(workdir, "--serve_sharding_config", os.path.join(workdir, "sharding.json"))


def torchrun_serve(workdir: str, port: int, *extra) -> subprocess.Popen:
    """``torchrun --nproc_per_node 2`` of the serve CLI on ``workdir``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
           "2", "--master_addr", "127.0.0.1", "--master_port", str(free_port()), "-m",
           "tensorflow_examples_torch.serve", *cli_args(workdir, "--port", str(port)), *extra]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)


def wait_healthy(proc: subprocess.Popen, base: str, timeout_s: float = 180) -> dict:
    deadline = time.monotonic() + timeout_s
    while True:
        assert proc.poll() is None, proc.communicate()[1][-4000:]
        assert time.monotonic() < deadline, "the torchrun server did not come up"
        try:
            with urllib.request.urlopen(base + "/health", timeout=5) as r:
                return json.loads(r.read())
        except OSError:
            time.sleep(0.5)


def stop_torchrun(proc: subprocess.Popen) -> tuple[str, str]:
    """SIGTERM to rank 0 drains it, and its stop ends rank 1's replay."""
    rank0 = worker_pid(proc.pid, rank=0)
    os.kill(rank0, signal.SIGTERM) if rank0 else os.killpg(proc.pid, signal.SIGKILL)
    return proc.communicate(timeout=120)


@pytest.mark.timeout(300)
def test_serve_cli_under_torchrun_serves_the_model2_run_sharded(worlds, tmp_path):
    from tensorflow_examples_torch.telemetry.schema import validate_line

    workdir = worlds["workdir"]
    want, _ = serve_in_process(workdir, "--serve_sharding_config", "off")
    port = free_port()
    stats = tmp_path / "stats"
    proc = torchrun_serve(workdir, port, "--stats_every", "0.5", "--stats_dir", str(stats))
    try:
        base = f"http://127.0.0.1:{port}"
        health = wait_healthy(proc, base)
        got = post(base + "/generate", {"prompt": CLI_PROMPT, "max_new_tokens": CLI_NEW})
        time.sleep(1.5)  # a serving line or two
    finally:
        out, err = stop_torchrun(proc)
    assert proc.returncode == 0, err[-4000:]
    assert got["tokens"] == want
    assert health["mesh_shape"]["model"] == 2 and health["mesh_shape"]["data"] == 1
    with open(os.path.join(workdir, "sharding.json")) as f:
        assert health["param_sharding_digest"] == json.load(f)["param_sharding_digest"]
    assert "sharding config:" in err and "cuda graphs off" not in err
    assert "replayed" in err  # rank 1 replayed rank 0's calls to the stop
    lines = [json.loads(x) for x in (stats / "serving.jsonl").read_text().splitlines()]
    assert lines and all(not validate_line(x) for x in lines)
    assert lines[-1]["param_sharding_digest"] == health["param_sharding_digest"]
    assert lines[-1]["mesh_shape"] == health["mesh_shape"]


# Disaggregated serving from the {model: 2} run: block 16, paged_flash.
HANDOFF_FLAGS = ("--kv_block_size", "16", "--kv_bucket_floor", "32", "--attention",
                 "paged_flash")
HANDOFF_BODIES = ({"prompt": CLI_PROMPT, "max_new_tokens": CLI_NEW},
                  {"prompt": list(range(3, 23)), "max_new_tokens": CLI_NEW, "seed": 7,
                   "temperature": 0.8, "top_k": 20})


@pytest.mark.timeout(300)
def test_router_hands_off_from_a_torchrun_prefill_replica(worlds):
    """The ``{model: 2}`` run served as a prefill replica by two ranks
    under torchrun, a one-rank decode replica in this process, the port's
    Router in front: each routed stream is the JAX mixed engine's."""
    from tensorflow_examples_torch.generate import restore_model
    from tensorflow_examples_torch.serving.router import Router

    workdir = worlds["workdir"]
    model_cfg = transformer.TransformerConfig(
        vocab_size=TRAIN["vocab_size"], max_len=TRAIN["seq_len"],
        num_layers=TRAIN["num_layers"], num_heads=TRAIN["num_heads"], d_model=TRAIN["d_model"])
    params, _ = restore_model(model_cfg, workdir, "cpu")
    theirs = jax_engine_on(model_cfg, convert.to_param_tree(params), kv_block_size=16,
                           kv_bucket_floor=32)
    want = []
    for body in HANDOFF_BODIES:
        sampling = {k: body.get(k, 0) for k in ("seed", "temperature", "top_k")}
        slot = theirs.pool.alloc()
        toks = [int(theirs.prefill(slot, body["prompt"], **sampling)[0])]
        while len(toks) < CLI_NEW:
            toks.append(int(theirs.decode([(slot, toks[-1], sampling["seed"],
                                            float(sampling["temperature"]),
                                            sampling["top_k"])])[slot]))
        theirs.pool.free(slot)
        want.append(toks)
    port = free_port()
    proc = torchrun_serve(workdir, port, "--role", "prefill", *HANDOFF_FLAGS)
    decode = router = None
    try:
        base = f"http://127.0.0.1:{port}"
        health = wait_healthy(proc, base)
        decode = start_in_process(workdir, "--serve_sharding_config", "off", "--role", "decode",
                                  *HANDOFF_FLAGS)
        # The in-process replica counts into the process's default registry.
        before = decode.batcher.engine.registry.counter_values()
        router = Router([base, decode.url("")])
        router.probe_once()
        got = [router.handle(dict(body), kind="generate") for body in HANDOFF_BODIES]
        counters = router.registry.counter_values()
    finally:
        if router is not None:
            router.close()
        if decode is not None:
            decode.close()
            decode.batcher.close()
        out, err = stop_torchrun(proc)
    assert proc.returncode == 0, err[-4000:]
    assert health["role"] == "prefill" and health["mesh_shape"]["model"] == 2
    assert [status for status, _ in got] == [200, 200], got
    assert [reply["tokens"] for _, reply in got] == want
    assert counters["router/handoffs_total"] == len(HANDOFF_BODIES)
    assert counters.get("router/handoff_fallbacks_total", 0) == 0
    assert "role prefill, attention paged_flash, mesh" in err
    after = decode.batcher.engine.registry.counter_values()
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in
             ("serving/kv_pages_imported", "serving/prefill_tokens")}
    assert moved == {"serving/kv_pages_imported": 1 + 2, "serving/prefill_tokens": 0}
