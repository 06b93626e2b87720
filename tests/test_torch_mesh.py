"""The port's mesh layer against the JAX package: ``core/{mesh,
collectives,sharding,distributed}`` and ``sharding/{config,resolve}``.

Mesh shapes, the token-partition policy and the resolve errors, the
ShardingConfig JSON (both ways through the reference's
``from_json_dict``), the placement digest (equal to the reference's for
GPT-2's rules, independent of the mesh shape, moved by a rules change),
byte totals and the table, ZeRO-1 specs and the digest agreement check
(injected allgather) are held to the JAX package. The collectives run in
one spawned gloo world of 4 ranks (``core/distributed.run_world``, a
``file://`` store under ``tmp_path``, bounded by a timeout) and are held
to numpy, their backward to the transposes the module names.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tensorflow_examples_torch.core import distributed
from tensorflow_examples_torch.core import sharding as port_sharding
from tensorflow_examples_torch.core.mesh import AxisNames, MeshConfig, token_partition_axes
from tensorflow_examples_torch.models import transformer
from tensorflow_examples_torch.sharding import (ShardingConfig, ShardingMismatchError,
                                                resolve_params, verify_digest_agreement,
                                                zero1_spec)
from tensorflow_examples_torch.workloads import gpt2

WORLD_TIMEOUT_S = 120


class FakeMesh:
    """What resolution and the task read of a mesh: its axis sizes."""

    def __init__(self, **shape):
        self.shape = {a: shape.get(a, 1) for a in AxisNames.ALL}
        self.trivial = all(v == 1 for v in self.shape.values())

    def axis_size(self, axis) -> int:
        return int(np.prod([self.shape[a] for a in ((axis,) if isinstance(axis, str) else axis)]))


fake_mesh = FakeMesh


def tiny_model_cfg(**kw):
    base = dict(vocab_size=64, max_len=16, num_layers=2, num_heads=4, d_model=32)
    base.update(kw)
    return transformer.TransformerConfig(**base)


def port_params(cfg):
    model = transformer.GPT2(cfg, device="meta")
    return {k: p for k, p in model.named_parameters()}


def jax_params(cfg):
    import jax

    from tensorflow_examples_tpu.models import transformer as jax_transformer

    model = jax_transformer.Transformer(jax_transformer.TransformerConfig(
        vocab_size=cfg.vocab_size, max_len=cfg.max_len, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, d_model=cfg.d_model))
    return jax.eval_shape(lambda r: model.init({"params": r}, np.zeros((1, cfg.max_len),
                                                                        np.int32)),
                          jax.random.PRNGKey(0))["params"]


# ---------------------------------------------------------------- mesh


@pytest.mark.parametrize("config,n", [
    (MeshConfig(), 8), (MeshConfig(data=2, model=4), 8), (MeshConfig(fsdp=3), 7),
    (MeshConfig(data=2, context=2), 8), (MeshConfig(data=-1, model=2, context=2), 8),
])
def test_mesh_resolve_matches_reference(config, n):
    from tensorflow_examples_tpu.core.mesh import MeshConfig as JaxMeshConfig

    ref = JaxMeshConfig(**vars(config))
    try:
        want = ref.resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            config.resolve(n)
        assert str(got.value) == str(e)
    else:
        assert config.resolve(n) == want


@pytest.mark.parametrize("shape", [{"data": 2}, {"data": 2, "fsdp": 2}, {"model": 4},
                                   {"context": 2, "model": 2}, {"data": 3, "context": 4}])
@pytest.mark.parametrize("dims", [(8, 16), (1, 16), (6, 12), (4, 6)])
@pytest.mark.parametrize("include_model", [False, True])
def test_token_partition_axes_match_reference(shape, dims, include_model):
    from tensorflow_examples_tpu.core.mesh import token_partition_axes as ref

    mesh = fake_mesh(**shape)
    assert token_partition_axes(mesh, *dims, include_model=include_model) == ref(
        mesh, *dims, include_model=include_model)


@pytest.mark.parametrize("shape", [{}, {"data": 2}, {"data": 2, "fsdp": 2}, {"model": 4},
                                   {"data": 2, "context": 4}, {"fsdp": 2, "model": 2}])
@pytest.mark.parametrize("batch,heads", [(8, 12), (1, 12), (6, 4)])
def test_attention_and_decode_specs_match_reference(shape, batch, heads):
    from tensorflow_examples_tpu.parallel.attention import attention_spec as ref_attention
    from tensorflow_examples_tpu.parallel.attention import decode_spec as ref_decode
    from tensorflow_examples_torch.parallel.attention import attention_spec, decode_spec

    mesh = fake_mesh(**shape)
    assert attention_spec(mesh) == tuple(ref_attention(mesh))
    assert decode_spec(mesh, batch, heads) == tuple(ref_decode(mesh, batch, heads))


# ------------------------------------------------------ config and digest


def test_sharding_config_json_crosses_both_packages(tmp_path):
    from tensorflow_examples_tpu.sharding.config import ShardingConfig as JaxShardingConfig
    from tensorflow_examples_tpu.sharding.config import rules_to_json as jax_rules_to_json
    from tensorflow_examples_tpu.models import transformer as jax_transformer
    from tensorflow_examples_torch.sharding.config import rules_to_json

    ours = ShardingConfig(mesh={"data": 2, "model": 2}, rules=rules_to_json(
        transformer.GPT2_RULES), batch_axes=("data", "fsdp"), zero1=True)
    theirs = JaxShardingConfig(mesh={"data": 2, "model": 2}, rules=jax_rules_to_json(
        jax_transformer.GPT2_RULES), zero1=True)
    assert ours.to_json_dict() == theirs.to_json_dict()
    assert JaxShardingConfig.from_json_dict(ours.to_json_dict()) == theirs
    assert ShardingConfig.from_json_dict(theirs.to_json_dict()) == ours
    path = str(tmp_path / "sharding.json")
    ours.save(path, extra={"param_sharding_digest": "0123456789abcdef"})
    loaded, extra = JaxShardingConfig.load_with_extra(path)
    assert loaded == theirs and extra == {"param_sharding_digest": "0123456789abcdef"}
    theirs.save(path)
    assert ShardingConfig.load(path) == ours
    for bad in ({"banana": 2}, {"model": 0}):
        with pytest.raises(ValueError):
            ShardingConfig(mesh=bad)


@pytest.mark.parametrize("tp_vocab", [False, True])
def test_gpt2_digest_equals_the_reference_and_ignores_mesh_shape(tp_vocab):
    from tensorflow_examples_tpu.core.sharding import ShardingRules as JaxRules
    from tensorflow_examples_tpu.models import transformer as jax_transformer
    from tensorflow_examples_tpu.sharding import resolve_params as jax_resolve
    from jax.sharding import PartitionSpec as P

    cfg = tiny_model_cfg()
    rules = gpt2.make_task(gpt2.Gpt2Config(vocab_size=64, seq_len=16, num_layers=2, num_heads=4,
                                           d_model=32, tp_vocab=tp_vocab, device="cpu"),
                           mesh=fake_mesh(model=2) if tp_vocab else None).sharding_rules
    jax_rules = jax_transformer.GPT2_RULES
    if tp_vocab:
        jax_rules = JaxRules([(r"wte/embedding", P(AxisNames.MODEL, None))]) + jax_rules
    params, ref_params = port_params(cfg), jax_params(cfg)
    digests = {resolve_params(params, fake_mesh(**shape), rules).digest()
               for shape in ({}, {"data": 2, "model": 2}, {"data": 4, "model": 2, "fsdp": 1})}
    want = jax_resolve(ref_params, fake_mesh(data=2, model=2), jax_rules)
    assert digests == {want.digest()}
    ours = resolve_params(params, fake_mesh(data=1, model=2), rules)
    theirs = jax_resolve(ref_params, fake_mesh(data=1, model=2), jax_rules)
    assert ours.byte_totals() == theirs.byte_totals()
    assert ours.table_str() == theirs.table_str()
    assert ours.spec_by_path() == {k: tuple(v) for k, v in theirs.spec_by_path().items()}
    assert resolve_params(params, fake_mesh(), port_sharding.ShardingRules()).digest() != (
        want.digest())


@pytest.mark.parametrize("shape", [(768, 2304), (3, 3, 64, 64), (50257, 768), (7,), (1, 1)])
@pytest.mark.parametrize("mesh_shape", [{"data": 2}, {"data": 2, "fsdp": 4}, {"data": 8}])
def test_zero1_spec_matches_reference(shape, mesh_shape):
    from tensorflow_examples_tpu.sharding import ShardingConfig as JaxShardingConfig
    from tensorflow_examples_tpu.sharding import zero1_spec as ref

    axes = tuple(a for a in AxisNames.BATCH_AXES if mesh_shape.get(a, 1) > 1)
    want = ref(shape, JaxShardingConfig(mesh=mesh_shape).build_mesh(), axes)
    got = zero1_spec(shape, fake_mesh(**mesh_shape), axes)
    assert got == (None if want is None else tuple(want.spec))


class TestDigestAgreement:
    A, B = "0123456789abcdef", "fedcba9876543210"

    def _gather(self, rows):
        return lambda vec: np.stack([np.frombuffer(bytes.fromhex(d), np.uint8).astype(np.int32)
                                     for d in rows])

    def test_agreement_passes_and_one_process_never_gathers(self):
        verify_digest_agreement(self.A, allgather=self._gather([self.A] * 4), process_index=1,
                                process_count=4)
        verify_digest_agreement(self.A, allgather=lambda v: 1 / 0, process_index=0,
                                process_count=1)

    def test_mismatch_names_the_host_as_the_reference(self):
        from tensorflow_examples_tpu.sharding import ShardingMismatchError as JaxMismatch
        from tensorflow_examples_tpu.sharding import verify_digest_agreement as ref

        rows = [self.A, self.A, self.B, self.A]
        with pytest.raises(ShardingMismatchError) as ours:
            verify_digest_agreement(self.A, allgather=self._gather(rows), process_index=0,
                                    process_count=4)
        with pytest.raises(JaxMismatch) as theirs:
            ref(self.A, allgather=self._gather(rows), process_index=0, process_count=4)
        msg = str(ours.value)
        assert "host 2" in msg and self.B in msg and "host 1" not in msg
        assert msg.split(". Every")[0] == str(theirs.value).split(". Every")[0]


# ---------------------------------------------------------- collectives


def _collectives_worker(rank: int) -> dict:
    from tensorflow_examples_torch.core import collectives as coll
    from tensorflow_examples_torch.core.mesh import create_mesh

    mesh = create_mesh(MeshConfig(data=2, model=2))
    out = {"coords": mesh.coords, "model_members": mesh.members("model"),
           "data_members": mesh.members("data"), "world": mesh.members(("data", "model"))}
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4) + 100 * rank
    out["psum_model"] = coll.psum(x, "model", mesh=mesh).numpy()
    out["pmax_world"] = coll.pmax(x, ("data", "model"), mesh=mesh).numpy()
    out["pmean_data"] = coll.pmean(x, "data", mesh=mesh).numpy()
    leaf = x.clone().requires_grad_(True)
    g = coll.all_gather(leaf, ("data", "model"), mesh=mesh, dim=1)
    (g * torch.arange(g.numel()).reshape(g.shape)).sum().backward()
    out["all_gather"], out["all_gather_grad"] = g.detach().numpy(), leaf.grad.numpy()
    leaf = x.clone().requires_grad_(True)
    r = coll.reduce_scatter(leaf, "model", mesh=mesh, dim=1)
    (r * (rank + 1)).sum().backward()
    out["reduce_scatter"], out["reduce_scatter_grad"] = r.detach().numpy(), leaf.grad.numpy()
    leaf = x.clone().requires_grad_(True)
    moved = coll.ppermute((leaf, leaf * 2), ("data", "model"), mesh=mesh, perm=coll.ring_perm(4))
    (moved[0] * (rank + 1) + moved[1]).sum().backward()
    out["ppermute"] = [m.detach().numpy() for m in moved]
    out["ppermute_grad"] = leaf.grad.numpy()
    y = (torch.arange(2 * 4 * 6, dtype=torch.float32).reshape(2, 4, 6) + 1000 * rank)
    leaf = y.clone().requires_grad_(True)
    a2a = coll.all_to_all(leaf, ("data", "model"), mesh=mesh, split_axis=1, concat_axis=2)
    (a2a * torch.arange(a2a.numel()).reshape(a2a.shape)).sum().backward()
    out["all_to_all"], out["all_to_all_grad"] = a2a.detach().numpy(), leaf.grad.numpy()
    leaf = x.clone().requires_grad_(True)
    coll.copy_to(leaf, "model", mesh=mesh).mul(rank + 1).sum().backward()
    out["copy_to_grad"] = leaf.grad.numpy()
    full = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    spec = (("data", "model"), None)
    piece = port_sharding.shard(full, spec, mesh)
    out["piece"] = piece.numpy()
    out["unshard"] = port_sharding.unshard(piece, spec, mesh).numpy()
    out["rows"] = port_sharding.batch_rows(8, mesh)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return distributed.run_world(_collectives_worker, 4, timeout_s=WORLD_TIMEOUT_S,
                                 store_dir=str(tmp_path_factory.mktemp("world")))


def _x(rank):
    return np.arange(8, dtype=np.float32).reshape(2, 4) + 100 * rank


def test_mesh_groups_follow_the_reference_device_order(world):
    # create_mesh reshapes the device list row-major over (data, fsdp,
    # model, context, pipe): rank = data * 2 + model here.
    for rank, r in enumerate(world):
        assert (r["coords"]["data"], r["coords"]["model"]) == divmod(rank, 2)
        assert r["model_members"] == [rank - rank % 2, rank - rank % 2 + 1]
        assert r["data_members"] == [rank % 2, rank % 2 + 2]
        assert r["world"] == [0, 1, 2, 3]


def test_reductions(world):
    for rank, r in enumerate(world):
        partner = rank ^ 1
        np.testing.assert_array_equal(r["psum_model"], _x(rank) + _x(partner))
        np.testing.assert_array_equal(r["pmax_world"], _x(3))
        np.testing.assert_array_equal(r["pmean_data"], (_x(rank % 2) + _x(rank % 2 + 2)) / 2)


def test_all_gather_and_reduce_scatter_transpose_each_other(world):
    weights = np.arange(2 * 16, dtype=np.float32).reshape(2, 16)
    for rank, r in enumerate(world):
        np.testing.assert_array_equal(r["all_gather"], np.concatenate([_x(i) for i in range(4)],
                                                                      axis=1))
        # backward: the weights summed over the 4 ranks, this rank's columns
        np.testing.assert_array_equal(r["all_gather_grad"], 4 * weights[:, 4 * rank:4 * rank + 4])
        base = rank - rank % 2
        total = _x(base) + _x(base + 1)
        np.testing.assert_array_equal(r["reduce_scatter"], total[:, 2 * (rank % 2):][:, :2])
        grad = np.concatenate([np.full((2, 2), base + 1.0), np.full((2, 2), base + 2.0)], axis=1)
        np.testing.assert_array_equal(r["reduce_scatter_grad"], grad)
        np.testing.assert_array_equal(r["copy_to_grad"], np.full((2, 4), 2 * base + 3.0))


def test_ppermute_and_all_to_all_transpose_to_the_inverse(world):
    for rank, r in enumerate(world):
        src, dst = (rank - 1) % 4, (rank + 1) % 4
        np.testing.assert_array_equal(r["ppermute"][0], _x(src))
        np.testing.assert_array_equal(r["ppermute"][1], 2 * _x(src))
        np.testing.assert_array_equal(r["ppermute_grad"], np.full((2, 4), dst + 1.0 + 2.0))
        # lax.all_to_all(split_axis=1, concat_axis=2, tiled): chunk j of dim 1
        # to rank j, received chunks concatenated along dim 2 in rank order.
        ys = [np.arange(48, dtype=np.float32).reshape(2, 4, 6) + 1000 * i for i in range(4)]
        want = np.concatenate([y[:, rank:rank + 1] for y in ys], axis=2)
        np.testing.assert_array_equal(r["all_to_all"], want)
        # backward: every chunk of this rank's input landed in columns
        # 6*rank: of some rank's output, all weighted alike.
        w = np.arange(2 * 1 * 24, dtype=np.float32).reshape(2, 1, 24)
        np.testing.assert_array_equal(r["all_to_all_grad"],
                                      np.repeat(w[:, :, 6 * rank:6 * rank + 6], 4, axis=1))


def test_shard_unshard_and_batch_rows(world):
    full = np.arange(24, dtype=np.float32).reshape(4, 6)
    for rank, r in enumerate(world):
        np.testing.assert_array_equal(r["piece"], full[rank:rank + 1])
        np.testing.assert_array_equal(r["unshard"], full)
        # batch over (data, fsdp): data-major rows, model ranks share theirs
        i = rank // 2
        assert r["rows"] == slice(4 * i, 4 * i + 4)


def test_run_world_names_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        distributed.run_world(_fail_on_rank_one, 2, timeout_s=WORLD_TIMEOUT_S,
                              store_dir=str(tmp_path))


def _fail_on_rank_one(rank: int):
    if rank == 1:
        raise ValueError("boom")
    return rank


def test_backend_choice_and_one_process_is_no_group(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.choose_backend("cuda", 1) == "nccl"
    assert distributed.choose_backend("cuda", 2) == "gloo"  # two ranks on one card
    assert distributed.choose_backend("cpu", 1) == "gloo"
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize(device="cpu") is None
    assert distributed.process_count() == 1 and distributed.is_primary()
    np.testing.assert_array_equal(distributed.allgather_host(np.arange(3)), [[0, 1, 2]])
