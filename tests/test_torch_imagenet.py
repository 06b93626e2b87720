"""ImageNet in the port against the JAX package (PyTorch/CUDA port).

* The synthetic train and eval streams: the reference's batches, bit for
  bit, from any start step.
* The JPEG stage on ``tests/data/imagenet_fixture.tfrecord`` (64 seeded
  JPEGs from 256 x 320 to 500 x 375, written by
  ``tests/data/make_imagenet_fixture.py``): the crop draws
  (``_mirror_crop``) and the plain PIL decode equal the reference's; the
  port's stage (``data/csrc/jpeg.cpp``) lies within ``2.5 / 255 / 0.22``
  (about 2.5 uint8 counts, normalized) of the plain decode where the
  crop takes the full-size decode, and close to it where it takes the
  DCT-scaled one; ``native/fastjpeg.cpp`` through the port's binding
  equals it through the reference's, exactly; an undecodable row raises
  in both. (``tests/test_torch_jpeg.py`` holds the decoder itself.)
* ``parallel_tfrecord_iter`` over shards written from the fixture: the
  reference's batches, bit for bit, for train with 0 and 2 workers and
  1 and 2 readers across an epoch boundary, resumed mid-epoch, and for
  eval with the last batch padded under mask 0; on the plain decode too.
* Label smoothing and top-5 (logits with ties) against the reference's
  at 1e-6.
* The reference's tiny ``ImagenetConfig`` (ResNet-50, image 32, 4
  classes, batch 16, f32): a 5-step loss trajectory and the
  ``batch_stats`` after every step against the JAX ``Trainer`` at rtol
  3e-3 from the same weights and batches, and its synthetic eval's
  metrics.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_examples_tpu import native as jax_native
from tensorflow_examples_tpu.data import imagenet as jax_imagenet
from tensorflow_examples_tpu.data import sources as jax_sources
from tensorflow_examples_tpu.ops import losses as jax_losses
from tensorflow_examples_tpu.sharding import ShardingConfig
from tensorflow_examples_tpu.train import loop as jax_loop
from tensorflow_examples_tpu.workloads import imagenet as jax_workload
from tensorflow_examples_torch import native
from tensorflow_examples_torch.data import imagenet, sources
from tensorflow_examples_torch.models import convert
from tensorflow_examples_torch.ops import losses
from tensorflow_examples_torch.train.loop import Trainer
from tensorflow_examples_torch.workloads import imagenet as workload

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "imagenet_fixture.tfrecord")
NORMALIZED_ATOL = 2.5 / 255.0 / 0.22  # the reference's fastjpeg tolerance


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """Record counts cached under the test's own directory; one torch
    thread."""
    monkeypatch.setenv("TFE_TPU_CACHE_DIR", str(tmp_path / "cache"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fixture_records() -> list[bytes]:
    return list(sources.iter_tfrecord_records(FIXTURE, verify_crc=True))


def fixture_jpegs() -> list[tuple[bytes, int]]:
    return [imagenet.parse_imagenet_example(r) for r in fixture_records()]


def test_fixture_is_64_distinct_imagenet_examples():
    recs = fixture_records()
    assert len(recs) == 64 and os.path.getsize(FIXTURE) < 1.5e6
    parsed = [sources.parse_example(r) for r in recs]
    assert parsed == [jax_sources.parse_example(r) for r in recs]
    jpegs = [p["image/encoded"][0] for p in parsed]
    assert len(set(jpegs)) == 64
    dims = {(p["image/height"][0], p["image/width"][0]) for p in parsed}
    assert min(dims) == (256, 320) and max(h * w for h, w in dims) == 500 * 375
    assert all(1 <= p["image/class/label"][0] <= 1000 for p in parsed)
    for (jpeg, label), p in zip(fixture_jpegs(), parsed):
        assert label == p["image/class/label"][0] - 1
        assert native.jpeg_dims(jpeg) == (p["image/height"][0], p["image/width"][0])


@pytest.mark.parametrize("split,start", [("train", 0), ("train", 5), ("eval", 0)])
def test_synthetic_streams_equal_the_reference(split, start):
    kw = dict(image_size=24, num_classes=7, seed=3)
    if split == "train":
        ours = imagenet.synthetic_train_iter(4, start_step=start, **kw)
        theirs = jax_imagenet.synthetic_train_iter(4, start_step=start, **kw)
    else:
        ours = imagenet.synthetic_eval_iter(4, batches=3, **kw)
        theirs = jax_imagenet.synthetic_eval_iter(4, batches=3, **kw)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_crop_draws_and_seeds_equal_the_reference():
    for seed in range(200):
        for train in (True, False):
            h, w = 40 + seed % 300, 50 + (seed * 7) % 400
            assert imagenet._mirror_crop(h, w, train, imagenet._SplitMix64(seed)) == \
                jax_imagenet._mirror_crop(h, w, train, jax_imagenet._SplitMix64(seed))
    for seed, step in ((0, 0), (7, 123456), (2**40, 2**33)):
        np.testing.assert_array_equal(imagenet._image_seeds(seed, step, 9),
                                      jax_imagenet._image_seeds(seed, step, 9))


@pytest.mark.parametrize("train", [True, False])
def test_plain_decode_equals_the_reference(train):
    for i, (jpeg, _) in enumerate(fixture_jpegs()[:6]):
        ours = imagenet._decode_crop_resize(jpeg, train=train, seed=1000 + i, out_size=64)
        theirs = jax_imagenet._decode_crop_resize(jpeg, train=train, seed=1000 + i, out_size=64)
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("train", [True, False])
def test_native_stage_equals_the_reference_and_the_plain_decode(train):
    assert native.available("jpeg") and native.available("fastjpeg")
    pairs = fixture_jpegs()[:8]
    jpegs = [j for j, _ in pairs]
    seeds = imagenet._image_seeds(11, 3, len(jpegs))
    kw = dict(train=train, seeds=seeds, mean=imagenet.MEAN_RGB, std=imagenet.STDDEV_RGB)
    # 224 px: every crop of these images is under 448, the full-size decode.
    ours, ok = native.decode_augment_batch(jpegs, out_size=224, **kw)
    bound, ok_bound = native.decode_augment_batch(jpegs, out_size=224, library="fastjpeg", **kw)
    theirs, ok_ref = jax_native.decode_augment_batch(jpegs, out_size=224, **kw)
    assert ok.all() and ok_bound.all() and ok_ref.all()
    np.testing.assert_array_equal(bound, theirs)
    for i, j in enumerate(jpegs):
        ref = imagenet.decode_augment_reference(j, train=train, seed=int(seeds[i]), out_size=224)
        np.testing.assert_allclose(ours[i], ref, atol=NORMALIZED_ATOL, err_msg=f"image {i}")
    # 32 px: the DCT-scaled decode, a prefilter of the same image.
    small, _ = native.decode_augment_batch(jpegs[:3], out_size=32, **{**kw, "seeds": seeds[:3]})
    for i, j in enumerate(jpegs[:3]):
        ref = imagenet.decode_augment_reference(j, train=train, seed=int(seeds[i]), out_size=32)
        assert float(np.abs(small[i] - ref).mean()) < 0.08
        np.testing.assert_allclose(small[i], ref, atol=0.5)


def test_undecodable_row_raises_at_its_batch():
    jpegs = [fixture_jpegs()[0][0], b"not a jpeg", fixture_jpegs()[1][0]]
    for mod in (imagenet, jax_imagenet):
        with pytest.raises(ValueError, match=r"batch 4 rows \[1\]"):
            mod.decode_augment_batch(jpegs, [0, 1, 2], train=True, image_size=16, seed=0, step=4)


def write_shards(root, *, train_shards=3, per_shard=10, val=13) -> str:
    """Shards of fixture records: ``train_shards`` of ``per_shard`` and a
    validation shard of ``val`` (seeded labels, payloads reused)."""
    recs = fixture_records()
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    i = 0
    for name, n in [(f"train-{s:05d}-of-{train_shards:05d}", per_shard)
                    for s in range(train_shards)] + [("validation-00000-of-00001", val)]:
        out = []
        for _ in range(n):
            jpeg, _ = imagenet.parse_imagenet_example(recs[i % len(recs)])
            out.append(sources.make_example({"image/encoded": jpeg,
                                             "image/class/label": int(rng.integers(1, 5))}))
            i += 1
        sources.write_tfrecord(os.path.join(root, name), out)
    return str(root)


def _take(it, n):
    out = [next(it) for _ in range(n)]
    close = getattr(it, "close", None)
    if close is not None:
        close()
    return out


def _assert_batches_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("workers,readers", [(0, 1), (2, 2)])
def test_train_stream_equals_the_reference_and_resumes(tmp_path, workers, readers):
    root = write_shards(tmp_path / "data")
    kw = dict(train=True, image_size=32, seed=5, num_readers=readers, shuffle_window=8,
              host_index=0, host_count=1)
    # 30 records at batch 4: 7 batches an epoch, so 9 steps cross into epoch 1.
    ours = _take(imagenet.parallel_tfrecord_iter(root, "train", 4, num_workers=workers, **kw), 9)
    theirs = _take(jax_imagenet.parallel_tfrecord_iter(root, "train", 4, num_workers=0, **kw), 9)
    _assert_batches_equal(ours, theirs)
    assert not np.array_equal(ours[0]["image"], ours[7]["image"])
    for start in (3, 7):
        resumed = _take(imagenet.parallel_tfrecord_iter(root, "train", 4, num_workers=workers,
                                                        start_step=start, **kw), 2)
        _assert_batches_equal(resumed, ours[start:start + 2])


@pytest.mark.parametrize("workers", [0, 2])
def test_eval_stream_pads_as_the_reference(tmp_path, workers):
    root = write_shards(tmp_path / "data")
    kw = dict(train=False, image_size=32, num_readers=2, host_index=0, host_count=1)
    ours = list(imagenet.parallel_tfrecord_iter(root, "validation", 5, num_workers=workers, **kw))
    theirs = list(jax_imagenet.parallel_tfrecord_iter(root, "validation", 5, num_workers=0, **kw))
    _assert_batches_equal(ours, theirs)
    assert [float(b["mask"].sum()) for b in ours] == [5.0, 5.0, 3.0]
    np.testing.assert_array_equal(ours[-1]["image"][3], ours[-1]["image"][2])


def test_plain_decode_stream_equals_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("TFE_TPU_NATIVE_DECODE", "0")
    root = write_shards(tmp_path / "data", train_shards=2, per_shard=4, val=3)
    kw = dict(train=True, image_size=16, seed=2, num_readers=2, host_index=0, host_count=1)
    _assert_batches_equal(
        _take(imagenet.parallel_tfrecord_iter(root, "train", 4, num_workers=2, **kw), 3),
        _take(jax_imagenet.parallel_tfrecord_iter(root, "train", 4, **kw), 3))


def test_plain_decode_is_refused_where_cuda_is(monkeypatch):
    monkeypatch.setenv("TFE_TPU_NATIVE_DECODE", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="the port's decoder"):
        imagenet.decode_augment_batch([fixture_jpegs()[0][0]], [0], train=True, image_size=16,
                                      seed=0, step=0)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_label_smoothing_and_top5_match_the_reference(smoothing):
    rng = np.random.default_rng(0)
    logits = np.round(rng.standard_normal((64, 12)) * 2) / 2  # many ties
    logits = logits.astype(np.float32)
    labels = rng.integers(0, 12, 64).astype(np.int32)
    weights = (rng.random(64) < 0.8).astype(np.float32)
    t = lambda x: torch.from_numpy(x)
    for w in (None, weights):
        ours = losses.softmax_cross_entropy(t(logits), t(labels), label_smoothing=smoothing,
                                            weights=None if w is None else t(w))
        theirs = jax_losses.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                                  label_smoothing=smoothing,
                                                  weights=None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)
        m = losses.accuracy_metrics(t(logits), t(labels), None if w is None else t(w), top5=True)
        jm = jax_losses.accuracy_metrics(jnp.asarray(logits), jnp.asarray(labels),
                                         None if w is None else jnp.asarray(w), top5=True)
        assert m.keys() == jm.keys()
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6, err_msg=k)
    # Ties at the fifth place all count as inside (a top-k sort would keep
    # one of them); five logits strictly above the label's put it outside.
    tied = torch.tensor([[3.0, 3.0, 3.0, 3.0, 2.0, 2.0, 2.0, 1.0]])
    top5 = lambda label: float(losses.accuracy_metrics(tied, torch.tensor([label]),
                                                       top5=True)["top5_accuracy"])
    assert (top5(6), top5(4), top5(7)) == (1.0, 1.0, 0.0)


def tiny_configs(**kw):
    """The reference's ``tiny_config`` (tests/test_train_imagenet.py) in both
    packages."""
    base = dict(image_size=32, num_classes=4, global_batch_size=16, train_steps=25,
                warmup_steps=5, learning_rate=0.01, log_every=10, eval_every=0,
                precision="f32", eval_batches=2)
    base.update(kw)
    return (jax_workload.ImagenetConfig(checkpoint_every=0, **base),
            workload.ImagenetConfig(device="cpu", telemetry_sinks="", checkpoint_every=0, **base))


def _dotted(path: str) -> str:
    collection, rest = path.split("/", 1)
    return f"{collection}/{rest.replace('/', '.')}"


@pytest.mark.timeout(240)
def test_five_step_trajectory_batch_stats_and_eval_match_jax_trainer():
    jax_cfg, cfg = tiny_configs()
    sc = ShardingConfig(mesh={"data": 1})
    mesh = sc.build_mesh()
    jt = jax_loop.Trainer(jax_workload.make_task(jax_cfg, mesh=mesh), jax_cfg, mesh=mesh,
                          sharding=sc)
    init = jax.tree.map(np.asarray, jt.state.params)
    batches = [next(workload.make_train_iter(cfg, s)) for s in range(5)]
    state, theirs, their_stats = jt.state, [], []
    for b in batches:
        state, metrics = jt._train_step(state, jt._put_batch(b))
        theirs.append(float(metrics["loss"]))
        their_stats.append(convert.flatten_tree(jax.tree.map(np.asarray, state.model_state)))
    jt.state = state
    trainer = Trainer(workload.make_task(cfg), cfg, init_params=init)
    ours = []
    for step, b in enumerate(batches):
        ours.append(float(trainer.train_step(b)["loss"]))
        stats = {f"{c}/{k}": t.numpy() for c, tree in trainer.state.model_state.items()
                 for k, t in tree.items()}
        assert stats.keys() == {_dotted(k) for k in their_stats[step]}
        for k, t in their_stats[step].items():
            np.testing.assert_allclose(stats[_dotted(k)], t, rtol=3e-3, atol=1e-5,
                                       err_msg=f"{k} after step {step}")
    np.testing.assert_allclose(ours, theirs, rtol=3e-3, atol=0)
    ours_eval = trainer.evaluate(workload.make_eval_iter(cfg))
    theirs_eval = jt.evaluate(jax_workload.make_eval_iter(jax_cfg))
    assert set(ours_eval) == {"accuracy", "top5_accuracy", "loss"} <= set(theirs_eval)
    for k in ours_eval:
        np.testing.assert_allclose(ours_eval[k], theirs_eval[k], rtol=3e-3, atol=1e-6,
                                   err_msg=k)


@pytest.mark.timeout(240)
def test_grad_accum_with_batch_stats_matches_jax_trainer():
    """The recipe's batch on one card is ``grad_accum_steps`` micro-batches:
    BatchNorm normalizes by each micro-batch and its running statistics
    move on every micro-step, while the optimizer applies the mean
    gradient every ``grad_accum_steps``-th one, in both packages."""
    jax_cfg, cfg = tiny_configs(grad_accum_steps=2)
    sc = ShardingConfig(mesh={"data": 1})
    mesh = sc.build_mesh()
    jt = jax_loop.Trainer(jax_workload.make_task(jax_cfg, mesh=mesh), jax_cfg, mesh=mesh,
                          sharding=sc)
    init = jax.tree.map(np.asarray, jt.state.params)
    trainer = Trainer(workload.make_task(cfg), cfg, init_params=init)
    state = jt.state
    prev = {k.replace("/", "."): v for k, v in convert.flatten_tree(init).items()}
    for step in range(4):
        b = next(workload.make_train_iter(cfg, step))
        state, _ = jt._train_step(state, jt._put_batch(b))
        trainer.train_step(b)
        theirs = {"params": convert.flatten_tree(jax.tree.map(np.asarray, state.params)),
                  **{c: convert.flatten_tree(jax.tree.map(np.asarray, tree), f"{c}/")
                     for c, tree in state.model_state.items()}}
        ours = {"params": {k: t.numpy() for k, t in trainer.state.params.items()},
                **{c: {f"{c}/{k}": t.numpy() for k, t in tree.items()}
                   for c, tree in trainer.state.model_state.items()}}
        assert ours.keys() == theirs.keys()
        for c in theirs:
            key = (lambda k: k.replace("/", ".")) if c == "params" else _dotted
            assert set(ours[c]) == {key(k) for k in theirs[c]}, c
            for k, t in theirs[c].items():
                np.testing.assert_allclose(ours[c][key(k)], t, rtol=3e-3, atol=1e-5,
                                           err_msg=f"{k} after micro-step {step}")
        # An even micro-step only accumulates; the first update (micro-step
        # 1) runs at the warmup's learning rate 0, the second moves them.
        moved = sum(not np.array_equal(v, prev[k]) for k, v in ours["params"].items())
        assert (moved > 0) == (step == 3), f"{moved} params moved at micro-step {step}"
        prev = ours["params"]


def test_workload_streams_route_by_data_dir(tmp_path):
    root = write_shards(tmp_path / "data")
    _, cfg = tiny_configs(global_batch_size=4)
    assert not workload.train_iter_is_per_host(cfg)
    assert not getattr(workload.make_train_iter(cfg, 0), "background", False)
    cfg = cfg.replace(data_dir=root, input_workers=2, input_readers=2)
    assert workload.train_iter_is_per_host(cfg)
    it = workload.make_train_iter(cfg, 0)
    assert it.background
    first = _take(it, 2)
    inline = _take(workload.make_train_iter(cfg.replace(input_workers=0), 0), 2)
    _assert_batches_equal(first, inline)
    assert first[0]["image"].shape == (4, 32, 32, 3)
    evals = list(workload.make_eval_iter(cfg))
    assert [b["mask"].sum() for b in evals] == [4.0, 4.0, 4.0, 1.0]
    with pytest.raises(ValueError, match="unknown --model"):
        workload.make_task(cfg.replace(model="resnet51"))
