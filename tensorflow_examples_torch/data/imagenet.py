"""The ImageNet input pipeline: the port of the TensorFlow-free paths of
``tensorflow_examples_tpu/data/imagenet.py``.

* Without shards, a seeded synthetic stream of label-correlated
  low-rank images (``SyntheticImageNet``, ``synthetic_train_iter``,
  ``synthetic_eval_iter``): the reference's arrays, bit for bit.
* With ``<split>-*`` TFRecord shards of the standard schema
  (``image/encoded``, 1-based ``image/class/label``),
  ``parallel_tfrecord_iter``: shard readers (``data/sources.py``) feed a
  pool of decode workers (``data/workers.py``), each turning one batch
  of records into images through ``decode_augment_batch``. Train is an
  endless chain of epochs, each a seeded shard permutation read in a
  fixed order through a seeded shuffle buffer, with the epoch's
  remainder dropped; eval is one pass whose last batch is padded with
  ``mask`` 0. Every batch is a pure function of (seed, step), so the
  stream is the same for any reader or worker count, and resuming at a
  step replays the uninterrupted stream from there.
* ``decode_augment_batch`` is the JPEG stage: the port's own JPEG
  decoder (libjpeg-turbo's integer decode repeated, no libjpeg), the
  ResNet random-resized crop (train) or central 87.5% crop (eval),
  bilinear resize, flip and normalize, in one threaded C++ call
  (``data/csrc/jpeg.cpp`` through ``native.py``, the stage of the
  reference's ``native/fastjpeg.cpp``), each image's draws from a
  splitmix64 stream keyed on (seed, step, row). Its plain version,
  ``_decode_crop_resize`` with the same draws (``_SplitMix64``,
  ``_mirror_crop``), decodes with PIL, imported inside the function: it
  is what the CPU tests hold the C++ stage to, and runs only on a
  machine without CUDA. On a CUDA machine the C++ stage is the only
  decode, and a failure to build or load it raises.

The reference's ``tf.data`` streams (``tfrecord_iter``, its exact-resume
and native variants) are not ported: the card has no TensorFlow. Shards
read with ``num_workers=0`` take the sequential stream the parallel one
is bit-identical to. Hosts are ``host_index``/``host_count`` arguments
(0 and 1 by default) in place of ``jax.process_*``.
"""

from __future__ import annotations

import contextlib
import glob as glob_mod
import hashlib
import json
import math
import os
from typing import Iterator

import numpy as np

MEAN_RGB = np.array([0.485, 0.456, 0.406], np.float32)
STDDEV_RGB = np.array([0.229, 0.224, 0.225], np.float32)


# --------------------------------------------------------------- synthetic


class SyntheticImageNet:
    """Streaming label-correlated synthetic images: the image of class c
    is ``outer(u_c, v_c)`` times a per-class colour phase, plus noise; u
    and v are seeded per class, so memory is O(classes x size)."""

    def __init__(self, *, image_size=224, num_classes=1000, seed=0):
        rng = np.random.default_rng(seed)
        self.u = rng.normal(0, 1, (num_classes, image_size)).astype(np.float32)
        self.v = rng.normal(0, 1, (num_classes, image_size)).astype(np.float32)
        self.phase = rng.normal(0, 1, (num_classes, 3)).astype(np.float32)
        self.num_classes = num_classes
        self.image_size = image_size

    def batch(self, batch_size: int, rng: np.random.Generator):
        y = rng.integers(0, self.num_classes, batch_size).astype(np.int32)
        base = np.einsum("bh,bw->bhw", self.u[y], self.v[y])
        img = base[..., None] * self.phase[y][:, None, None, :]
        img += rng.normal(0, 2.0, img.shape).astype(np.float32)
        return {"image": img.astype(np.float32), "label": y}


def synthetic_train_iter(batch_size: int, *, image_size=224, num_classes=1000, seed=0,
                         start_step=0) -> Iterator[dict]:
    src = SyntheticImageNet(image_size=image_size, num_classes=num_classes, seed=seed)
    step = start_step
    while True:
        yield src.batch(batch_size, np.random.default_rng((seed, step)))
        step += 1


def synthetic_eval_iter(batch_size: int, *, image_size=224, num_classes=1000, seed=1,
                        batches=8) -> Iterator[dict]:
    src = SyntheticImageNet(image_size=image_size, num_classes=num_classes, seed=seed)
    for step in range(batches):
        b = src.batch(batch_size, np.random.default_rng((seed, step)))
        b["mask"] = np.ones(batch_size, np.float32)
        yield b


# ------------------------------------------------------------ JPEG stage


def _native_decode_enabled() -> bool:
    """The port's C++ stage is used whenever it built, unless
    ``TFE_TPU_NATIVE_DECODE=0``."""
    if os.environ.get("TFE_TPU_NATIVE_DECODE", "1") == "0":
        return False
    from tensorflow_examples_torch import native

    return native.available("jpeg")


def _image_seeds(seed: int, step: int, n: int) -> np.ndarray:
    """Per-image uint64 splitmix64 seeds, a pure function of (seed,
    batch index, row); the arithmetic wraps mod 2**64 in Python ints."""
    m = 2**64
    base = (seed * 0x9E3779B97F4A7C15 + step * 0xC2B2AE3D27D4EB4F) % m
    k3 = 0x165667B19E3779F9
    return np.array([(base + i * k3) % m for i in range(n)], np.uint64)


class _SplitMix64:
    MASK = 2**64 - 1

    def __init__(self, seed: int):
        self.s = int(seed) & self.MASK

    def next(self) -> int:
        self.s = (self.s + 0x9E3779B97F4A7C15) & self.MASK
        z = self.s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & self.MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & self.MASK
        return z ^ (z >> 31)

    def u01(self) -> float:
        return (self.next() >> 11) * (1.0 / 9007199254740992.0)


def _mirror_crop(h, w, train, rng):
    """(y0, x0, ch, cw, flip), draw for draw as ``fastjpeg.cpp`` draws:
    up to 10 tries of area 8-100% and aspect 3/4-4/3, else the central
    square; eval takes the central 87.5% square."""
    if not train:
        m = min(h, w)
        crop = max(1, int(0.875 * m))
        return (h - crop) // 2, (w - crop) // 2, crop, crop, False
    log_lo, log_hi = math.log(3 / 4), math.log(4 / 3)
    found = None
    for _ in range(10):
        a_frac = 0.08 + rng.u01() * 0.92
        ratio = math.exp(log_lo + rng.u01() * (log_hi - log_lo))
        area = a_frac * h * w
        cw = int(math.floor(math.sqrt(area * ratio) + 0.5))
        ch = int(math.floor(math.sqrt(area / ratio) + 0.5))
        if 1 <= cw <= w and 1 <= ch <= h:
            y0 = int(math.floor(rng.u01() * (h - ch + 1)))
            x0 = int(math.floor(rng.u01() * (w - cw + 1)))
            found = (y0, x0, ch, cw)
            break
    if found is None:
        m = min(h, w)
        found = ((h - m) // 2, (w - m) // 2, m, m)
    flip = rng.u01() < 0.5
    return (*found, flip)


def _decode_crop_resize(jpeg: bytes, *, train: bool, seed: int, out_size: int) -> np.ndarray:
    """One image through the plain version of ``fastjpeg.cpp``: PIL
    decode, the same crop and flip draws, bilinear resize; [S, S, 3] f32
    in 0..255, not normalized (the caller normalizes the batch)."""
    import io

    from PIL import Image

    img = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"), np.float64)
    h, w, _ = img.shape
    y0, x0, ch, cw, flip = _mirror_crop(h, w, train, _SplitMix64(seed))
    oy = np.arange(out_size)
    sy = y0 + (oy + 0.5) * ch / out_size - 0.5
    y1 = np.clip(np.floor(sy).astype(np.int64), 0, h - 1)
    y2 = np.clip(y1 + 1, 0, h - 1)
    fy = sy - np.floor(sy)
    sx = x0 + (oy + 0.5) * cw / out_size - 0.5
    x1 = np.clip(np.floor(sx).astype(np.int64), 0, w - 1)
    x2 = np.clip(x1 + 1, 0, w - 1)
    fx = sx - np.floor(sx)
    top = img[y1][:, x1] * ((1 - fy)[:, None] * (1 - fx)[None, :])[..., None] \
        + img[y1][:, x2] * ((1 - fy)[:, None] * fx[None, :])[..., None]
    bot = img[y2][:, x1] * (fy[:, None] * (1 - fx)[None, :])[..., None] \
        + img[y2][:, x2] * (fy[:, None] * fx[None, :])[..., None]
    res = top + bot
    if flip:
        res = res[:, ::-1]
    return res.astype(np.float32)


def decode_augment_reference(jpeg: bytes, *, train: bool, seed: int,
                             out_size: int) -> np.ndarray:
    """One image as ``fastjpeg.cpp`` makes it, in numpy (its denom-1
    path: exact when the crop is under twice ``out_size``)."""
    raw = _decode_crop_resize(jpeg, train=train, seed=seed, out_size=out_size)
    return ((raw / 255.0) - MEAN_RGB) / STDDEV_RGB


def decode_augment_batch(jpegs: list, labels: list, *, train: bool, image_size: int, seed: int,
                         step: int, threads: int | None = None) -> dict:
    """One pipeline batch of JPEGs decoded, augmented and normalized;
    deterministic given (seed, step, row). The port's C++ stage
    (``data/csrc/jpeg.cpp``) when it built and is enabled; an undecodable
    row raises, naming the batch and rows. Otherwise the plain PIL
    version with the same draws, on a machine without CUDA only."""
    from tensorflow_examples_torch.data import augment as augment_mod

    n = len(jpegs)
    seeds = _image_seeds(seed, step, n) if train else None
    if _native_decode_enabled():
        from tensorflow_examples_torch import native

        img, ok = native.decode_augment_batch(jpegs, train=train, out_size=image_size,
                                              seeds=seeds, mean=MEAN_RGB, std=STDDEV_RGB,
                                              threads=threads)
        if not ok.all():
            # A zero-filled image under a real label would corrupt training.
            bad = [int(i) for i in np.flatnonzero(ok == 0)]
            raise ValueError(f"undecodable JPEG record(s) at batch {step} rows {bad} "
                             "(corrupt shard?)")
        return {"image": img, "label": np.asarray(labels, np.int32)}
    import torch

    if torch.cuda.is_available():
        from tensorflow_examples_torch import native

        why = native.build_errors.get("jpeg", "TFE_TPU_NATIVE_DECODE=0")
        raise RuntimeError(
            "the JPEG stage needs the port's decoder (tensorflow_examples_torch/data/csrc/"
            f"jpeg.cpp) on a CUDA machine, and it is not in use ({why}); the plain PIL decode "
            "runs only without CUDA")
    raw = np.stack([_decode_crop_resize(j, train=train,
                                        seed=int(seeds[i]) if seeds is not None else 0,
                                        out_size=image_size)
                    for i, j in enumerate(jpegs)])
    img = augment_mod.normalize_images(raw, MEAN_RGB, STDDEV_RGB)
    return {"image": img, "label": np.asarray(labels, np.int32)}


# ------------------------------------------------------------ TFRecords


def has_tfrecords(data_dir: str, split: str) -> bool:
    return bool(data_dir) and bool(glob_mod.glob(os.path.join(data_dir, f"{split}-*")))


def parse_imagenet_example(record: bytes) -> tuple[bytes, int]:
    """(JPEG bytes, 0-based label) of one standard ImageNet Example."""
    from tensorflow_examples_torch.data import sources as sources_mod

    feats = sources_mod.parse_example(record)
    try:
        jpeg = feats["image/encoded"][0]
        label = int(feats["image/class/label"][0]) - 1  # 1-based on disk
    except (KeyError, IndexError) as e:
        raise ValueError(f"record is not ImageNet-schema (have {sorted(feats)})") from e
    return jpeg, label


def _count_records_py(host_files: list, data_dir: str, tag: str) -> int:
    """The record count of a host's shards, one pass of reads (no
    decode), cached in a host-local directory (``$TFE_TPU_CACHE_DIR``,
    default ``~/.cache/tensorflow_examples_torch``) under a key of the
    data directory and the shards' names and sizes."""
    from tensorflow_examples_torch.data import sources as sources_mod

    is_url = "://" in data_dir
    sig = hashlib.sha1("|".join(
        [data_dir if is_url else os.path.abspath(data_dir)]
        + [f"{os.path.basename(f)}:{os.path.getsize(f)}" for f in host_files]
    ).encode()).hexdigest()[:16]
    cache_dir = os.environ.get("TFE_TPU_CACHE_DIR", os.path.join(
        os.path.expanduser("~"), ".cache", "tensorflow_examples_torch"))
    cache = os.path.join(cache_dir, f"record_count-{tag}-{sig}.json")
    with contextlib.suppress(Exception):
        with open(cache) as fh:
            return int(json.load(fh)["count"])
    n = sum(sum(1 for _ in sources_mod.iter_tfrecord_records(f)) for f in host_files)
    with contextlib.suppress(Exception):
        os.makedirs(cache_dir, exist_ok=True)
        with open(cache, "w") as fh:
            json.dump({"count": n}, fh)
    return n


def parallel_tfrecord_iter(data_dir: str, split: str, batch_size: int, *, train: bool,
                           image_size: int = 224, seed: int = 0, num_readers: int = 2,
                           num_workers: int = 0, start_step: int = 0, host_index: int = 0,
                           host_count: int = 1, buffer_records: int = 512,
                           decode_threads: int | None = None,
                           shuffle_window: int | None = None):
    """Batches of ``<data_dir>/<split>-*`` shards; this host reads
    ``files[host_index::host_count]``.

    Train: an endless chain of epochs, each a seeded shard permutation
    read in order through a shuffle buffer of ``16 * batch_size`` records
    (``shuffle_window`` overrides; 0 disables) seeded per epoch, the
    remainder dropped, each image's augment seeded on the global batch
    index. ``start_step`` resumes mid-epoch, skipping at most one epoch's
    records and none of the decode. Eval: one pass, the last batch
    padded with ``mask`` 0.

    ``num_workers > 0`` returns a closeable
    :class:`~tensorflow_examples_torch.data.workers.PipelinedIterator`
    (``background = True``); ``num_workers == 0`` decodes inline, the
    sequential stream the parallel one equals.
    """
    from tensorflow_examples_torch.data import sources as sources_mod
    from tensorflow_examples_torch.data import workers as workers_mod

    pattern = os.path.join(data_dir, f"{split}-*")
    files = sorted(glob_mod.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no TFRecord shards matching {pattern}")
    host_files = files[host_index::host_count]
    if not host_files:
        raise ValueError(f"host {host_index}/{host_count} holds zero of the {len(files)} "
                         f"{split} shards")
    # Pool workers decode single-threaded (the pool is the parallelism);
    # inline, the C++ stage uses its own threads unless pinned.
    if decode_threads is None and num_workers > 0:
        decode_threads = 1

    def decode(item):
        """One worker item: a batch of raw records parsed and decoded
        (parsing here keeps the consumer's share small)."""
        step, records = item
        jpegs, labels = [], []
        for rec in records:
            jpeg, label = parse_imagenet_example(rec)
            jpegs.append(jpeg)
            labels.append(label)
        return decode_augment_batch(jpegs, labels, train=train, image_size=image_size,
                                    seed=seed, step=step, threads=decode_threads)

    def read(shards):
        return sources_mod.interleave_shards(shards, sources_mod.iter_tfrecord_records,
                                             num_readers=num_readers,
                                             buffer_records=buffer_records)

    if train:
        n_records = _count_records_py(host_files, data_dir, f"{split}-h{len(host_files)}")
        bpe = n_records // batch_size
        if bpe == 0:
            raise ValueError(f"{n_records} records in this host's {split} shards is less than "
                             f"one batch of {batch_size}")
        epoch0, within = divmod(start_step, bpe)

        def raw_batches():
            step, epoch, skip = start_step, epoch0, within * batch_size
            window = 16 * batch_size if shuffle_window is None else shuffle_window
            while True:
                rng = np.random.default_rng((seed, epoch))
                records = read([host_files[i] for i in rng.permutation(len(host_files))])
                # The skip runs after the shuffle, so batch N of a resumed
                # epoch is the uninterrupted run's batch N.
                stream = sources_mod.seeded_window_shuffle(
                    records, window, np.random.default_rng((seed, epoch, 1)))
                group: list = []
                with contextlib.closing(records):
                    skipped = 0
                    for rec in stream:
                        if skipped < skip:
                            skipped += 1
                            continue
                        group.append(rec)
                        if len(group) == batch_size:
                            yield (step, group)
                            step += 1
                            group = []
                epoch += 1  # the remainder is dropped: bpe batches an epoch
                skip = 0
    else:

        def raw_batches():
            records = read(host_files)
            group: list = []
            step = 0
            with contextlib.closing(records):
                for rec in records:
                    group.append(rec)
                    if len(group) == batch_size:
                        yield (step, group)
                        step += 1
                        group = []
            if group:
                yield (step, group)

    source = raw_batches()

    def finish(batch: dict) -> dict:
        if train:
            return batch
        n = len(batch["label"])
        if n < batch_size:  # the last row repeated, under mask 0
            pad = batch_size - n
            batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                     for k, v in batch.items()}
            batch["mask"] = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
        else:
            batch["mask"] = np.ones(n, np.float32)
        return batch

    if num_workers > 0:
        pool = workers_mod.WorkerPool(decode, num_workers, name="imagenet_decode")
        decoded = workers_mod.PipelinedIterator(pool, source)
        return decoded if train else _FinishingIterator(decoded, finish)
    return (finish(decode(item)) for item in source)


class _FinishingIterator:
    """A host-side finisher over a background pipeline that keeps its
    ``background`` and ``close`` visible to the prefetch layer."""

    background = True

    def __init__(self, inner, finish):
        self._inner = inner
        self._finish = finish

    def __iter__(self):
        return self

    def __next__(self):
        return self._finish(next(self._inner))

    def close(self) -> None:
        self._inner.close()
