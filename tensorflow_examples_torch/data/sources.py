"""Dataset sources: the port of ``tensorflow_examples_tpu/data/sources.py``
(numpy only; the same files and seeds give the same arrays, bit for
bit). Each loader reads the standard on-disk format under ``data_dir``
and otherwise makes a seeded synthetic dataset of the true shapes,
dtypes and cardinalities: MNIST (IDX files), CIFAR-10 (the python-pickle
batches), LM token windows and GLUE features (``<task>_<split>.npz``).
File reads go through ``utils/faults.retry_io``, as the reference's do;
a missing file under a given ``data_dir`` is a config error, raised at
once.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from tensorflow_examples_torch.data.memory import InMemoryDataset
from tensorflow_examples_torch.utils.faults import retry_io


# ------------------------------------------------------------------ MNIST


def _read_idx(path: str) -> np.ndarray:
    """An IDX file (the MNIST distribution format), optionally gzipped."""

    def read():
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            _, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            dtype = {8: np.uint8, 9: np.int8, 11: np.int16, 12: np.int32,
                     13: np.float32}[dtype_code]
            return np.frombuffer(f.read(), dtype=dtype).reshape(dims)

    return retry_io(read, path)


def _find(data_dir: str, names: list[str]) -> str | None:
    for n in names:
        for cand in (n, n + ".gz"):
            p = os.path.join(data_dir, cand)
            if os.path.exists(p):
                return p
    return None


def load_mnist(data_dir: str = "", split: str = "train") -> InMemoryDataset:
    """MNIST as f32 [n, 28, 28, 1] images in [0, 1] and int32 labels."""
    prefix = "train" if split == "train" else "t10k"
    if data_dir:
        imgs = _find(data_dir, [f"{prefix}-images-idx3-ubyte", f"{prefix}-images.idx3-ubyte"])
        lbls = _find(data_dir, [f"{prefix}-labels-idx1-ubyte", f"{prefix}-labels.idx1-ubyte"])
        if not (imgs and lbls):
            raise FileNotFoundError(
                f"--data_dir={data_dir} set but MNIST IDX files not found there "
                "(expected train-images-idx3-ubyte etc.); omit --data_dir for "
                "synthetic data")
        x = _read_idx(imgs).astype(np.float32) / 255.0
        y = _read_idx(lbls).astype(np.int32)
        return InMemoryDataset({"image": x[..., None], "label": y})
    return synthetic_images(n=60000 if split == "train" else 10000, shape=(28, 28, 1),
                            num_classes=10, seed=0 if split == "train" else 1)


# ---------------------------------------------------------------- CIFAR-10


CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def load_cifar10(data_dir: str = "", split: str = "train", *,
                 normalized: bool = True) -> InMemoryDataset:
    """The python-pickle CIFAR-10 batches under ``data_dir`` (or its
    ``cifar-10-batches-py``) as NHWC images: normalized f32, or with
    ``normalized=False`` the uint8 pixels, for the fused crop, flip and
    normalize of ``data/augment.py``. Synthetic data is always f32."""
    if data_dir:
        batch_dir = data_dir
        nested = os.path.join(data_dir, "cifar-10-batches-py")
        if os.path.isdir(nested):
            batch_dir = nested
        names = [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
        paths = [os.path.join(batch_dir, n) for n in names]
        if not all(os.path.exists(p) for p in paths):
            raise FileNotFoundError(
                f"--data_dir={data_dir} set but CIFAR-10 python batches not "
                "found there; omit --data_dir for synthetic data")

        def read_batch(p):
            with open(p, "rb") as f:
                return pickle.load(f, encoding="bytes")

        xs, ys = [], []
        for p in paths:
            d = retry_io(lambda p=p: read_batch(p), p)
            xs.append(d[b"data"])
            ys.append(np.asarray(d[b"labels"]))
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y = np.concatenate(ys).astype(np.int32)
        if not normalized:
            return InMemoryDataset({"image": x.astype(np.uint8), "label": y})
        x = (x.astype(np.float32) / 255.0 - CIFAR10_MEAN) / CIFAR10_STD
        return InMemoryDataset({"image": x, "label": y})
    return synthetic_images(n=50000 if split == "train" else 10000, shape=(32, 32, 3),
                            num_classes=10, seed=2 if split == "train" else 3)


# ------------------------------------------------------------- LM corpora


def load_lm_tokens(
    data_dir: str = "",
    split: str = "train",
    *,
    seq_len: int = 1024,
    vocab_size: int = 50257,
) -> InMemoryDataset:
    """Token windows [n, seq_len+1] for causal-LM training.

    Reads ``<split>.bin`` (uint16 memmap, the common GPT-2 prep format),
    ``<split>.npy`` (any int dtype) or ``<split>.txt`` (byte-level, vocab
    256) under ``data_dir``. Windows are non-overlapping; the +1 column
    holds the shifted next-token labels. Without ``data_dir``: seeded
    synthetic bigram streams (learnable, so loss can be seen to fall).
    """
    if data_dir:
        base = os.path.join(data_dir, split)
        if os.path.exists(base + ".bin"):
            flat = retry_io(lambda: np.memmap(base + ".bin", dtype=np.uint16, mode="r"),
                            base + ".bin")
        elif os.path.exists(base + ".npy"):
            flat = retry_io(lambda: np.load(base + ".npy", mmap_mode="r"), base + ".npy")
        elif os.path.exists(base + ".txt"):

            def read_txt():
                with open(base + ".txt", "rb") as f:
                    return np.frombuffer(f.read(), dtype=np.uint8)

            flat = retry_io(read_txt, base + ".txt")
        else:
            raise FileNotFoundError(
                f"--data_dir={data_dir} set but {split}.bin/.npy/.txt not "
                "found there; omit --data_dir for synthetic data"
            )
        window = seq_len + 1
        n = len(flat) // window
        if n == 0:
            raise ValueError(f"corpus has {len(flat)} tokens < one window ({window})")
        toks = np.asarray(flat[: n * window]).astype(np.int32).reshape(n, window)
        if toks.max() >= vocab_size:
            raise ValueError(f"corpus token id {toks.max()} >= vocab_size {vocab_size}")
        return InMemoryDataset({"tokens": toks})
    return synthetic_tokens(
        n=512 if split == "train" else 64,
        seq_len=seq_len + 1,
        vocab_size=vocab_size,
        seed=4 if split == "train" else 5,
    )


# --------------------------------------------------------------- synthetic


def synthetic_images(n: int, shape: tuple[int, ...], num_classes: int,
                     seed: int = 0) -> InMemoryDataset:
    """Seeded learnable images: a class prototype plus noise of std 2, so
    training loss can be seen to fall."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    protos = rng.normal(0, 1, size=(num_classes,) + tuple(shape)).astype(np.float32)
    x = protos[y] + rng.normal(0, 2.0, size=(n,) + tuple(shape)).astype(np.float32)
    return InMemoryDataset({"image": x, "label": y})


def synthetic_tokens(n: int, seq_len: int, vocab_size: int, seed: int = 0) -> InMemoryDataset:
    """Seeded synthetic token streams with learnable bigram structure:
    each token prefers a fixed successor, replaced by a random token one
    time in five."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab_size, size=vocab_size)
    toks = np.empty((n, seq_len), dtype=np.int32)
    toks[:, 0] = rng.integers(0, vocab_size, size=n)
    noise = rng.random((n, seq_len)) < 0.2
    rand = rng.integers(0, vocab_size, size=(n, seq_len))
    for t in range(1, seq_len):
        toks[:, t] = np.where(noise[:, t], rand[:, t], succ[toks[:, t - 1]])
    return InMemoryDataset({"tokens": toks})


# ------------------------------------------------------------------- GLUE


GLUE_NUM_LABELS = {
    "cola": 2, "sst2": 2, "mrpc": 2, "stsb": 1, "qqp": 2,
    "mnli": 3, "qnli": 2, "rte": 2, "wnli": 2,
}


def load_glue(data_dir: str = "", task: str = "sst2", split: str = "train", *,
              seq_len: int = 128, vocab_size: int = 30522) -> InMemoryDataset:
    """Tokenized GLUE features for BERT: ``<task>_<split>.npz`` under
    ``data_dir`` (``tokens``, ``attention_mask``, ``token_type_ids`` [n, S]
    and ``label`` [n], f32 for STS-B; what ``data/tokenizers.WordPiece``
    writes offline), or the seeded synthetic task of the same schema."""
    if task not in GLUE_NUM_LABELS:
        raise ValueError(f"unknown GLUE task {task!r}; one of {sorted(GLUE_NUM_LABELS)}")
    if data_dir:
        path = os.path.join(data_dir, f"{task}_{split}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(f"--data_dir={data_dir} set but {task}_{split}.npz not "
                                    "found; omit --data_dir for synthetic data")
        d = retry_io(lambda: np.load(path), path)
        return InMemoryDataset({
            "tokens": d["tokens"].astype(np.int32),
            "attention_mask": d["attention_mask"].astype(np.int32),
            "token_type_ids": d["token_type_ids"].astype(np.int32),
            "label": d["label"].astype(np.float32 if task == "stsb" else np.int32),
        })
    return synthetic_glue(task, n=2048 if split == "train" else 256, seq_len=seq_len,
                          vocab_size=vocab_size, seed=6 if split == "train" else 7)


def synthetic_glue(task: str, *, n: int, seq_len: int, vocab_size: int,
                   seed: int = 0) -> InMemoryDataset:
    """Seeded synthetic sentence(-pair) data: lengths in [S/2, S], about 8
    marker tokens ``10 + class`` planted a row so the label is learnable
    (STS-B: the class scaled to [0, 5]), [CLS] (101) first, a type-id
    boundary at half the length, 0 past the length."""
    rng = np.random.default_rng(seed)
    classes = max(GLUE_NUM_LABELS[task], 2)
    toks = rng.integers(100, vocab_size, size=(n, seq_len)).astype(np.int32)
    lengths = rng.integers(seq_len // 2, seq_len + 1, size=n)
    mask = (np.arange(seq_len)[None, :] < lengths[:, None]).astype(np.int32)
    y = rng.integers(0, classes, size=n)
    for c in range(classes):
        for r in np.where(y == c)[0]:
            toks[r, rng.integers(1, lengths[r], size=8)] = 10 + c
    toks[:, 0] = 101
    boundary = np.maximum(lengths // 2, 1)
    type_ids = (np.arange(seq_len)[None, :] >= boundary[:, None]).astype(np.int32) * mask
    toks = np.where(mask > 0, toks, 0)
    label = (y.astype(np.float32) / (classes - 1) * 5.0 if task == "stsb"
             else y.astype(np.int32))
    return InMemoryDataset({"tokens": toks, "attention_mask": mask, "token_type_ids": type_ids,
                            "label": label})
