"""LM token sources: the port of ``load_lm_tokens`` and
``synthetic_tokens`` from ``tensorflow_examples_tpu/data/sources.py``
(numpy only; the same files and seeds give the same windows). File reads
go through ``utils/faults.retry_io``, as the reference's do."""

from __future__ import annotations

import os

import numpy as np

from tensorflow_examples_torch.data.memory import InMemoryDataset
from tensorflow_examples_torch.utils.faults import retry_io


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
