"""The data half of the BERT and image workloads in the port, against the
JAX package (PyTorch/CUDA port): every array bit for bit.

* ``synthetic_glue`` for every GLUE task, ``load_glue`` from an ``.npz``
  and its synthetic default, ``synthetic_images``;
* the IDX reader (plain and gzipped, uint8 and f32) and ``load_mnist``
  from IDX files; ``load_cifar10`` from python-pickle batches, normalized
  and as uint8; the missing-file errors;
* ``cifar_augment`` on f32 batches, on uint8 batches through the native
  library (``native/fastdata.cpp``, built from the repo's Makefile) and
  through the numpy fallback, each against the reference's same path,
  with the reference's rng draw order; ``normalize_images``,
  ``flip_images``, ``random_crop_flip`` and ``native.normalize``;
* WordPiece: a vocabulary built from a small corpus, its ``vocab.txt``
  round trip, tokenization (accents, CJK, punctuation, unknown words),
  sentence and pair encoding with truncation, and decoding.
"""

import gzip
import os
import pickle
import struct

import numpy as np
import pytest

from tensorflow_examples_tpu import native as jax_native
from tensorflow_examples_tpu.data import augment as jax_augment
from tensorflow_examples_tpu.data import sources as jax_sources
from tensorflow_examples_tpu.data import tokenizers as jax_tokenizers
from tensorflow_examples_torch import native
from tensorflow_examples_torch.data import augment, sources, tokenizers


def same(a, b):
    """Equal keys, dtypes, shapes and bytes."""
    a, b = getattr(a, "arrays", a), getattr(b, "arrays", b)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("task", sorted(sources.GLUE_NUM_LABELS))
def test_synthetic_glue_bit_identical(task):
    kw = dict(n=96, seq_len=32, vocab_size=200, seed=11)
    same(sources.synthetic_glue(task, **kw), jax_sources.synthetic_glue(task, **kw))


def test_load_glue_npz_and_synthetic_default(tmp_path):
    same(sources.load_glue("", "sst2", "validation"),
         jax_sources.load_glue("", "sst2", "validation"))
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "stsb_train.npz", tokens=rng.integers(0, 99, (6, 8)),
             attention_mask=np.ones((6, 8), np.int64), token_type_ids=np.zeros((6, 8), np.int64),
             label=rng.random(6))
    same(sources.load_glue(str(tmp_path), "stsb", "train"),
         jax_sources.load_glue(str(tmp_path), "stsb", "train"))
    with pytest.raises(FileNotFoundError, match="stsb_validation.npz"):
        sources.load_glue(str(tmp_path), "stsb", "validation")
    with pytest.raises(ValueError, match="unknown GLUE task"):
        sources.load_glue("", "squad")


def test_synthetic_images_bit_identical():
    for shape, classes in (((28, 28, 1), 10), ((32, 32, 3), 10), ((5, 4, 2), 3)):
        same(sources.synthetic_images(50, shape, classes, seed=4),
             jax_sources.synthetic_images(50, shape, classes, seed=4))


def write_idx(path, arr: np.ndarray, code: int) -> None:
    """An IDX file: a big-endian header, then the payload, which both
    readers take in the host's byte order (MNIST's payload is bytes)."""
    head = struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(head + arr.tobytes())


def test_idx_reader_and_load_mnist(tmp_path):
    rng = np.random.default_rng(1)
    for name, arr, code in (("a.idx", rng.integers(0, 256, (3, 4, 5)).astype(np.uint8), 8),
                            ("b.idx.gz", rng.standard_normal((2, 6)).astype(np.float32), 13)):
        path = str(tmp_path / name)
        write_idx(path, arr, code)
        ours, theirs = sources._read_idx(path), jax_sources._read_idx(path)
        assert ours.tobytes() == theirs.tobytes() and ours.shape == arr.shape
        np.testing.assert_array_equal(ours, arr)
    for split, prefix in (("train", "train"), ("test", "t10k")):
        write_idx(str(tmp_path / f"{prefix}-images-idx3-ubyte.gz"),
                  rng.integers(0, 256, (7, 28, 28)).astype(np.uint8), 8)
        write_idx(str(tmp_path / f"{prefix}-labels-idx1-ubyte"),
                  rng.integers(0, 10, 7).astype(np.uint8), 8)
        same(sources.load_mnist(str(tmp_path), split), jax_sources.load_mnist(str(tmp_path), split))
    with pytest.raises(FileNotFoundError, match="IDX"):
        sources.load_mnist(str(tmp_path / "nothing"))


def write_cifar(root, n=12, seed=0):
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f)


@pytest.mark.parametrize("normalized", [True, False])
def test_load_cifar10_pickle_batches(tmp_path, normalized):
    write_cifar(tmp_path)
    for split in ("train", "test"):
        ours = sources.load_cifar10(str(tmp_path), split, normalized=normalized)
        same(ours, jax_sources.load_cifar10(str(tmp_path), split, normalized=normalized))
        assert ours.arrays["image"].shape[1:] == (32, 32, 3)
        assert ours.arrays["image"].dtype == (np.float32 if normalized else np.uint8)
    with pytest.raises(FileNotFoundError, match="CIFAR-10"):
        sources.load_cifar10(str(tmp_path / "nothing"))


# ------------------------------------------------------------ augmentation


def _batch(dtype, b=9, seed=3):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        image = rng.integers(0, 256, (b, 32, 32, 3)).astype(np.uint8)
    else:
        image = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    return {"image": image, "label": rng.integers(0, 10, b).astype(np.int32)}


@pytest.mark.parametrize("path", ["float", "uint8_native", "uint8_numpy"])
def test_cifar_augment_bit_identical(path, monkeypatch):
    batch = _batch(np.float32 if path == "float" else np.uint8)
    if path == "uint8_native":
        assert native.available() and jax_native.available()
    if path == "uint8_numpy":
        monkeypatch.setattr(native, "crop_flip_normalize", lambda *a, **k: None)
        monkeypatch.setattr(jax_native, "crop_flip_normalize", lambda *a, **k: None)
    for step in range(3):
        ours = augment.cifar_augment(batch, np.random.default_rng((7, step)))
        theirs = jax_augment.cifar_augment(batch, np.random.default_rng((7, step)))
        same(ours, theirs)
        assert ours["image"].dtype == np.float32
        assert not np.array_equal(ours["image"], batch["image"])


def test_normalize_flip_and_crop_bit_identical():
    u8, f32 = _batch(np.uint8)["image"], _batch(np.float32)["image"]
    mean, std = sources.CIFAR10_MEAN, sources.CIFAR10_STD
    for x in (u8, f32):
        assert augment.normalize_images(x, mean, std).tobytes() == \
            jax_augment.normalize_images(x, mean, std).tobytes()
    assert augment.normalize_lut(mean, std).tobytes() == \
        jax_augment.normalize_lut(mean, std).tobytes()
    flips = np.arange(len(u8)) % 2 == 0
    assert augment.flip_images(u8, flips).tobytes() == jax_augment.flip_images(u8, flips).tobytes()
    assert augment.random_crop_flip(f32, np.random.default_rng(5)).tobytes() == \
        jax_augment.random_crop_flip(f32, np.random.default_rng(5)).tobytes()
    assert native.normalize(u8, mean, std).tobytes() == \
        jax_native.normalize(u8, mean, std).tobytes()


# --------------------------------------------------------------- WordPiece


CORPUS = [
    "The quick brown fox jumps over the lazy dog.",
    "A quick movie, a lazy review: unbelievable!",
    "Résumé naïve café — the dog's bone (really).",
    "日本語のテキスト and the brown dogs jumped quickly.",
    "Unbelievably quick foxes; lazier dogs... 42 times?",
]


@pytest.fixture(scope="module")
def built():
    return (tokenizers.WordPiece.build(CORPUS, 120),
            jax_tokenizers.WordPiece.build(CORPUS, 120))


def test_wordpiece_build_and_vocab_file(built, tmp_path):
    ours, theirs = built
    assert ours.vocab == theirs.vocab and ours.vocab_size == theirs.vocab_size
    ours.save(str(tmp_path / "vocab.txt"))
    again = tokenizers.WordPiece.from_vocab_file(str(tmp_path / "vocab.txt"))
    assert again.vocab == jax_tokenizers.WordPiece.from_vocab_file(
        str(tmp_path / "vocab.txt")).vocab == ours.vocab
    with pytest.raises(ValueError, match="special token"):
        tokenizers.WordPiece({"[UNK]": 0})


def test_wordpiece_tokenize_encode_decode(built):
    ours, theirs = built
    texts = CORPUS + ["ZEBRA-crossing über 東京", "", "x" * 150]
    for t in texts:
        assert tokenizers.basic_tokenize(t) == jax_tokenizers.basic_tokenize(t)
        assert ours.tokenize(t) == theirs.tokenize(t)
    for a, b in zip(texts, texts[1:] + [None]):
        for seq_len in (8, 32):
            same(ours.encode(a, b, seq_len=seq_len), theirs.encode(a, b, seq_len=seq_len))
    ids = ours.encode(CORPUS[0], CORPUS[1], seq_len=32)["tokens"]
    assert ours.decode(ids) == theirs.decode(ids)
    for ch in "a,.日 ":
        assert tokenizers._is_punctuation(ch) == jax_tokenizers._is_punctuation(ch)
        assert tokenizers._is_cjk(ord(ch)) == jax_tokenizers._is_cjk(ord(ch))
