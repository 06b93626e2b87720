"""The port's byte-level BPE against the JAX package's (PyTorch/CUDA
port): training on a local corpus this test writes gives the same
vocabulary and merges in both packages, the files round-trip, and
encode/decode give the same ids and text. Nothing is downloaded."""

import os

import pytest

from tensorflow_examples_tpu.data import tokenizers as jax_tokenizers
from tensorflow_examples_torch.data import tokenizers

CORPUS = [
    "the quick brown fox jumps over the lazy dog. " * 3,
    "It's 2026; naïve café-owners don't re-use 1,234 snake_case names!\n\n  tabs\tand\r\n",
    "Ünïcödé → 漢字 and emoji 🙂🙂 mix with ASCII; the the the quick quick.",
]


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    with open(d / "train.txt", "w", encoding="utf-8") as f:
        f.write("\n".join(CORPUS * 4))
    return d


def _texts(corpus_dir):
    with open(corpus_dir / "train.txt", encoding="utf-8") as f:
        return f.read().split("\n\n")


@pytest.mark.parametrize("vocab_size", [256 + 1, 300, 400])
def test_train_gives_the_reference_vocabulary_and_ids(corpus_dir, tmp_path, vocab_size):
    texts = _texts(corpus_dir)
    ours = tokenizers.ByteLevelBPE.train(texts, vocab_size)
    theirs = jax_tokenizers.ByteLevelBPE.train(texts, vocab_size)
    assert ours.encoder == theirs.encoder and ours.merges == theirs.merges
    assert ours.vocab_size == theirs.vocab_size and ours.eot_id == theirs.eot_id
    ours.save(str(tmp_path / "ours"))
    theirs.save(str(tmp_path / "theirs"))
    for name in ("vocab.json", "merges.txt"):
        with open(tmp_path / "ours" / name, "rb") as a, open(tmp_path / "theirs" / name, "rb") as b:
            assert a.read() == b.read()
    loaded = tokenizers.ByteLevelBPE.from_dir(str(tmp_path / "theirs"))
    probe = CORPUS + ["unseen words: zebra_quartz 987654 ‼", ""]
    for text in probe:
        ids = loaded.encode(text)
        assert ids == theirs.encode(text) == ours.encode(text)
        assert loaded.decode(ids) == theirs.decode(ids) == text
    assert loaded.decode([ours.eot_id, *ours.encode("ab")]) == "ab"


def test_byte_tokenizer_and_the_loader(corpus_dir, tmp_path):
    byte = tokenizers.ByteTokenizer()
    assert byte.encode("hé") == list("hé".encode())
    assert byte.decode([104, 300, -1]) == "h\ufffd\x00"
    assert tokenizers.bytes_to_unicode() == jax_tokenizers.bytes_to_unicode()
    assert isinstance(tokenizers.load_tokenizer(256, "", str(corpus_dir)),
                      tokenizers.ByteTokenizer)
    assert tokenizers.load_tokenizer(50257, "") is None
    tokenizers.ByteLevelBPE.train(_texts(corpus_dir), 300).save(str(tmp_path))
    assert os.path.exists(tmp_path / "merges.txt")
    loaded = tokenizers.load_tokenizer(256, str(tmp_path), str(corpus_dir))
    assert isinstance(loaded, tokenizers.ByteLevelBPE) and loaded.vocab_size == 300
