"""GPT-2 byte-level BPE and BERT WordPiece, pure Python: the port of
``tensorflow_examples_tpu/data/tokenizers.py``.

:class:`ByteLevelBPE` reads and writes the standard ``vocab.json`` +
``merges.txt`` pair (byte-compatible with the published GPT-2 files),
encodes and decodes any text losslessly, and trains a vocabulary from a
local corpus (:meth:`ByteLevelBPE.train`), merge for merge the
reference's. :class:`ByteTokenizer` is the text path of byte
vocabularies (``vocab_size <= 256``), and :func:`load_tokenizer` picks
between them as the serving and sampling CLIs do. :class:`WordPiece`
reads the published one-token-a-line ``vocab.txt``, builds a vocabulary
from a local corpus, and encodes a sentence or a pair into the GLUE
features ``data/sources.load_glue`` reads (``[CLS] a [SEP] (b [SEP])``,
truncated longest-first, padded with ``[PAD]``).
"""

from __future__ import annotations

import collections
import json
import os
import unicodedata

import numpy as np

# GPT-2's pre-tokenizer: contractions, letter runs, number runs, other
# symbols and whitespace. The canonical pattern needs `regex` for \p{L}
# and \p{N}; without it, the stdlib fallback uses [^\W\d_] and \d, the
# reference's own fallback, equivalent on common text.
try:
    import regex

    _GPT2_SPLIT = regex.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
    )
except ImportError:
    import re

    # "_" is \w but not a letter under [^\W\d_]: the symbol class names it
    # explicitly, or findall() would drop underscores.
    _GPT2_SPLIT = re.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+",
        re.UNICODE,
    )

END_OF_TEXT = "<|endoftext|>"


def bytes_to_unicode() -> dict[int, str]:
    """Reversible map from the 256 byte values to printable characters:
    printable bytes map to themselves, the rest into the U+0100 range."""
    printable = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
                 + list(range(ord("®"), ord("ÿ") + 1)))
    chars = printable[:]
    n = 0
    for b in range(256):
        if b not in printable:
            printable.append(b)
            chars.append(256 + n)
            n += 1
    return dict(zip(printable, map(chr, chars)))


_BYTE_ENCODER = bytes_to_unicode()
_BYTE_DECODER = {c: b for b, c in _BYTE_ENCODER.items()}


def _word_to_symbols(word_bytes: bytes) -> tuple[str, ...]:
    return tuple(_BYTE_ENCODER[b] for b in word_bytes)


def _merge_pair(symbols: tuple[str, ...], a: str, b: str) -> tuple[str, ...]:
    out, i = [], 0
    while i < len(symbols):
        if i < len(symbols) - 1 and symbols[i] == a and symbols[i + 1] == b:
            out.append(a + b)
            i += 2
        else:
            out.append(symbols[i])
            i += 1
    return tuple(out)


class ByteLevelBPE:
    """GPT-2-style byte-level BPE. ``encoder`` maps merged byte-symbol
    strings to ids; ``merges`` is the ordered merge list (rank =
    priority). ``<|endoftext|>``, when in the vocabulary, is never
    produced by :meth:`encode` and is dropped by :meth:`decode`."""

    def __init__(self, encoder: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = dict(encoder)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.merges = list(merges)
        self._cache: dict[str, list[str]] = {}

    # ------------------------------------------------------------ files

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str) -> "ByteLevelBPE":
        with open(vocab_json, encoding="utf-8") as f:
            encoder = json.load(f)
        merges = []
        with open(merges_txt, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(encoder, merges)

    @classmethod
    def from_dir(cls, vocab_dir: str) -> "ByteLevelBPE":
        return cls.from_files(os.path.join(vocab_dir, "vocab.json"),
                              os.path.join(vocab_dir, "merges.txt"))

    def save(self, vocab_dir: str) -> None:
        os.makedirs(vocab_dir, exist_ok=True)
        with open(os.path.join(vocab_dir, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(self.encoder, f, ensure_ascii=False)
        with open(os.path.join(vocab_dir, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for a, b in self.merges:
                f.write(f"{a} {b}\n")

    # ---------------------------------------------------------- encode

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def eot_id(self) -> int | None:
        return self.encoder.get(END_OF_TEXT)

    def _bpe(self, piece: str) -> list[str]:
        if piece in self._cache:
            return self._cache[piece]
        symbols = _word_to_symbols(piece.encode("utf-8"))
        while len(symbols) > 1:
            best = min(set(zip(symbols, symbols[1:])),
                       key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            symbols = _merge_pair(symbols, *best)
        result = list(symbols)
        if len(self._cache) < 65536:
            self._cache[piece] = result
        return result

    def encode(self, text: str) -> list[int]:
        return [self.encoder[sym] for piece in _GPT2_SPLIT.findall(text)
                for sym in self._bpe(piece)]

    def decode(self, ids) -> str:
        data = bytearray()
        for i in ids:
            sym = self.decoder.get(int(i))
            if sym is None or sym == END_OF_TEXT:
                continue
            data.extend(_BYTE_DECODER[c] for c in sym)
        return data.decode("utf-8", errors="replace")

    # ----------------------------------------------------------- train

    @classmethod
    def train(cls, texts, vocab_size: int, *, special_tokens=(END_OF_TEXT,)) -> "ByteLevelBPE":
        """Start from the 256 byte symbols and merge the most frequent
        adjacent pair across the pre-tokenized corpus (first seen wins a
        tie, as ``Counter.most_common`` orders) until ``vocab_size`` less
        the specials, or no pair occurs twice."""
        word_freq: collections.Counter = collections.Counter()
        for text in texts:
            for piece in _GPT2_SPLIT.findall(text):
                word_freq[piece] += 1
        words = {w: _word_to_symbols(w.encode("utf-8")) for w in word_freq}
        base = [_BYTE_ENCODER[b] for b in range(256)]
        merges: list[tuple[str, str]] = []
        for _ in range(max(0, vocab_size - len(base) - len(special_tokens))):
            pair_freq: collections.Counter = collections.Counter()
            for w, symbols in words.items():
                f = word_freq[w]
                for pair in zip(symbols, symbols[1:]):
                    pair_freq[pair] += f
            if not pair_freq:
                break
            (a, b), freq = pair_freq.most_common(1)[0]
            if freq < 2:
                break
            merges.append((a, b))
            words = {w: _merge_pair(symbols, a, b) for w, symbols in words.items()}
        encoder = {sym: i for i, sym in enumerate(base)}
        for a, b in merges:
            encoder[a + b] = len(encoder)
        for tok in special_tokens:
            encoder[tok] = len(encoder)
        return cls(encoder, merges)


class ByteTokenizer:
    """Text as its UTF-8 bytes: the tokenizer of a byte vocabulary
    (``vocab_size <= 256``)."""

    def encode(self, text: str) -> list[int]:
        return list(text.encode())

    def decode(self, tokens) -> str:
        return bytes(min(max(int(t), 0), 255) for t in tokens).decode(errors="replace")


def load_tokenizer(vocab_size: int, *dirs: str):
    """The BPE of the first of ``dirs`` that holds a ``vocab.json``; else
    :class:`ByteTokenizer` for a byte vocabulary; else None (the client
    sends token ids)."""
    for d in dirs:
        if d and os.path.exists(os.path.join(d, "vocab.json")):
            return ByteLevelBPE.from_dir(d)
    return ByteTokenizer() if vocab_size <= 256 else None


# ------------------------------------------------------------- WordPiece


BERT_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0xF900 <= cp <= 0xFAFF
        or 0x20000 <= cp <= 0x2FA1F
    )


def basic_tokenize(text: str, *, lowercase: bool = True) -> list[str]:
    """BERT's BasicTokenizer: clean, lowercase + strip accents, split on
    whitespace/punctuation, and isolate CJK characters."""
    out_chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
            continue
        if _is_cjk(cp):
            out_chars.append(f" {ch} ")
        elif ch.isspace():
            out_chars.append(" ")
        else:
            out_chars.append(ch)
    tokens = []
    for word in "".join(out_chars).split():
        if lowercase:
            word = word.lower()
            word = "".join(
                c
                for c in unicodedata.normalize("NFD", word)
                if unicodedata.category(c) != "Mn"
            )
        current = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    tokens.append("".join(current))
                    current = []
                tokens.append(ch)
            else:
                current.append(ch)
        if current:
            tokens.append("".join(current))
    return tokens


class WordPiece:
    """BERT WordPiece: greedy longest-match-first with ``##`` continuations.

    Loads the standard one-token-per-line ``vocab.txt`` (line number = id,
    the published BERT format) and produces the exact feature schema the
    GLUE loader consumes (data/sources.py:load_glue): ``tokens``,
    ``attention_mask``, ``token_type_ids`` with [CLS]/[SEP]/[PAD].
    """

    def __init__(
        self,
        vocab: dict[str, int],
        *,
        lowercase: bool = True,
        max_chars_per_word: int = 100,
    ):
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        for tok in ("[UNK]", "[CLS]", "[SEP]", "[PAD]"):
            if tok not in self.vocab:
                raise ValueError(f"WordPiece vocab missing special token {tok}")

    @classmethod
    def from_vocab_file(cls, path: str, *, lowercase: bool = True) -> "WordPiece":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, lowercase=lowercase)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for tok, _ in sorted(self.vocab.items(), key=lambda kv: kv[1]):
                f.write(tok + "\n")

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> list[str]:
        pieces = []
        for word in basic_tokenize(text, lowercase=self.lowercase):
            if len(word) > self.max_chars_per_word:
                pieces.append("[UNK]")
                continue
            start, word_pieces, bad = 0, [], False
            while start < len(word):
                end = len(word)
                cur = None
                while start < end:
                    sub = word[start:end]
                    if start > 0:
                        sub = "##" + sub
                    if sub in self.vocab:
                        cur = sub
                        break
                    end -= 1
                if cur is None:
                    bad = True
                    break
                word_pieces.append(cur)
                start = end
            pieces.extend(["[UNK]"] if bad else word_pieces)
        return pieces

    def encode(
        self, text_a: str, text_b: str | None = None, *, seq_len: int = 128
    ) -> dict:
        """[CLS] a [SEP] (b [SEP])? → fixed-length id/mask/type arrays."""
        a = self.tokenize(text_a)
        b = self.tokenize(text_b) if text_b is not None else []
        # Truncate longest-first to fit [CLS] + a + [SEP] (+ b + [SEP]).
        budget = seq_len - 2 - (1 if b else 0)
        while len(a) + len(b) > budget:
            (a if len(a) >= len(b) else b).pop()
        toks = ["[CLS]"] + a + ["[SEP]"]
        types = [0] * len(toks)
        if b:
            toks += b + ["[SEP]"]
            types += [1] * (len(b) + 1)
        ids = [self.vocab[t] for t in toks]
        n = len(ids)
        pad = self.vocab["[PAD]"]
        return {
            "tokens": np.asarray(ids + [pad] * (seq_len - n), np.int32),
            "attention_mask": np.asarray([1] * n + [0] * (seq_len - n), np.int32),
            "token_type_ids": np.asarray(types + [0] * (seq_len - n), np.int32),
        }

    def decode(self, ids) -> str:
        words = []
        for i in ids:
            tok = self.inv_vocab.get(int(i), "[UNK]")
            if tok in BERT_SPECIALS:
                continue
            if tok.startswith("##") and words:
                words[-1] += tok[2:]
            else:
                words.append(tok)
        return " ".join(words)

    # ----------------------------------------------------------- build

    @classmethod
    def build(
        cls, texts, vocab_size: int, *, lowercase: bool = True
    ) -> "WordPiece":
        """Build a WordPiece vocab from a corpus: specials + all seen
        characters (+ ## forms), then BPE-style merges expressed as
        subword units until ``vocab_size``."""
        word_freq: collections.Counter = collections.Counter()
        for text in texts:
            for w in basic_tokenize(text, lowercase=lowercase):
                word_freq[w] += 1

        # Represent each word as char pieces: first char bare, rest ##'d.
        words = {
            w: tuple([w[0]] + ["##" + c for c in w[1:]]) for w in word_freq
        }
        vocab_set = set(BERT_SPECIALS)
        for pieces in words.values():
            vocab_set.update(pieces)

        def strip(p):  # char content of a piece
            return p[2:] if p.startswith("##") else p

        while len(vocab_set) < vocab_size:
            pair_freq: collections.Counter = collections.Counter()
            for w, pieces in words.items():
                f = word_freq[w]
                for pair in zip(pieces, pieces[1:]):
                    pair_freq[pair] += f
            if not pair_freq:
                break
            (a, b), freq = pair_freq.most_common(1)[0]
            if freq < 2:
                break
            merged = a + strip(b)
            vocab_set.add(merged)
            new_words = {}
            for w, pieces in words.items():
                out, i = [], 0
                while i < len(pieces):
                    if i < len(pieces) - 1 and pieces[i] == a and pieces[i + 1] == b:
                        out.append(merged)
                        i += 2
                    else:
                        out.append(pieces[i])
                        i += 1
                new_words[w] = tuple(out)
            words = new_words

        vocab = {}
        for tok in BERT_SPECIALS:
            vocab[tok] = len(vocab)
        for tok in sorted(vocab_set - set(BERT_SPECIALS)):
            vocab[tok] = len(vocab)
        return cls(vocab, lowercase=lowercase)
