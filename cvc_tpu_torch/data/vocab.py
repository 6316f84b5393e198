"""Vocabulary: word<->id mapping, tokenization, encoding and
decode_sequence (the port's own copy of `cvc_tpu/data/vocab.py`; same ids,
same file format, same encoded buffers).

Fixed special ids:
  PAD=0  (also the filler after EOS)
  BOS=1  (decoder start symbol)
  EOS=2  (end of caption)
  UNK=3
"""

from __future__ import annotations

import json
import re
from collections import Counter
from typing import Iterable, Sequence

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
UNK_ID = 3
SPECIALS = ["<pad>", "<bos>", "<eos>", "<unk>"]

_WORD_RE = re.compile(r"[a-z0-9']+")


def simple_tokenize(text: str) -> list[str]:
    """Lowercase word tokenizer of vocabulary building and encoding:
    punctuation is dropped."""
    return _WORD_RE.findall(text.lower())


class Vocabulary:
    def __init__(self, words: Sequence[str]):
        """`words` excludes specials; specials get fixed low ids."""
        self.itow: list[str] = list(SPECIALS) + list(words)
        self.wtoi: dict[str, int] = {w: i for i, w in enumerate(self.itow)}
        if self.wtoi["<pad>"] != PAD_ID or self.wtoi["<bos>"] != BOS_ID:
            raise ValueError("special tokens must keep their fixed ids")

    def __len__(self) -> int:
        return len(self.itow)

    def padded_size(self, multiple: int = 128) -> int:
        """Vocab size rounded up to a multiple (the head's padded width)."""
        n = len(self.itow)
        return ((n + multiple - 1) // multiple) * multiple

    @staticmethod
    def build(captions: Iterable[str], min_count: int = 5) -> "Vocabulary":
        """The words seen at least min_count times, sorted."""
        counts: Counter = Counter()
        for c in captions:
            counts.update(simple_tokenize(c))
        words = sorted(w for w, n in counts.items() if n >= min_count)
        return Vocabulary(words)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"itow": self.itow}, f)

    @staticmethod
    def load(path: str) -> "Vocabulary":
        with open(path) as f:
            raw = json.load(f)
        if "itow" in raw:
            itow = raw["itow"]
            if itow[:4] == SPECIALS:
                return Vocabulary(itow[4:])
            return Vocabulary([w for w in itow if w not in SPECIALS])
        # reference-style {id(str): word} dicts, 1-indexed
        items = sorted((int(k), v) for k, v in raw.items())
        return Vocabulary([v for _, v in items if v not in SPECIALS])

    def encode(self, text: str, seq_length: int) -> tuple[np.ndarray, int]:
        """Caption -> fixed-length ids [BOS, w1..wk, EOS, PAD...] of length
        seq_length + 2, and k + 1: the count of supervised tokens (the
        words and EOS)."""
        words = simple_tokenize(text)[:seq_length]
        ids = [self.wtoi.get(w, UNK_ID) for w in words]
        buf = np.full((seq_length + 2,), PAD_ID, dtype=np.int32)
        buf[0] = BOS_ID
        buf[1:1 + len(ids)] = ids
        buf[1 + len(ids)] = EOS_ID
        return buf, len(ids) + 1

    def decode_sequence(self, ids: np.ndarray) -> list[str]:
        """Id matrix [B, L] -> sentences, stopping at EOS/PAD."""
        return self.decode_sequence_with_pos(ids)[0]

    def decode_sequence_with_pos(self, ids: np.ndarray
                                 ) -> tuple[list[str], list[list[int]]]:
        """Like decode_sequence, plus each emitted word's timestep index."""
        sents, positions = [], []
        for row in np.asarray(ids):
            words, pos = [], []
            for j, t in enumerate(row):
                t = int(t)
                if t in (EOS_ID, PAD_ID):
                    break
                if t == BOS_ID:
                    continue
                words.append(self.itow[t] if 0 <= t < len(self.itow) else "<unk>")
                pos.append(j)
            sents.append(" ".join(words))
            positions.append(pos)
        return sents, positions
