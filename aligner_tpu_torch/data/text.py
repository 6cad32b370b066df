"""Minimal text front-end: character tokenizer with a stable vocabulary
(NumPy only, copied from aligner_tpu/data/text.py).

The reference delegates text processing to its (unmounted) ESPnet-based
branches; for a self-contained framework we provide a deterministic
character tokenizer sufficient for alignment training. Id 0 is reserved
for padding; unknown characters map to id 1.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

_DEFAULT_CHARS = (" abcdefghijklmnopqrstuvwxyz"
                  "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
                  ".,!?;:'\"-()")


@dataclasses.dataclass(frozen=True)
class CharTokenizer:
    chars: str = _DEFAULT_CHARS

    @property
    def pad_id(self) -> int:
        return 0

    @property
    def unk_id(self) -> int:
        return 1

    @property
    def vocab_size(self) -> int:
        return len(self.chars) + 2  # pad + unk

    def encode(self, text: str) -> np.ndarray:
        table = _char_table(self.chars)
        return np.asarray([table.get(c, self.unk_id) for c in text],
                          np.int32)

    def decode(self, ids) -> str:
        return "".join(self.chars[i - 2] if 2 <= i < self.vocab_size
                       else ("␣" if i == self.pad_id else "�")
                       for i in np.asarray(ids))

    def labels(self, text: str) -> list[str]:
        """Per-token display labels for `text` (TextGrid intervals)."""
        return list(text)


@dataclasses.dataclass(frozen=True)
class PhoneTokenizer:
    """Whitespace-separated symbol tokenizer for phone transcripts.

    Real TTS alignment corpora (the Glow-TTS/VITS ecosystem the
    reference's `maximum_path` serves, and the ESPnet pipelines of its
    unmounted branches) align *phone* sequences, not characters: each
    metadata transcript is a space-separated symbol string ("HH AH0
    L OW1"). The vocabulary is corpus-derived (`from_corpus`) and is
    persisted in the checkpoint's config.json so `align` reconstructs
    the exact id mapping. Id 0 pads, unknown symbols map to id 1.
    """
    phones: tuple[str, ...]

    @property
    def pad_id(self) -> int:
        return 0

    @property
    def unk_id(self) -> int:
        return 1

    @property
    def vocab_size(self) -> int:
        return len(self.phones) + 2  # pad + unk

    @classmethod
    def from_corpus(cls, texts) -> "PhoneTokenizer":
        """Build the vocabulary from an iterable of transcripts
        (sorted unique symbols — deterministic for a given corpus)."""
        vocab = set()
        for t in texts:
            vocab.update(t.split())
        return cls(phones=tuple(sorted(vocab)))

    def encode(self, text: str) -> np.ndarray:
        table = _phone_table(self.phones)
        return np.asarray([table.get(p, self.unk_id)
                           for p in text.split()], np.int32)

    def decode(self, ids) -> str:
        return " ".join(self.phones[i - 2] if 2 <= i < self.vocab_size
                        else ("␣" if i == self.pad_id else "�")
                        for i in np.asarray(ids))

    def labels(self, text: str) -> list[str]:
        return text.split()


@functools.lru_cache(maxsize=8)
def _char_table(chars: str) -> dict:
    return {c: i + 2 for i, c in enumerate(chars)}


@functools.lru_cache(maxsize=8)
def _phone_table(phones: tuple) -> dict:
    return {p: i + 2 for i, p in enumerate(phones)}
