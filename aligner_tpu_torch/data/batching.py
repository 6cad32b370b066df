"""Ragged-batch utilities: bucketing + padding to static shapes.

NumPy only, copied from aligner_tpu/data/batching.py so that both
packages batch a corpus identically. Ragged (text, mel) pairs are padded
to a small set of bucket shapes (SURVEY.md §7.2: "pad-to-bucket shapes +
masks"); a handful of buckets keeps padding waste low and the kernels'
shapes few.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Sequence

import numpy as np


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static bucket shapes. Defaults cover LJSpeech-like stats."""
    text_buckets: Sequence[int] = (32, 64, 96, 128)
    mel_buckets: Sequence[int] = (256, 512, 768, 1024, 1536, 2048)

    def bucket_for(self, t_x: int, t_y: int) -> tuple[int, int]:
        bx = next((b for b in self.text_buckets if t_x <= b),
                  round_up(t_x, 8))
        by = next((b for b in self.mel_buckets if t_y <= b),
                  round_up(t_y, 8))
        return bx, by


def pad_batch(items: Iterable[dict], spec: BucketSpec | None = None):
    """items: dicts with 'tokens' [t_x] int, 'mel' [t_y, n_mels] float.

    Returns one padded batch dict (tokens, mel, text_lengths, mel_lengths)
    sized to the smallest bucket that fits every item.
    """
    items = list(items)
    spec = spec or BucketSpec()
    t_x = max(len(it["tokens"]) for it in items)
    t_y = max(it["mel"].shape[0] for it in items)
    bx, by = spec.bucket_for(t_x, t_y)
    n_mels = items[0]["mel"].shape[1]
    B = len(items)

    tokens = np.zeros((B, bx), np.int32)
    mel = np.zeros((B, by, n_mels), np.float32)
    t_xs = np.zeros((B,), np.int32)
    t_ys = np.zeros((B,), np.int32)
    for i, it in enumerate(items):
        tk = np.asarray(it["tokens"], np.int32)
        ml = np.asarray(it["mel"], np.float32)
        tokens[i, :len(tk)] = tk
        mel[i, :ml.shape[0]] = ml
        t_xs[i] = len(tk)
        t_ys[i] = ml.shape[0]
    return {"tokens": tokens, "mel": mel, "text_lengths": t_xs,
            "mel_lengths": t_ys}


def bucket_batches(dataset: Iterable[dict], batch_size: int,
                   spec: BucketSpec | None = None, shuffle_seed=None,
                   with_items: bool = False):
    """Group items into batches of same-bucket items (minimal padding).

    Yields padded batch dicts (row i of a batch corresponds to the i-th
    item of its group; pass with_items=True to also get that group, e.g.
    to keep utterance ids attached). Items are assigned to (text, mel)
    buckets; a batch is emitted whenever a bucket fills. Leftovers flush
    at the end.
    """
    spec = spec or BucketSpec()
    items = list(dataset)
    if shuffle_seed is not None:
        rng = np.random.default_rng(shuffle_seed)
        rng.shuffle(items)
    pending: dict[tuple[int, int], list] = {}

    def emit(group):
        batch = pad_batch(group, spec)
        return (batch, group) if with_items else batch

    for it in items:
        key = spec.bucket_for(len(it["tokens"]), it["mel"].shape[0])
        pending.setdefault(key, []).append(it)
        if len(pending[key]) == batch_size:
            yield emit(pending.pop(key))
    for group in pending.values():
        yield emit(group)
