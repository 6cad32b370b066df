"""Bucketing and padding of a corpus into batches, as the `train` and
`align` commands batch it: items go to the smallest (text, mel) bucket
that holds them, a batch is emitted whenever a bucket fills, and the
part-filled buckets follow at the end in the order they were opened.
A frozen copy, so that the reference batches the corpus itself."""
from __future__ import annotations

import numpy as np

TEXT_BUCKETS = (32, 64, 96, 128)
MEL_BUCKETS = (256, 512, 768, 1024, 1536, 2048)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def bucket_for(t_x: int, t_y: int, text=TEXT_BUCKETS, mel=MEL_BUCKETS):
    bx = next((b for b in text if t_x <= b), _round_up(t_x, 8))
    by = next((b for b in mel if t_y <= b), _round_up(t_y, 8))
    return bx, by


def pad(items: list, text=TEXT_BUCKETS, mel=MEL_BUCKETS) -> dict:
    bx, by = bucket_for(max(len(it["tokens"]) for it in items),
                        max(it["mel"].shape[0] for it in items), text, mel)
    B, n_mels = len(items), items[0]["mel"].shape[1]
    out = {"tokens": np.zeros((B, bx), np.int32),
           "mel": np.zeros((B, by, n_mels), np.float32),
           "text_lengths": np.zeros(B, np.int32),
           "mel_lengths": np.zeros(B, np.int32)}
    for i, it in enumerate(items):
        tx, ty = len(it["tokens"]), it["mel"].shape[0]
        out["tokens"][i, :tx] = it["tokens"]
        out["mel"][i, :ty] = it["mel"]
        out["text_lengths"][i], out["mel_lengths"][i] = tx, ty
    return out


def batches(items: list, batch_size: int, shuffle_seed=None,
            text=TEXT_BUCKETS, mel=MEL_BUCKETS) -> list:
    items = list(items)
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(items)
    pending: dict = {}
    out = []
    for it in items:
        key = bucket_for(len(it["tokens"]), it["mel"].shape[0], text, mel)
        pending.setdefault(key, []).append(it)
        if len(pending[key]) == batch_size:
            out.append(pad(pending.pop(key), text, mel))
    out += [pad(group, text, mel) for group in pending.values()]
    return out
