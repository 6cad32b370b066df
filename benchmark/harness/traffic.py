"""The one traffic generator: a synthetic alignment corpus drawn from the
seed, with the lengths a mix file asks for.

The content of an utterance follows the port's synthetic corpus
(`aligner_tpu_torch/data/synthetic.py`, frozen here so that the
yardstick does not move when the program does): each token id has a
mel prototype, an utterance is its tokens' prototypes, each held for its
duration, plus noise; a pause is a stretch of the reserved prototype 0
that the transcript does not mention. What is added here are the length
distributions of a mix:

* `tokens`: {"min", "max"}: the token count, uniform, drawn first
  (`frames.per_token` then sets the frames), or, with
  `frames.frames_per_token`, worked out from the frames and held to
  [min, max];
* `frames`: the utterance's frames, pauses included, held to
  [min, max]. Either `per_token` {"min", "max"}: each token's frames,
  uniform, summed; or `dist: "truncnorm"`: a normal of `mu` and `sigma`
  drawn again until it falls in [min, max], drawn first, and
  `frames_per_token`, the frames a token;
* `pauses`: {"prob", "min", "max"}: each of the t_x + 1 gaps holds a
  pause of a uniform length with probability `prob`.

The frames of an utterance are spread over its tokens in proportion to
per-token weights drawn uniform in [1, 2), each token at least one frame.
The noise of the frames is drawn on the card where the path runs (a
torch generator seeded with the seed), in a few large calls. The sizes
(t_x and frames) and their order come from a generator seeded with the
mix's `sizes_seed`, and the train path shuffles the corpus into batches
with that seed too, so every seed gets the same batches' make-up and the
same work; the seed's numpy generator draws the pauses, the tokens and the
prototypes, so the same seed gives the same corpus on the same kind of
device.
"""
from __future__ import annotations

import numpy as np


def prototypes(rng: np.random.Generator, vocab: int,
               n_mels: int) -> np.ndarray:
    """The per-token mel prototypes [vocab, n_mels]; row 0 is silence."""
    return rng.standard_normal((vocab, n_mels), dtype=np.float32)


def _truncnorm(rng, mean, sd, lo, hi):
    while True:
        v = rng.normal(mean, sd)
        if lo <= v <= hi:
            return v


def draw_sizes(rng: np.random.Generator, mix: dict):
    """(t_x, frames) of one utterance."""
    tok, fr = mix["tokens"], mix["frames"]
    if "per_token" in fr:
        t_x = int(rng.integers(tok["min"], tok["max"] + 1))
        per = fr["per_token"]
        frames = int(rng.integers(per["min"], per["max"] + 1, t_x).sum())
    else:
        frames = int(round(_truncnorm(rng, fr["mu"], fr["sigma"], fr["min"],
                                      fr["max"])))
        t_x = int(np.clip(round(frames / fr["frames_per_token"]),
                          tok["min"], tok["max"]))
    return t_x, int(np.clip(frames, fr["min"], fr["max"]))


def draw_pauses(rng: np.random.Generator, mix: dict, t_x: int,
                frames: int) -> np.ndarray:
    """The t_x + 1 gaps' pause frames; the tokens keep one frame each."""
    pauses = np.zeros(t_x + 1, np.int64)
    p = mix.get("pauses")
    if p and p["prob"] > 0:
        hit = rng.random(t_x + 1) < p["prob"]
        pauses = np.where(hit, rng.integers(p["min"], p["max"] + 1,
                                            t_x + 1), 0)
        while pauses.sum() > frames - t_x:
            pauses[np.argmax(pauses)] -= 1
    return pauses


def spread(rng: np.random.Generator, total: int, t_x: int) -> np.ndarray:
    """`total` >= t_x frames over t_x tokens, each at least one, in
    proportion to weights uniform in [1, 2) (largest remainders take the
    frames left over)."""
    w = rng.uniform(1.0, 2.0, t_x)
    share = (total - t_x) * w / w.sum()
    d = np.floor(share).astype(np.int64)
    rest = total - t_x - int(d.sum())
    if rest:
        d[np.argsort(d - share)[:rest]] += 1
    return d + 1


NOISE_ROWS = 1 << 20     # frames a call of the noise draw


def _frames(protos: np.ndarray, labels: np.ndarray, noise: float, seed: int,
            device) -> np.ndarray:
    """protos[labels] plus Gaussian noise of deviation `noise`, drawn on
    `device`; a float32 host array [len(labels), n_mels]."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    p = torch.as_tensor(protos).to(device)
    ids = torch.as_tensor(labels).to(device)
    mel = p[ids]
    for a in range(0, len(labels), NOISE_ROWS):
        part = mel[a:a + NOISE_ROWS]
        part.add_(torch.randn(part.shape, generator=g, device=device),
                  alpha=noise)
    return mel.cpu().numpy()


def make_corpus(mix: dict, seed: int, vocab: int, n_mels: int,
                device="cpu") -> list:
    """`mix["utterances"]` dicts: tokens [t_x] int32 (ids 1..vocab-1),
    mel [frames, n_mels] float32 (views of one host array), durations
    [t_x] and pause_durations [t_x + 1] (pause j precedes token j), the
    truth they were drawn with. The frames and their noise are made on
    `device` in a few large calls (a torch generator seeded with the seed)
    and brought to the host."""
    fixed = np.random.default_rng(mix["sizes_seed"])
    sizes = [draw_sizes(fixed, mix) for _ in range(mix["utterances"])]
    rng = np.random.default_rng(seed)
    protos = prototypes(rng, vocab, n_mels)
    out, labels, counts = [], [], []
    for t_x, frames in sizes:
        pauses = draw_pauses(rng, mix, t_x, frames)
        tokens = rng.integers(1, vocab, t_x).astype(np.int32)
        durs = spread(rng, frames - int(pauses.sum()), t_x)
        # frame labels: pause j (id 0), then token j, ..., trailing pause
        ids = np.zeros(2 * t_x + 1, np.int64)
        ids[1::2] = tokens
        lens = np.zeros(2 * t_x + 1, np.int64)
        lens[1::2] = durs
        lens[0::2] = pauses
        labels.append(ids)
        counts.append(lens)
        out.append({"tokens": tokens, "durations": durs.astype(np.int32),
                    "pause_durations": pauses.astype(np.int32),
                    "frames": frames})
    mel = _frames(protos, np.repeat(np.concatenate(labels),
                                    np.concatenate(counts)),
                  float(mix.get("noise", 0.25)), seed, device)
    start = 0
    for u in out:
        frames = u.pop("frames")
        u["mel"] = mel[start:start + frames]
        start += frames
    return out


def corpus(cell, seed: int, device="cpu") -> list:
    """A cell's corpus: its mix, at its configuration's vocabulary and
    mel bins."""
    return make_corpus(cell.traffic, seed, cell.config["vocab_size"],
                       cell.config["n_mels"], device)
