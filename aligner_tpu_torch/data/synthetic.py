"""Synthetic alignment corpus with known ground-truth durations (NumPy
only, copied from aligner_tpu/data/synthetic.py: the same seed gives the
same corpus in both packages).

Each token id has a characteristic mel "prototype"; an utterance is the
concatenation of its tokens' prototypes, each repeated for a random
duration, plus noise. Because true durations are known, alignment quality
(duration accuracy) is directly measurable — this is the corpus used by
the framework's own verification runs and the demo CLI. The reference
project has no data layer at all (SURVEY.md §0).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int = 64
    n_mels: int = 80
    min_tokens: int = 8
    max_tokens: int = 32
    min_duration: int = 2
    max_duration: int = 8
    noise: float = 0.25
    seed: int = 0
    # Implicit pauses: with probability `pause_prob` per token gap
    # (including the utterance edges), insert a silence segment of
    # [min_pause, max_pause] frames whose spectral prototype is the
    # reserved row 0 (token ids start at 1). The *transcript* carries no
    # silence tokens — recovering these segments is exactly the
    # reference OTA branch's implicit-pause problem (README.md:21-25).
    pause_prob: float = 0.0
    min_pause: int = 2
    max_pause: int = 6
    # --- "hard corpus" knobs -------------------------------------------
    # The default corpus is nearly separable by nearest-prototype; these
    # knobs move it toward the coarticulated / speaker-varied regime of
    # real TTS corpora (ESPnet/LJSpeech-style data).
    # Temporal coarticulation: each frame is smeared with its neighbours
    # by a [c/2, 1-c, c/2] kernel along time, so boundary frames are
    # mixtures of adjacent tokens' prototypes. 0 = off.
    coarticulation: float = 0.0
    # Prototype overlap: tokens are grouped (vocab // 4 groups) and each
    # prototype mixes sqrt(1-o) of its own direction with sqrt(o) of its
    # group's shared component — confusable token families. 0 = off.
    proto_overlap: float = 0.0
    # Per-utterance speaker variation: a multiplicative gain
    # exp(N(0, g)) and an additive channel offset N(0, g) per mel bin.
    gain_var: float = 0.0


def prototypes(cfg: SyntheticConfig = SyntheticConfig()) -> np.ndarray:
    """The per-token mel prototypes [vocab, n_mels] for a config — the
    same array make_corpus uses (deterministic in cfg.seed). With
    proto_overlap > 0, groups of ~4 tokens share sqrt(o) of a common
    component (cosine similarity ~o within a group)."""
    rng = np.random.default_rng(cfg.seed)
    protos = rng.standard_normal((cfg.vocab_size, cfg.n_mels)) \
        .astype(np.float32)
    if cfg.proto_overlap > 0:
        n_groups = max(cfg.vocab_size // 4, 1)
        # separate stream: the base-prototype/utterance draws stay
        # identical across overlap settings (clean A/B corpora)
        basis = np.random.default_rng([cfg.seed, 7]) \
            .standard_normal((n_groups, cfg.n_mels)).astype(np.float32)
        groups = np.arange(cfg.vocab_size) % n_groups
        o = cfg.proto_overlap
        protos = (np.sqrt(1.0 - o) * protos
                  + np.sqrt(o) * basis[groups]).astype(np.float32)
    return protos


def make_corpus(n_utterances: int, cfg: SyntheticConfig = SyntheticConfig()):
    """Returns a list of dicts: tokens [t_x], mel [t_y, n_mels],
    durations [t_x] (ground truth)."""
    rng = np.random.default_rng(cfg.seed)
    protos = prototypes(cfg)
    # advance the stream past the prototype draw (prototypes() re-derives
    # the same array from a fresh generator with the same seed)
    rng.standard_normal((cfg.vocab_size, cfg.n_mels))
    # separate stream for speaker gain/offset: the token/duration/noise
    # draws stay identical across gain settings (clean A/B corpora)
    rng_gain = np.random.default_rng([cfg.seed, 11])
    out = []
    for _ in range(n_utterances):
        t_x = int(rng.integers(cfg.min_tokens, cfg.max_tokens + 1))
        tokens = rng.integers(1, cfg.vocab_size, t_x).astype(np.int32)
        durs = rng.integers(cfg.min_duration, cfg.max_duration + 1, t_x)
        pauses = np.zeros(t_x + 1, np.int32)
        if cfg.pause_prob > 0:
            hit = rng.random(t_x + 1) < cfg.pause_prob
            pauses = np.where(
                hit, rng.integers(cfg.min_pause, cfg.max_pause + 1,
                                  t_x + 1), 0).astype(np.int32)
        segs = []
        for j, (tok, d) in enumerate(zip(tokens, durs)):
            if pauses[j]:
                segs.append(np.repeat(protos[0][None, :], pauses[j],
                                      axis=0))
            segs.append(np.repeat(protos[tok][None, :], d, axis=0))
        if pauses[t_x]:
            segs.append(np.repeat(protos[0][None, :], pauses[t_x],
                                  axis=0))
        mel = np.concatenate(segs, axis=0)
        if cfg.coarticulation > 0:
            # temporal smear BEFORE noise: boundary frames become
            # mixtures of the adjacent tokens' prototypes
            c = cfg.coarticulation
            prev = np.vstack([mel[:1], mel[:-1]])
            nxt = np.vstack([mel[1:], mel[-1:]])
            mel = (1.0 - c) * mel + 0.5 * c * (prev + nxt)
        mel = mel + cfg.noise * rng.standard_normal(mel.shape) \
            .astype(np.float32)
        if cfg.gain_var > 0:
            gain = float(np.exp(cfg.gain_var * rng_gain.standard_normal()))
            offset = (cfg.gain_var * rng_gain.standard_normal(cfg.n_mels)
                      ).astype(np.float32)
            mel = gain * mel + offset[None, :]
        item = {"tokens": tokens, "mel": mel.astype(np.float32),
                "durations": durs.astype(np.int32),
                # all-zero when pause_prob == 0, so pause-aware consumers
                # (demo-pauses, eval) work on pause-free corpora too
                "pause_durations": pauses}
        out.append(item)
    return out


def duration_accuracy(predicted, item) -> dict:
    """Exact-match rate and MAE of predicted durations vs ground truth."""
    t_x = len(item["tokens"])
    p = np.asarray(predicted)[:t_x]
    g = item["durations"][:t_x]
    return {"exact": float((p == g).mean()),
            "mae": float(np.abs(p - g).mean())}
