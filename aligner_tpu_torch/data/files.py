"""File-based corpus loader: LJSpeech-style metadata + wav directory (port
of aligner_tpu/data/files.py).

Layout expected:

    root/
      metadata.csv        # utt_id|transcript   (pipe-separated)
      wavs/<utt_id>.wav   # 16-bit PCM or float wav

Wavs are read with scipy, normalised to float32 in [-1, 1], resampled
linearly where their rate is not the mel config's, turned into a log-mel
on `device` (`ops/mel.py`) and tokenised. Items stream lazily; use
`bucket_batches` to form static-shape batches.
"""
from __future__ import annotations

import os
from collections.abc import Iterator

import numpy as np
import torch

from ..ops.mel import MelConfig, log_mel_spectrogram
from .text import CharTokenizer


def read_wav(path: str) -> tuple[int, np.ndarray]:
    """Returns (sample_rate, float32 mono waveform in [-1, 1])."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    return sr, wav


def load_metadata(root: str, filename: str = "metadata.csv"):
    """Yields (utt_id, transcript) pairs."""
    with open(os.path.join(root, filename), encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            parts = line.split("|")
            yield parts[0], parts[-1]


def load_corpus(root: str, *, mel_config: MelConfig = MelConfig(),
                tokenizer=CharTokenizer(),
                wav_dir: str = "wavs", limit: int | None = None,
                device="cuda") -> Iterator[dict]:
    """Yields alignment items: tokens [t_x] int32, mel [t_y, n_mels]
    float32 numpy (computed on `device`), utt_id, text. A row whose wav is
    missing is skipped; `limit` counts the items yielded."""
    device = torch.device(device)
    n = 0
    for utt_id, text in load_metadata(root):
        if limit is not None and n >= limit:
            return
        path = os.path.join(root, wav_dir, f"{utt_id}.wav")
        if not os.path.exists(path):
            continue
        sr, wav = read_wav(path)
        if sr != mel_config.sample_rate:
            # zero-dependency linear resample
            t_new = np.linspace(0.0, len(wav) - 1,
                                int(round(len(wav) * mel_config.sample_rate
                                          / sr)))
            wav = np.interp(t_new, np.arange(len(wav)), wav) \
                .astype(np.float32)
        tokens = tokenizer.encode(text)
        if len(tokens) == 0:
            # A whitespace-only transcript tokenises to t_x=0 (easy to
            # hit with PhoneTokenizer on a malformed phone corpus) and
            # would flow into the model as a degenerate lattice; fail
            # loudly at load time instead.
            raise ValueError(
                f"utterance {utt_id!r}: transcript {text!r} tokenises "
                "to zero tokens — fix or drop the metadata row")
        wav_t = torch.from_numpy(np.ascontiguousarray(wav, np.float32))
        mel = log_mel_spectrogram(wav_t[None].to(device), mel_config)[0]
        yield {"utt_id": utt_id, "text": text,
               "tokens": tokens, "mel": mel.cpu().numpy()}
        n += 1
