"""Mel-spectrogram extraction (port of aligner_tpu/ops/mel.py).

wav [B, T] -> log-mel [B, n_frames, n_mels] with plain torch ops on the
wav's device: the reflect padding of a centred STFT, `torch.stft` (cuFFT on
a CUDA tensor, pocketfft on the CPU) with a periodic Hann window of
`win_length` centred in `n_fft`, the power (or magnitude) spectrum, the mel
projection and a floored natural log.

The spectrum and the mel projection are computed in float64 and returned
as float32. In float32 an FFT's rounding, about 1e-7 of a frame's energy,
reaches 1e-4 to 3e-4 on the log of a near-silent bin (a bin just above
the 1e-5 floor), and cuFFT and pocketfft round differently; in float64
the card's log-mel and the CPU's agree to the final float32 rounding. The
JAX package computes the STFT in float32, as a matmul against a windowed
DFT basis: the two agree to its rounding (about 1e-5 on the log-mel of a
broadband signal), not bit for bit.

`MelConfig`, `mel_filterbank` and the Hz/mel conversions are NumPy, copied
as they are. Defaults match the LJSpeech-style TTS stack (22.05 kHz, n_fft
1024, hop 256, 80 mels, Slaney mel scale and normalisation, natural log
with a 1e-5 floor).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = 8000.0
    center: bool = True
    power: float = 2.0          # 2.0 = power spectrogram, 1.0 = magnitude
    log_floor: float = 1e-5
    htk: bool = False           # False = Slaney scale (librosa default)


def _hz_to_mel(f, htk: bool):
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above.
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3.0)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3.0)
    logstep = math.log(6.4) / 27.0
    f_safe = np.maximum(f, 1e-10)  # np.where evaluates both branches
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(f_safe / min_log_hz) / logstep, mel)


def _mel_to_hz(m, htk: bool):
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3.0)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3.0)
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


@functools.lru_cache(maxsize=8)
def mel_filterbank(cfg: MelConfig) -> np.ndarray:
    """[n_bins, n_mels] triangular filterbank (Slaney-normalized unless
    htk), numpy (host, cached)."""
    n_bins = cfg.n_fft // 2 + 1
    fmax = cfg.fmax if cfg.fmax is not None else cfg.sample_rate / 2
    fft_freqs = np.linspace(0.0, cfg.sample_rate / 2, n_bins)
    mel_pts = np.linspace(_hz_to_mel(cfg.fmin, cfg.htk),
                          _hz_to_mel(fmax, cfg.htk), cfg.n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, cfg.htk)
    fb = np.zeros((n_bins, cfg.n_mels), dtype=np.float64)
    for m in range(cfg.n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    if not cfg.htk:  # Slaney area normalization
        enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
        fb *= enorm[None, :]
    return fb.astype(np.float32)


def reflect_pad(wav: torch.Tensor, pad: int) -> torch.Tensor:
    """wav [B, T] reflect-padded by `pad` samples on each side, as
    `np.pad(..., mode="reflect")` pads: the reflection repeats where the
    pad is longer than the signal (`F.pad` and `torch.stft(center=True)`
    refuse that), and a one-sample signal repeats its sample."""
    T = wav.shape[-1]
    idx = torch.arange(-pad, T + pad, device=wav.device)
    if T == 1:
        idx = torch.zeros_like(idx)
    else:
        period = 2 * (T - 1)
        idx = idx.remainder(period)
        idx = torch.where(idx >= T, period - idx, idx)
    return wav[:, idx]


def _spectrogram64(wav: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[B, n_frames, n_bins] float64 power (or magnitude) spectrum."""
    wav = wav.to(torch.float64)
    if cfg.center:
        wav = reflect_pad(wav, cfg.n_fft // 2)
    n_bins = cfg.n_fft // 2 + 1
    if wav.shape[-1] < cfg.n_fft:
        return wav.new_zeros((wav.shape[0], 0, n_bins))
    # A periodic Hann window of win_length, which torch.stft centres in
    # n_fft as the JAX basis does.
    window = torch.hann_window(cfg.win_length, periodic=True,
                               dtype=torch.float64, device=wav.device)
    spec = torch.stft(wav, cfg.n_fft, hop_length=cfg.hop_length,
                      win_length=cfg.win_length, window=window,
                      center=False, onesided=True, return_complex=True)
    power = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)
    if cfg.power == 2.0:
        return power
    return torch.pow(power.clamp(min=1e-30), cfg.power / 2.0)


def spectrogram(wav: torch.Tensor, cfg: MelConfig = MelConfig()):
    """wav [B, T] float -> linear power (or magnitude) spectrogram
    [B, n_frames, n_bins] float32 on wav's device; n_frames = T // hop + 1
    when centred, else 1 + (T - n_fft) // hop (none when that is < 1)."""
    return _spectrogram64(wav, cfg).to(torch.float32)


def log_mel_spectrogram(wav: torch.Tensor, cfg: MelConfig = MelConfig()):
    """wav [B, T] -> log-mel [B, n_frames, n_mels] float32 on wav's
    device."""
    spec = _spectrogram64(wav, cfg)
    fb = torch.as_tensor(mel_filterbank(cfg), device=spec.device,
                         dtype=torch.float64)
    mel = torch.matmul(spec, fb)
    return torch.log(mel.clamp(min=cfg.log_floor)).to(torch.float32)


def mel_lengths_from_wav_lengths(wav_lengths, cfg: MelConfig = MelConfig()):
    """Number of mel frames produced for each true waveform length."""
    if cfg.center:
        return wav_lengths // cfg.hop_length + 1
    return 1 + (wav_lengths - cfg.n_fft) // cfg.hop_length
