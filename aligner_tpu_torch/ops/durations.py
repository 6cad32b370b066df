"""Duration utilities for Glow-TTS/VITS-style training (port of
aligner_tpu/ops/durations.py): per step, MAS produces a hard path outside
the autograd graph; durations `path.sum(-1)` supervise a duration
predictor, and the path gathers the selected lattice cells for the
likelihood term.

`path_from_durations(durations, max_mel, mel_lengths=None)` here has the
JAX signature; `ops/mas_kernel.py:path_from_durations(durs, T_y)`, the
path of the MAS durations mode, stays beside it with its own.
"""
from __future__ import annotations

import torch


def durations_from_path(path: torch.Tensor, *, frame_major: bool = False):
    """0/1 path -> integer durations per token.

    path: [B, T_x, T_y] (reference layout) or [B, T_y, T_x] if
    frame_major. Returns [B, T_x] in path's dtype.
    """
    return path.sum(dim=1 if frame_major else 2)


def path_from_durations(durations: torch.Tensor, max_mel: int,
                        mel_lengths: torch.Tensor | None = None):
    """Inverse: durations [B, T_x] -> 0/1 float32 path [B, T_x, T_y]."""
    cum = torch.cumsum(durations, dim=1)
    start = cum - durations
    ys = torch.arange(max_mel, device=durations.device)[None, None, :]
    path = (ys >= start[:, :, None]) & (ys < cum[:, :, None])
    if mel_lengths is not None:
        path = path & (ys < mel_lengths[:, None, None])
    return path.to(torch.float32)


def _token_mask(text_lengths: torch.Tensor, T_x: int) -> torch.Tensor:
    return (torch.arange(T_x, device=text_lengths.device)[None, :]
            < text_lengths[:, None])


def duration_loss(log_pred: torch.Tensor, durations: torch.Tensor,
                  text_lengths: torch.Tensor):
    """MSE in the log-duration domain (Glow-TTS/VITS convention: the
    target is ``log(d + 1e-6)``, so at inference ``round(exp(pred))``
    recovers the duration, see `durations_from_log`). Masked and averaged
    per real token. log_pred: [B, T_x] predicted log-durations;
    durations: [B, T_x] targets from MAS (not differentiated)."""
    mask = _token_mask(text_lengths, durations.shape[1])
    target = torch.log(durations.to(torch.float32) + 1e-6)
    err = torch.where(mask, (log_pred - target) ** 2, 0.0)
    return err.sum() / mask.sum().clamp(min=1)


def durations_from_log(log_pred: torch.Tensor,
                       text_lengths: torch.Tensor | None = None, *,
                       min_duration: int = 1):
    """Invert `duration_loss` predictions at inference: ``round(exp(pred))``
    (half to even) clamped to at least `min_duration` frames per real
    token (MAS paths are surjective, so every token gets >= 1 frame);
    padded tokens get 0. Returns int32."""
    d = torch.round(torch.exp(log_pred)).to(torch.int32)
    d = d.clamp(min=min_duration)
    if text_lengths is not None:
        d = torch.where(_token_mask(text_lengths, log_pred.shape[1]), d, 0)
    return d


def selected_loglik(value: torch.Tensor, path: torch.Tensor):
    """Sum of lattice cells on the path, per item: the likelihood term
    that flows gradients through the selected cells. value: [B, T_x, T_y]
    (differentiable); path: same shape, 0/1, detached by the caller."""
    return torch.sum(value * path, dim=(1, 2))
