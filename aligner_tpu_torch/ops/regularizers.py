"""Alignment-shape regularizers (port of aligner_tpu/ops/regularizers.py).

`monotonic_attention_loss` is the Regotron-style soft monotonicity penalty
(arXiv 2204.13437): the attention centroid over text positions should not
decrease across mel frames; adjacent-frame centroid regressions beyond a
slack are penalised with a hinge. It is a cheap O(B*T_y*T_x) elementwise
term usable with any attention matrix.
"""
from __future__ import annotations

import torch

from ..utils.masks import sequence_mask


def attention_centroids(attn: torch.Tensor,
                        text_lengths: torch.Tensor | None = None):
    """Per-frame attention centroid over text positions.

    attn: [B, T_y, T_x] non-negative rows (rows need not be normalised:
    centroids divide by the row mass). Returns [B, T_y] float32 centroids
    in token units.
    """
    attn = attn.to(torch.float32)
    T_x = attn.shape[-1]
    pos = torch.arange(T_x, dtype=torch.float32, device=attn.device)
    if text_lengths is not None:
        attn = attn * sequence_mask(text_lengths, T_x)[:, None, :]
    mass = torch.sum(attn, dim=-1).clamp(min=1e-9)
    return torch.sum(attn * pos, dim=-1) / mass


def monotonic_attention_loss(attn: torch.Tensor, mel_lengths: torch.Tensor,
                             text_lengths: torch.Tensor | None = None, *,
                             slack: float = 0.0):
    """Regotron-style monotonicity hinge on attention centroids.

    attn: [B, T_y, T_x] soft attention; mel_lengths: [B] int, only pairs
    of adjacent real frames are penalised; text_lengths: optional [B] to
    leave padded tokens out of the centroid. slack: allowed per-frame
    centroid regression (tokens) before the hinge activates.

    Returns the scalar mean hinge over valid adjacent frame pairs,
    mean_t max(0, c_t - c_{t+1} - slack): zero for any monotone
    alignment, differentiable elsewhere.
    """
    c = attention_centroids(attn, text_lengths)          # [B, T_y]
    T_y = c.shape[1]
    # torch.maximum splits a tied gradient evenly, as jnp.maximum does.
    viol = torch.maximum(c[:, :-1] - c[:, 1:] - slack, c.new_zeros(()))
    # pair (t, t+1) is valid iff frame t+1 is real
    pair_mask = sequence_mask(mel_lengths - 1, T_y - 1)
    total = torch.sum(viol * pair_mask)
    return total / torch.sum(pair_mask).clamp(min=1.0)
