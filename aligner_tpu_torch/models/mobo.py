"""MoBoAligner model, the boundary-search alignment module (port of
aligner_tpu/models/mobo.py).

Wraps the MoBo boundary-search ops (`ops/mobo.py`, arXiv 2005.08528) with
the same conv encoders as the OTA aligner: energies are scaled dot
products between mel queries and text keys, the boundary recursion runs
under the max-duration constraint D, and the module returns the
differentiable boundary NLL, soft alignments, expected durations and the
hard Viterbi boundaries. On a CUDA device the recursions are kernels H7,
H9 and (for the hard boundaries) H8; on the CPU their plain versions.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.mobo import mobo_forward, mobo_hard_boundaries
from ..parallel.data import batch_mean
from ..parallel.tensor import linear
from ..utils.masks import sequence_mask
from .encoders import MelEncoder, TextEncoder, reset_encoder_parameters


@dataclasses.dataclass(frozen=True)
class MoBoConfig:
    """The JAX package's MoBoConfig, field for field."""
    vocab_size: int = 256
    n_mels: int = 80
    dim: int = 192
    hidden: int = 256
    max_duration: int = 32
    energy_scale: float | None = None  # default 1/sqrt(dim)
    # Per-frame mel reconstruction through the boundary posteriors, the
    # objective that pins boundaries (the marginal NLL alone only shapes
    # energies): mel_decoder(keys) plays the role of the synthetic demos'
    # known prototypes. Adds `loss_recon` to the outputs when True.
    use_recon: bool = False


def masked_recon_loss(soft_alignment: torch.Tensor, decoded: torch.Tensor,
                      mel: torch.Tensor, mask: torch.Tensor,
                      n_mels: int) -> torch.Tensor:
    """Mean squared error of the mel frames rebuilt through the alignment
    posteriors, over the frames where mask [B, T_y, 1] is 1 in the whole
    batch (`batch_mean`: summed over the data ranks of a sharded step)."""
    recon = torch.bmm(soft_alignment, decoded)
    return batch_mean(torch.sum(mask * (recon - mel) ** 2),
                      mask.sum()) / n_mels


class MoBoAligner(nn.Module):
    """Parameters are made on `device` and drawn from `generator` as
    `OTAAligner`'s are, or loaded from a converted flax tree with
    `models.convert`."""

    def __init__(self, config: MoBoConfig = MoBoConfig(), *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        self.text_encoder = TextEncoder(config.vocab_size, config.dim,
                                        config.hidden, device=device)
        self.mel_encoder = MelEncoder(config.n_mels, config.dim,
                                      config.hidden, device=device)
        if config.use_recon:
            self.mel_decoder = nn.Linear(config.dim, config.n_mels,
                                         device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        reset_encoder_parameters(self, generator)

    def forward(self, tokens: torch.Tensor, mel: torch.Tensor,
                text_lengths: torch.Tensor, mel_lengths: torch.Tensor,
                compute_hard: bool = True):
        """tokens [B, T_x] int; mel [B, T_y, n_mels] f32; text_lengths,
        mel_lengths [B] int. Returns the JAX model's dict: energies and
        soft_alignment [B, T_y, T_x], loss_mobo, expected_durations
        [B, T_x], log_boundaries [B, T_x, T_y], loss_recon with
        use_recon, and with compute_hard hard_durations [B, T_x] int32
        and hard_path [B, T_y, T_x]."""
        cfg = self.config
        T_x = tokens.shape[1]
        T_y = mel.shape[1]
        text_mask = sequence_mask(text_lengths, T_x)
        mel_mask = sequence_mask(mel_lengths, T_y)
        keys = self.text_encoder(tokens, text_mask)
        queries = self.mel_encoder(mel, mel_mask)
        scale = (cfg.energy_scale if cfg.energy_scale is not None
                 else cfg.dim ** -0.5)
        energies = scale * torch.bmm(queries, keys.transpose(1, 2))

        out = mobo_forward(energies, text_lengths, mel_lengths,
                           cfg.max_duration)
        result = {
            "energies": energies,
            "loss_mobo": torch.mean(out["loss"] / mel_lengths.clamp(min=1)),
            "soft_alignment": out["soft_alignment"],
            "expected_durations": out["expected_durations"],
            "log_boundaries": out["log_boundaries"],
        }
        if cfg.use_recon:
            result["loss_recon"] = masked_recon_loss(
                out["soft_alignment"], linear(self.mel_decoder, keys), mel,
                mel_mask[..., None], cfg.n_mels)
        if compute_hard:
            durs, path = mobo_hard_boundaries(
                energies.detach(), text_lengths, mel_lengths,
                cfg.max_duration)
            result["hard_durations"] = durs
            result["hard_path"] = path
        return result
