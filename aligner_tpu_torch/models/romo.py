"""RoMoAligner: rough alignment + MoBo refinement (port of
aligner_tpu/models/romo.py).

1. Rough stage: the OTA machinery produces soft alignment posteriors
   (forward-sum over log-attention + beta-binomial prior; kernels H2 and
   H3 on a CUDA device); expected durations give rough boundary anchors
   r_i = cumsum(E[dur]) - 1.
2. Refinement stage: MoBo boundary search (kernels H7, H9 and, for the
   hard boundaries, H8) on energies windowed around the anchors:
   candidates outside |t - r_i| <= window get NEG. Long tokens stay
   reachable because the search is re-anchored per token by the rough
   alignment instead of accumulating from frame 0.

Both stages are differentiable: the rough one through the forward-sum
gradient, the refinement through the MoBo adjoint, with the anchors
detached.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.forward_sum import forward_sum_loss_with_posteriors
from ..ops.mobo import mobo_forward, mobo_hard_boundaries
from ..ops.prior import beta_binomial_log_prior
from ..parallel.data import batch_mean
from ..parallel.tensor import linear
from ..utils.masks import sequence_mask
from .encoders import MelEncoder, TextEncoder, reset_encoder_parameters
from .mobo import masked_recon_loss


@dataclasses.dataclass(frozen=True)
class RoMoConfig:
    """The JAX package's RoMoConfig, field for field."""
    vocab_size: int = 256
    n_mels: int = 80
    dim: int = 192
    hidden: int = 256
    temperature: float = 0.05
    prior_omega: float = 1.0
    window: int = 16            # refinement half-window around anchors
    max_duration: int = 32      # MoBo transition window in the refinement
    energy_scale: float | None = None
    # Learned per-frame mel reconstruction through the refinement
    # posteriors, which pins the refined boundaries. Items whose
    # refinement is infeasible are gated out (their posteriors are
    # sentinels). Adds `loss_recon` when True.
    use_recon: bool = False


class RoMoAligner(nn.Module):
    """Parameters are made on `device` and drawn from `generator` as
    `OTAAligner`'s are, or loaded from a converted flax tree with
    `models.convert`."""

    def __init__(self, config: RoMoConfig = RoMoConfig(), *, device=None,
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
        mel_lengths [B] int. Returns the JAX model's dict: log_attn,
        rough_posteriors and soft_alignment [B, T_y, T_x], loss_rough,
        loss_refine, loss, refine_feasible [B] bool, rough_durations,
        anchors and expected_durations [B, T_x], loss_recon with
        use_recon, and with compute_hard hard_durations [B, T_x] int32
        (meaningless where refine_feasible is False) and hard_path."""
        cfg = self.config
        T_x = tokens.shape[1]
        T_y = mel.shape[1]
        dev = mel.device
        text_mask = sequence_mask(text_lengths, T_x)
        mel_mask = sequence_mask(mel_lengths, T_y)
        keys = self.text_encoder(tokens, text_mask)
        queries = self.mel_encoder(mel, mel_mask)

        # ---- rough stage (OTA-style) ----
        q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
        k2 = torch.sum(keys * keys, dim=-1)[:, None, :]
        qk = torch.bmm(queries, keys.transpose(1, 2))       # [B, T_y, T_x]
        energies_soft = -cfg.temperature * (q2 - 2.0 * qk + k2)
        energies_soft = torch.where(text_mask[:, None, :] > 0,
                                    energies_soft, -1e9)
        log_attn = torch.log_softmax(energies_soft, dim=-1)
        logp = log_attn + beta_binomial_log_prior(
            text_lengths, mel_lengths, T_x, T_y, cfg.prior_omega)
        # Loss and posteriors from one alpha + beta sweep; gamma is also
        # the loss gradient, so the backward needs no further sweep.
        fs, gamma = forward_sum_loss_with_posteriors(
            logp, text_lengths, mel_lengths)
        frames = mel_lengths.clamp(min=1)
        loss_rough = torch.mean(fs / frames)

        # expected durations -> rough boundary anchors (no gradient)
        exp_dur = torch.sum(gamma, dim=1)                    # [B, T_x]
        anchors = (torch.cumsum(exp_dur, dim=1) - 1.0).detach()

        # ---- refinement stage (windowed MoBo) ----
        scale = (cfg.energy_scale if cfg.energy_scale is not None
                 else cfg.dim ** -0.5)
        energies_mobo = scale * qk
        ys = torch.arange(T_y, dtype=torch.float32, device=dev)[None, :, None]
        in_window = torch.abs(ys - anchors[:, None, :]) <= float(cfg.window)
        # the pinned final boundary must stay reachable for every item
        is_final = (torch.arange(T_x, device=dev)[None, None, :]
                    == text_lengths[:, None, None] - 1)
        at_end = ys == mel_lengths[:, None, None].to(torch.float32) - 1
        in_window = in_window | (is_final & at_end)
        energies_win = torch.where(in_window, energies_mobo, -1e15)

        mobo = mobo_forward(energies_win, text_lengths, mel_lengths,
                            cfg.max_duration)
        # Gate infeasible items (no boundary sequence fits the window and
        # max-duration constraints) out of the loss: their ~1e15 sentinel
        # would otherwise swamp metrics while contributing no gradient.
        feasible = mobo["loss"] < 1e14
        per_item = torch.where(feasible, mobo["loss"] / frames, 0.0)
        # over the feasible items of the whole batch (`batch_mean`)
        loss_refine = batch_mean(per_item.sum(), feasible.sum())

        result = {
            "log_attn": log_attn,
            "loss_rough": loss_rough,
            "loss_refine": loss_refine,
            "loss": loss_rough + loss_refine,
            "refine_feasible": feasible,
            "rough_posteriors": gamma,
            "rough_durations": exp_dur,
            "anchors": anchors,
            "soft_alignment": mobo["soft_alignment"],
            "expected_durations": mobo["expected_durations"],
        }
        if cfg.use_recon:
            result["loss_recon"] = masked_recon_loss(
                mobo["soft_alignment"], linear(self.mel_decoder, keys), mel,
                mel_mask[..., None] * feasible[:, None, None], cfg.n_mels)
        if compute_hard:
            durs, path = mobo_hard_boundaries(
                energies_win.detach(), text_lengths, mel_lengths,
                cfg.max_duration)
            result["hard_durations"] = durs
            result["hard_path"] = path
        return result
