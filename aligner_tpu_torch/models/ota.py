"""OTA-style aligner (port of aligner_tpu/models/ota.py, non-pause branch).

Implements "One TTS Alignment To Rule Them All" (arXiv 2108.10447):

  text tokens --TextEncoder--> keys  --+
                                       +--> pairwise -L2^2 energies
  mel frames --MelEncoder---> queries -+       | log_softmax over text
                                               v
                        log-attention (+ beta-binomial prior)
                         |                          |
   forward-sum NLL (kernels H2 + H3 backward)   MAS hard path (kernel H1,
                         |                       outside the autograd graph)
                         +-- bin loss: -sum hard * log_attn / frames --+

On a CUDA device the dynamic programmes run as this package's kernels;
on the CPU they run as their plain PyTorch versions. Gradients flow
through the forward-sum loss, the bin loss and the reconstruction
auxiliary, as in the JAX model. The pause branch and bfloat16 compute are
not ported yet and raise.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.forward_sum import forward_sum_loss
from ..ops.mas import mas_path_frame_major
from ..ops.prior import beta_binomial_log_prior
from ..utils.masks import sequence_mask
from .encoders import MelEncoder, TextEncoder


@dataclasses.dataclass(frozen=True)
class OTAConfig:
    """The JAX package's OTAConfig, field for field (see
    aligner_tpu/models/ota.py for what each one means)."""
    vocab_size: int = 256
    n_mels: int = 80
    dim: int = 192
    hidden: int = 256
    temperature: float = 0.1
    prior_omega: float = 1.0
    use_prior: bool = True
    mas_implementation: str = "auto"
    use_recon: bool = False
    model_pauses: bool = False
    pause_prior: str = "bridge"
    pause_bias: float = 0.0
    pause_enter_cost: float = 0.0
    pause_silence_anchor: float = 0.0
    compute_dtype: str = "float32"


class OTAAligner(nn.Module):
    """Returns the soft/hard alignment artefacts and the losses.

    Parameters are made on `device` and drawn from `generator` (a CPU
    torch.Generator; seed 0 when None) at the scales of flax's default
    initialisers (normal kernels and embeddings with variance 1/fan-in,
    zero biases), or loaded from a converted flax tree with
    `models.convert`.
    """

    def __init__(self, config: OTAConfig = OTAConfig(), *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if config.model_pauses:
            raise NotImplementedError(
                "model_pauses=True is not ported yet (ROADMAP Queue 1 item 9, "
                "with the skip-state kernels of Queue 2 C)")
        if config.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={config.compute_dtype!r} is not ported yet "
                "(ROADMAP Queue 1 item 6, bfloat16 autocast)")
        if config.mas_implementation != "auto":
            raise ValueError(
                "the port routes MAS by device; mas_implementation must be "
                f"'auto', got {config.mas_implementation!r}")
        self.config = config
        self.text_encoder = TextEncoder(config.vocab_size, config.dim,
                                        config.hidden, device=device)
        self.mel_encoder = MelEncoder(config.n_mels, config.dim,
                                      config.hidden, device=device)
        if config.use_recon:
            self.mel_decoder = nn.Linear(config.dim, config.n_mels,
                                         device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Redraw every parameter from `generator` (seed 0 when None)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
                continue
            if name.endswith("embed.weight"):
                fan_in = p.shape[1]
            else:                       # conv [out, in, k], dense [out, in]
                fan_in = p[0].numel()
            w = torch.randn(p.shape, generator=generator) * fan_in ** -0.5
            p.copy_(w)

    def forward(self, tokens: torch.Tensor, mel: torch.Tensor,
                text_lengths: torch.Tensor, mel_lengths: torch.Tensor):
        """tokens [B, T_x] int; mel [B, T_y, n_mels] f32; text_lengths,
        mel_lengths [B] int. Returns the JAX model's dict: log_attn,
        logp_with_prior, hard_path (all [B, T_y, T_x]), durations
        [B, T_x], loss_forward_sum, loss_bin and loss_recon."""
        cfg = self.config
        B, T_x = tokens.shape
        T_y = mel.shape[1]
        mel_mask = sequence_mask(mel_lengths, T_y)
        text_mask = sequence_mask(text_lengths, T_x)
        keys = self.text_encoder(tokens, text_mask)
        queries = self.mel_encoder(mel, mel_mask)

        # Pairwise squared L2 via one batched matmul:
        # |q|^2 - 2 q.k + |k|^2, energies = -temperature * dist^2.
        q2 = torch.sum(queries * queries, dim=-1, keepdim=True)  # [B,T_y,1]
        k2 = torch.sum(keys * keys, dim=-1)[:, None, :]          # [B,1,T_x]
        qk = torch.bmm(queries, keys.transpose(1, 2))            # [B,T_y,T_x]
        energies = -cfg.temperature * (q2 - 2.0 * qk + k2)
        energies = torch.where(text_mask[:, None, :] > 0, energies, -1e9)
        log_attn = torch.log_softmax(energies, dim=-1)

        logp = log_attn
        if cfg.use_prior:
            logp = logp + beta_binomial_log_prior(
                text_lengths, mel_lengths, T_x, T_y, cfg.prior_omega)

        fs = forward_sum_loss(logp, text_lengths, mel_lengths)
        # Hard Viterbi binarisation on the prior-augmented lattice,
        # outside the autograd graph.
        hard = mas_path_frame_major(logp.detach(), text_lengths, mel_lengths)
        frames = mel_lengths.clamp(min=1)
        loss_forward_sum = torch.mean(fs / frames)

        # Binarisation loss: cross-entropy of the soft attention against
        # the hard path, per real frame.
        ce = -torch.sum(hard * log_attn, dim=(1, 2))
        loss_bin = torch.mean(ce / frames)
        durations = torch.sum(hard, dim=1)                       # [B, T_x]

        loss_recon = torch.zeros((), device=mel.device)
        if cfg.use_recon:
            decoded = self.mel_decoder(keys)                     # [B,T_x,n_mels]
            recon = torch.bmm(torch.exp(log_attn), decoded)      # [B,T_y,n_mels]
            frame_mask = mel_mask[..., None]
            loss_recon = (torch.sum(frame_mask * (recon - mel) ** 2)
                          / frame_mask.sum().clamp(min=1.0) / cfg.n_mels)

        return {
            "loss_recon": loss_recon,
            "log_attn": log_attn,
            "logp_with_prior": logp,
            "loss_forward_sum": loss_forward_sum,
            "loss_bin": loss_bin,
            "hard_path": hard,
            "durations": durations,
        }
