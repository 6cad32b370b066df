"""OTA-style aligner (port of aligner_tpu/models/ota.py).

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

With `model_pauses` an optional shared pause state is interleaved between
the tokens: one learned pause key competes as an extra label in the
softmax, its log-probability is spread onto every even state of the
2*T_x+1 state lattice, and the losses and the hard path run as the
skip-state DPs (`ops/skip_dp.py`: kernels H5 + H6 backward, and H4); the
outputs gain `pause_durations`.

On a CUDA device the dynamic programmes run as this package's kernels;
on the CPU they run as their plain PyTorch versions. Gradients flow
through the forward-sum loss, the bin loss and the reconstruction
auxiliary, as in the JAX model.

`compute_dtype="bfloat16"` runs the encoders, the pairwise energy product's
inputs and the reconstruction decoder in bfloat16; the parameters stay
float32 (flax's convention), and the energies, the log-softmax, the prior,
every lattice and the losses stay float32, so the kernels never see
bfloat16.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.forward_sum import forward_sum_loss
from ..ops.mas import mas_path_frame_major
from ..ops.prior import beta_binomial_log_prior
from ..ops.skip_dp import (expand_prior_to_states, forward_sum_skip_loss,
                           mas_skip_path_frame_major, split_state_durations)
from ..utils.masks import sequence_mask
from .encoders import MelEncoder, TextEncoder, reset_encoder_parameters


# compute_dtype -> the encoders' dtype (None: float32 throughout).
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


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
        if config.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, "
                f"got {config.compute_dtype!r}")
        # The hard path inside the step is the device's: kernel H1 (or H4)
        # on the card, its plain version on the CPU. `maximum_path`'s host
        # oracle ("cpp") copies the lattice to the host and back, which a
        # train step on the card must never do, so no other route is taken.
        if config.mas_implementation != "auto":
            raise ValueError(
                "the port routes MAS by device; mas_implementation must be "
                f"'auto', got {config.mas_implementation!r}")
        self.config = config
        dtype = COMPUTE_DTYPES[config.compute_dtype]
        self.text_encoder = TextEncoder(config.vocab_size, config.dim,
                                        config.hidden, dtype=dtype,
                                        device=device)
        self.mel_encoder = MelEncoder(config.n_mels, config.dim,
                                      config.hidden, dtype=dtype,
                                      device=device)
        if config.use_recon:
            self.mel_decoder = nn.Linear(config.dim, config.n_mels,
                                         device=device)
        if config.model_pauses:
            # One shared learned pause key, appended as an extra label
            # after the conv encoder. Zero keeps it symmetric with the
            # near-zero token keys under the -L2 energy.
            self.pause_key = nn.Parameter(torch.zeros(config.dim,
                                                      device=device))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Redraw every parameter from `generator` (seed 0 when None); the
        biases and the pause key start at zero."""
        reset_encoder_parameters(self, generator)

    def forward(self, tokens: torch.Tensor, mel: torch.Tensor,
                text_lengths: torch.Tensor, mel_lengths: torch.Tensor,
                pause_bias=None):
        """tokens [B, T_x] int; mel [B, T_y, n_mels] f32; text_lengths,
        mel_lengths [B] int. Returns the JAX model's dict: log_attn,
        logp_with_prior, hard_path (all [B, T_y, T_x], or [B, T_y,
        2*T_x+1] with model_pauses), durations [B, T_x],
        loss_forward_sum, loss_bin and loss_recon, and with model_pauses
        pause_durations [B, T_x+1] (pause j precedes token j).

        pause_bias: optional float or 0-d tensor overriding
        config.pause_bias, so that a training schedule can anneal the
        pause occupancy cost per step (`apply_extra` of
        train.step.make_train_step); it is never read back to the host."""
        cfg = self.config
        B, T_x = tokens.shape
        T_y = mel.shape[1]
        mel_mask = sequence_mask(mel_lengths, T_y)
        text_mask = sequence_mask(text_lengths, T_x)
        keys = self.text_encoder(tokens, text_mask)
        if cfg.model_pauses:
            # label axis = T_x tokens + 1 pause class
            keys = torch.cat([keys, self.pause_key.to(keys.dtype)
                              .expand(B, 1, cfg.dim)], dim=1)
            text_mask = torch.cat([text_mask, text_mask.new_ones((B, 1))],
                                  dim=1)
        queries = self.mel_encoder(mel, mel_mask)

        # Pairwise squared L2 via one batched matmul:
        # |q|^2 - 2 q.k + |k|^2, energies = -temperature * dist^2, all in
        # float32. In bfloat16 the product's inputs are bfloat16 and it
        # accumulates in float32, as jnp.einsum(preferred_element_type=
        # float32) does: the product of two bfloat16 values is exact in
        # float32, so upcasting the inputs gives that on both devices (TF32
        # is off on the card). `torch.bmm(..., out_dtype=torch.float32)`
        # would read bfloat16 directly, but exists on CUDA only, so the
        # CPU tests could not hold it; it is left for a performance change.
        qf = queries.float()
        kf = keys.float()
        q2 = torch.sum(qf * qf, dim=-1, keepdim=True)            # [B,T_y,1]
        k2 = torch.sum(kf * kf, dim=-1)[:, None, :]              # [B,1,T_x]
        qk = torch.bmm(qf, kf.transpose(1, 2))                   # [B,T_y,T_x]
        energies = -cfg.temperature * (q2 - 2.0 * qk + k2)
        energies = torch.where(text_mask[:, None, :] > 0, energies, -1e9)
        if cfg.model_pauses and (pause_bias is not None or cfg.pause_bias):
            bias = torch.as_tensor(
                cfg.pause_bias if pause_bias is None else pause_bias,
                dtype=energies.dtype, device=energies.device)
            energies = energies + F.pad(bias.reshape(1), (T_x, 0))
        # Softmax over labels (tokens and, with pauses, the one pause
        # class): the pause competes once per frame however many lattice
        # states replicate it.
        log_attn_labels = torch.log_softmax(energies, dim=-1)
        log_attn = log_attn_labels

        if cfg.model_pauses:
            # Spread the label log-probs onto the state axis: token j to
            # state 2j+1, the pause class to every even state (its
            # gradient sums over the copies).
            log_attn = log_attn_labels.new_empty((B, T_y, 2 * T_x + 1))
            log_attn[:, :, 1::2] = log_attn_labels[:, :, :T_x]
            log_attn[:, :, 0::2] = log_attn_labels[:, :, T_x:]

        logp = log_attn
        if cfg.use_prior:
            prior = beta_binomial_log_prior(
                text_lengths, mel_lengths, T_x, T_y, cfg.prior_omega)
            if cfg.model_pauses:
                prior = expand_prior_to_states(prior, text_lengths,
                                               mode=cfg.pause_prior)
            logp = logp + prior

        # The hard Viterbi binarisation runs on the prior-augmented
        # lattice, outside the autograd graph.
        if cfg.model_pauses:
            fs = forward_sum_skip_loss(logp, text_lengths, mel_lengths,
                                       enter_cost=cfg.pause_enter_cost)
            hard = mas_skip_path_frame_major(
                logp.detach(), text_lengths, mel_lengths,
                enter_cost=cfg.pause_enter_cost)
        else:
            fs = forward_sum_loss(logp, text_lengths, mel_lengths)
            hard = mas_path_frame_major(logp.detach(), text_lengths,
                                        mel_lengths)
        frames = mel_lengths.clamp(min=1)
        loss_forward_sum = torch.mean(fs / frames)

        # Binarisation loss: cross-entropy of the soft attention against
        # the hard path, per real frame.
        ce = -torch.sum(hard * log_attn, dim=(1, 2))
        loss_bin = torch.mean(ce / frames)
        durations = torch.sum(hard, dim=1)          # [B, T_x] or [B, T_s]
        pause_durations = None
        if cfg.model_pauses:
            durations, pause_durations = split_state_durations(durations)

        loss_recon = torch.zeros((), device=mel.device)
        if cfg.use_recon:
            # Over the label axis (tokens + pause class): the pause key
            # decodes to the silence spectrum, which anchors silence
            # frames to the pause class.
            dec = self.mel_decoder
            dt = keys.dtype                  # the compute dtype; out float32
            decoded = F.linear(keys, dec.weight.to(dt),
                               dec.bias.to(dt)).float()     # [B,L,n_mels]
            recon = torch.bmm(torch.exp(log_attn_labels), decoded)
            frame_mask = mel_mask[..., None]
            loss_recon = (torch.sum(frame_mask * (recon - mel) ** 2)
                          / frame_mask.sum().clamp(min=1.0) / cfg.n_mels)
            if cfg.model_pauses and cfg.pause_silence_anchor:
                # Silence anchor: pull the pause key's decoded spectrum
                # toward the batch's silence estimate, each utterance's
                # minimum-energy valid frame (no labels needed).
                energy = torch.where(mel_mask > 0, mel.mean(dim=-1),
                                     torch.inf)
                # The first frame that attains the minimum, as
                # jnp.argmin picks it; torch.argmin promises no order
                # among ties on a CUDA device.
                ys = torch.arange(T_y, device=mel.device)
                lowest = energy.amin(dim=1, keepdim=True)
                idx = torch.where(energy == lowest, ys, T_y - 1).amin(dim=1)
                silence = mel[torch.arange(B, device=mel.device), idx]
                target = silence.mean(dim=0).detach()       # [n_mels]
                anchor = torch.mean((decoded[:, T_x] - target) ** 2)
                loss_recon = loss_recon + cfg.pause_silence_anchor * anchor

        out = {
            "loss_recon": loss_recon,
            "log_attn": log_attn,
            "logp_with_prior": logp,
            "loss_forward_sum": loss_forward_sum,
            "loss_bin": loss_bin,
            "hard_path": hard,
            "durations": durations,
        }
        if pause_durations is not None:
            out["pause_durations"] = pause_durations
        return out
