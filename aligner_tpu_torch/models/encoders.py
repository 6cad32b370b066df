"""Text / mel encoders for the alignment stack (port of
aligner_tpu/models/encoders.py).

A small stack of 1-D convolutions with ReLU between them, projecting into
`dim`. The public modules keep the JAX package's [B, T, C] layout and
transpose to PyTorch's [B, C, T] inside. `nn.Conv1d(padding=k // 2)`
matches flax's "SAME" padding for the odd kernel sizes used here (3, 1).
Submodules carry flax's names (`embed`, `convs.conv0`, ...) so that
`models/convert.py` maps a flax param tree one to one.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn


class ConvStack(nn.Module):
    def __init__(self, in_features: int, features: Sequence[int],
                 kernel_sizes: Sequence[int], *, device=None):
        super().__init__()
        self.n_layers = len(features)
        c_in = in_features
        for i, (f, k) in enumerate(zip(features, kernel_sizes)):
            self.add_module(f"conv{i}", nn.Conv1d(c_in, f, k, padding=k // 2,
                                                  device=device))
            c_in = f

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        """x: [B, T, C]; mask: [B, T] (1 = real). Returns [B, T, C_out]."""
        m = None if mask is None else mask[:, None, :].to(x.dtype)
        x = x.transpose(1, 2)
        for i in range(self.n_layers):
            if m is not None:
                x = x * m
            x = getattr(self, f"conv{i}")(x)
            if i != self.n_layers - 1:
                x = torch.relu(x)
        if m is not None:
            x = x * m
        return x.transpose(1, 2)


class TextEncoder(nn.Module):
    """Token ids [B, T_x] -> keys [B, T_x, dim]."""

    def __init__(self, vocab_size: int, dim: int = 192, hidden: int = 256,
                 *, device=None):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, hidden, device=device)
        self.convs = ConvStack(hidden, (hidden, hidden, dim), (3, 3, 1),
                               device=device)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor | None = None):
        return self.convs(self.embed(tokens), mask)


class MelEncoder(nn.Module):
    """Mel frames [B, T_y, n_mels] -> queries [B, T_y, dim]."""

    def __init__(self, n_mels: int = 80, dim: int = 192, hidden: int = 256,
                 *, device=None):
        super().__init__()
        self.convs = ConvStack(n_mels, (hidden, hidden, dim), (3, 3, 1),
                               device=device)

    def forward(self, mel: torch.Tensor, mask: torch.Tensor | None = None):
        return self.convs(mel, mask)


@torch.no_grad()
def reset_encoder_parameters(module: nn.Module,
                             generator: torch.Generator | None = None):
    """Redraw every parameter of an encoder-based aligner from `generator`
    (seed 0 when None) at the scales of flax's default initialisers:
    normal kernels and embeddings with variance 1/fan-in; biases and the
    pause key start at zero."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for name, p in module.named_parameters():
        if p.ndim == 1:                 # biases and the pause key
            p.zero_()
            continue
        if name.endswith("embed.weight"):
            fan_in = p.shape[1]
        else:                           # conv [out, in, k], dense [out, in]
            fan_in = p[0].numel()
        p.copy_(torch.randn(p.shape, generator=generator) * fan_in ** -0.5)
