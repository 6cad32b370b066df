"""Text / mel encoders for the alignment stack (port of
aligner_tpu/models/encoders.py).

A small stack of 1-D convolutions with ReLU between them, projecting into
`dim`. The public modules keep the JAX package's [B, T, C] layout and
transpose to PyTorch's [B, C, T] inside. `nn.Conv1d(padding=k // 2)`
matches flax's "SAME" padding for the odd kernel sizes used here (3, 1).
Submodules carry flax's names (`embed`, `convs.conv0`, ...) so that
`models/convert.py` maps a flax param tree one to one. The layers run
through `parallel/tensor.py`, which splits a layer that
`parallel.shard_params` sharded over the mesh's model axis and makes the
plain call otherwise. A convolution's call is `ops/conv.py`'s: in float32
on the card while a graph is built (training), cuDNN's forward and a
backward of cuBLAS float32 GEMMs, since cuDNN's own float32 backward runs
FFT algorithms at the text encoder's shapes; in bfloat16, under `no_grad`
(`align`, serving) and on the CPU, `F.conv1d` forward and backward.

`dtype` is the computation dtype, as in flax: the parameters stay float32,
and the forward pass casts the input, the conv weights and biases and the
embedding's output to `dtype`, so the mask, the convolutions and ReLU run
in it and the output comes out in it (None: the input's dtype, float32).
The casts are written out rather than left to `torch.autocast`, whose op
lists differ between the CPU and CUDA. flax adds the bias after rounding
the convolution to bfloat16; cuDNN and oneDNN add it before, so bfloat16
outputs differ from the JAX package's by about one bfloat16 ulp.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from ..parallel.tensor import conv1d, embedding


class ConvStack(nn.Module):
    def __init__(self, in_features: int, features: Sequence[int],
                 kernel_sizes: Sequence[int], *,
                 dtype: torch.dtype | None = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.n_layers = len(features)
        c_in = in_features
        for i, (f, k) in enumerate(zip(features, kernel_sizes)):
            self.add_module(f"conv{i}", nn.Conv1d(c_in, f, k, padding=k // 2,
                                                  device=device))
            c_in = f

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        """x: [B, T, C]; mask: [B, T] (1 = real). Returns [B, T, C_out] in
        `dtype`."""
        dt = x.dtype if self.dtype is None else self.dtype
        m = None if mask is None else mask[:, None, :].to(dt)
        x = x.to(dt).transpose(1, 2)
        for i in range(self.n_layers):
            if m is not None:
                x = x * m
            x = conv1d(getattr(self, f"conv{i}"), x, dt)
            if i != self.n_layers - 1:
                x = torch.relu(x)
        if m is not None:
            x = x * m
        return x.transpose(1, 2)


class TextEncoder(nn.Module):
    """Token ids [B, T_x] -> keys [B, T_x, dim]."""

    def __init__(self, vocab_size: int, dim: int = 192, hidden: int = 256,
                 *, dtype: torch.dtype | None = None, device=None):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, hidden, device=device)
        self.convs = ConvStack(hidden, (hidden, hidden, dim), (3, 3, 1),
                               dtype=dtype, device=device)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor | None = None):
        x = embedding(self.embed, tokens)
        if self.convs.dtype is not None:
            x = x.to(self.convs.dtype)      # nn.Embed(dtype=...) in flax
        return self.convs(x, mask)


class MelEncoder(nn.Module):
    """Mel frames [B, T_y, n_mels] -> queries [B, T_y, dim]."""

    def __init__(self, n_mels: int = 80, dim: int = 192, hidden: int = 256,
                 *, dtype: torch.dtype | None = None, device=None):
        super().__init__()
        self.convs = ConvStack(n_mels, (hidden, hidden, dim), (3, 3, 1),
                               dtype=dtype, device=device)

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
