"""The encoders' 1-D convolution, with a float32 backward of matrix products.

cuDNN runs a float32 `Conv1d`'s forward as an implicit GEMM, but for the
weight gradient of the text encoder's k = 3 layers (256 channels, 64-128
tokens, a batch of 64) its heuristics pick FFT algorithms that take a
hundred times the products' own work and tens of GB of workspace, and at
the mel encoder's shapes its implicit-GEMM backward runs at about half the
GEMMs' speed (NVIDIA H100). `Conv1dGemmBackward` keeps `F.conv1d` for the
forward, so the output is the same bits, and writes the backward as float32
GEMMs (cuBLAS on the card, with TF32 as the process set it; the `train`
command turns it off):

* weight gradient, tap j: dW[:, :, j] = sum over (b, t) of
  dY[b, :, t] x_pad[b, :, t + j]^T, one product over every item's frames;
* input gradient: dx_pad[b, :, u] = sum over j of W[:, :, j]^T
  dY[b, :, u + p - j], one product a tap accumulated into one buffer;
* bias gradient: dY summed over items and frames.

The kernel is odd and the padding p = (k - 1) / 2, as the encoders'
`nn.Conv1d(padding=k // 2)` have it, so the output keeps T frames. Both
products read frames as rows, [rows, channels], each item's T frames
between p zero rows on either side (L = T + 2p rows an item), so that a
tap's shift is an offset into one matrix: a row shifted by at most p
stays inside its item or lands on its zeros, and no product pairs two
items. Only what `ctx.needs_input_grad` asks for is computed; only x and
the weight are saved, as for cuDNN's backward.

`conv1d` picks the route from what the call can see: a CUDA tensor in
float32, an odd kernel with padding (k - 1) / 2, and a graph being built
(grad enabled, an input that requires grad) take `Conv1dGemmBackward`;
bfloat16, every call under `no_grad`, and the CPU make the plain
`F.conv1d` call. The CPU keeps its own backward, which has no FFT to
avoid: there a reordered sum moved a bias whose gradient is rounding
noise alone (MoBo's last mel layer, after Adam) past the sharded-step
test's tolerance. `ROUTES` counts the calls by route, as `_build.LAUNCHES`
counts kernel launches.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

# Convolution calls by route: "gemm_backward" or "cudnn" (the plain
# `F.conv1d` call, whose backward is autograd's own).
ROUTES: collections.Counter = collections.Counter()


def route_counts() -> dict[str, int]:
    """Calls by route since the last reset."""
    return dict(ROUTES)


def reset_route_counts() -> None:
    ROUTES.clear()


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, padding=0) -> torch.Tensor:
    """`F.conv1d(x, weight, bias, padding=padding)` (stride 1, one group),
    with the GEMM backward where x is a float32 CUDA tensor, the padding
    keeps T frames and a graph is built."""
    if (x.is_cuda and x.dtype == torch.float32 and torch.is_grad_enabled()
            and weight.shape[2] == 2 * _padding(padding) + 1
            and any(t is not None and t.requires_grad
                    for t in (x, weight, bias))):
        ROUTES["gemm_backward"] += 1
        return Conv1dGemmBackward.apply(x, weight, bias, padding)
    ROUTES["cudnn"] += 1
    return F.conv1d(x, weight, bias, padding=padding)


def _padding(padding) -> int:
    return padding[0] if isinstance(padding, (tuple, list)) else padding


def _rows(t: torch.Tensor, p: int) -> torch.Tensor:
    """[B, C, T] -> [B * (T + 2p), C]: each item's frames as rows between
    p zero rows on each side (a view where t's layout allows)."""
    rows = t.transpose(1, 2)
    if p:
        rows = F.pad(rows, (0, 0, p, p))
    return rows.reshape(-1, rows.shape[2])


class Conv1dGemmBackward(torch.autograd.Function):
    """x [B, C_in, T], weight [C_out, C_in, k] (k odd), bias [C_out] or
    None, padding (k - 1) / 2 -> [B, C_out, T]."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding):
        p = _padding(padding)
        if weight.shape[2] != 2 * p + 1:
            raise ValueError(f"padding {p} with a kernel of "
                             f"{weight.shape[2]}: the GEMM backward takes "
                             "an odd kernel and padding (k - 1) / 2")
        ctx.save_for_backward(x, weight)
        ctx.padding = p
        return F.conv1d(x, weight, bias, padding=padding)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        p = ctx.padding
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        b, c_in, t = x.shape
        k = weight.shape[2]
        g = _rows(dy, p)                    # [B * L, C_out], L = T + 2p
        n = g.shape[0] - 2 * p
        dx = dw = db = None
        if need_x:
            # row q of dx_pad is the sum over j of g[q + p - j] @ W_j
            taps = weight.permute(2, 0, 1).contiguous()    # [k, C_out, C_in]
            out = g.new_empty(g.shape[0], c_in)
            inner = out[p:p + n]
            torch.mm(g[2 * p:], taps[0], out=inner)
            for j in range(1, k):
                inner.addmm_(g[2 * p - j:2 * p - j + n], taps[j])
            dx = out.view(b, t + 2 * p, c_in)[:, p:p + t].transpose(1, 2)
        if need_w:
            # dW_j pairs g's row q with x_pad's row q - p + j
            xp = _rows(x, p)
            g_t = g[p:p + n].t()
            dw = torch.stack([torch.mm(g_t, xp[j:j + n]) for j in range(k)],
                             2)
        if need_b:
            db = dy.sum((0, 2))
        return dx, dw, db, None
