"""MAS inside a VITS/Glow-TTS-style training step, with the PyTorch port.

The twin of examples/vits_style_integration.py. Per step, the encoder
outputs define a pairwise log-likelihood lattice; `maximum_path` (outside
the autograd graph) picks the hard monotonic alignment, kernel H1 on the
card; its durations supervise a duration predictor, and the likelihood
term flows gradients through the selected lattice cells only.

    python examples/vits_style_integration_torch.py [--device cuda]

With `--device cpu` the step runs H1's plain version; there is no
fallback from cuda to cpu.
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np
import torch

from aligner_tpu_torch import maximum_path
from aligner_tpu_torch.ops.durations import (duration_loss,
                                             durations_from_path,
                                             selected_loglik)
from aligner_tpu_torch.utils.masks import lattice_mask


def gaussian_loglik_lattice(mu, logs, mel):
    """VITS-style lattice: log N(mel_frame | mu_token, sigma_token) summed
    over channels. mu, logs: [B, T_x, C]; mel: [B, T_y, C].
    Returns [B, T_x, T_y]."""
    inv_var = torch.exp(-2.0 * logs)                              # [B,Tx,C]
    const = torch.sum(-0.5 * math.log(2 * math.pi) - logs, dim=-1)
    quad = -0.5 * torch.einsum("byc,bxc->bxy", mel ** 2, inv_var)
    cross = torch.einsum("byc,bxc->bxy", mel, mu * inv_var)
    center = torch.sum(-0.5 * mu ** 2 * inv_var, dim=-1)          # [B,Tx]
    return quad + cross + center[:, :, None] + const[:, :, None]


def train_step(params, mel, tokens_emb, mask, text_lengths, lr=1e-2):
    """One step: lattice -> MAS -> duration + likelihood losses -> SGD."""
    mu = tokens_emb @ params["w_mu"]
    logs = tokens_emb @ params["w_logs"]
    value = gaussian_loglik_lattice(mu, logs, mel)
    # Hard alignment: outside the autograd graph, on the tensor's device.
    path = maximum_path(value.detach(), mask)
    durations = durations_from_path(path)
    log_dur_pred = (tokens_emb @ params["w_dur"]).squeeze(-1)
    l_dur = duration_loss(log_dur_pred, durations, text_lengths)
    # Likelihood through the selected cells only.
    l_mle = -torch.mean(selected_loglik(value, path)
                        / durations.sum(-1).clamp(min=1))
    loss = l_mle + l_dur
    grads = torch.autograd.grad(loss, list(params.values()))
    with torch.no_grad():
        for p, g in zip(params.values(), grads):
            p -= lr * g
    return loss.detach(), l_mle.detach(), l_dur.detach()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run the "
                         "plain version on the CPU")

    rng = np.random.default_rng(0)
    B, T_x, T_y, C = 8, 24, 96, 20

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    tokens_emb = tensor(rng.standard_normal((B, T_x, 32)))
    mel = tensor(rng.standard_normal((B, T_y, C)))
    t_x_np = rng.integers(12, T_x + 1, B)
    t_y_np = np.maximum(t_x_np * 2, rng.integers(48, T_y + 1, B))
    t_x = torch.from_numpy(t_x_np).to(device)
    mask = lattice_mask(t_x, torch.from_numpy(t_y_np).to(device), T_x, T_y)
    params = {
        "w_mu": tensor(rng.standard_normal((32, C)) * 0.1),
        "w_logs": tensor(np.zeros((32, C))),
        "w_dur": tensor(rng.standard_normal((32, 1)) * 0.1),
    }
    for p in params.values():
        p.requires_grad_()
    for i in range(args.steps):
        loss, l_mle, l_dur = train_step(params, mel, tokens_emb, mask, t_x)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {float(loss):8.3f}  "
                  f"mle {float(l_mle):8.3f}  dur {float(l_dur):6.3f}")
    print(f"done - MAS ran inside the step on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
