"""Forward-sum recursions in plain PyTorch, differentiated by autograd.

Token lattice (one state a token):

    alpha[y, x] = lp[y, x] + logaddexp(alpha[y-1, x], alpha[y-1, x-1])
    alpha[0, 0] = lp[0, 0];  nll = -alpha[t_y-1, t_x-1]

Pause lattice (T_s = 2 t_x + 1 states; even s a pause, odd s token
(s-1)/2): moves stay, advance (s-1 -> s, plus `enter_cost` into a pause)
and skip (s-2 -> s onto a token s >= 3, over the pause between); a path
starts in state 0 (plus `enter_cost`) or 1 and ends in T_s-1 or T_s-2.

lp is frame-major [B, T_y, T]; cells past an item's states and frames
must already hold a large negative number (the lattices built by
`reference.ota` do). Frames past t_y keep the carry.
"""
from __future__ import annotations

import torch

NEG = -1e15


def _shift(a: torch.Tensor, k: int) -> torch.Tensor:
    """a shifted right by k along the last axis, NEG filling the front."""
    return torch.cat([a.new_full(a.shape[:-1] + (k,), NEG), a[..., :-k]],
                     dim=-1)


def forward_sum_nll(lp: torch.Tensor, t_x: torch.Tensor,
                    t_y: torch.Tensor) -> torch.Tensor:
    """Per-item negative log-marginal [B] of the token lattice."""
    B, T_y, T = lp.shape
    xs = torch.arange(T, device=lp.device)
    alpha = lp[:, 0] + torch.where(xs == 0, 0.0, NEG)
    for y in range(1, T_y):
        nxt = lp[:, y] + torch.logaddexp(alpha, _shift(alpha, 1))
        alpha = torch.where((t_y > y)[:, None], nxt, alpha)
    end = (xs[None, :] == (t_x - 1)[:, None])
    return -(alpha * end).sum(dim=1)


def forward_sum_skip_nll(lp: torch.Tensor, t_x: torch.Tensor,
                         t_y: torch.Tensor,
                         enter_cost: float = 0.0) -> torch.Tensor:
    """Per-item negative log-marginal [B] of the pause lattice."""
    B, T_y, T = lp.shape
    c = float(enter_cost)
    ss = torch.arange(T, device=lp.device)
    even = ss % 2 == 0
    skip_ok = (ss % 2 == 1) & (ss >= 3)
    first = torch.where(ss == 0, c, torch.where(ss == 1, 0.0, NEG))
    alpha = lp[:, 0] + first
    for y in range(1, T_y):
        adv = _shift(alpha, 1) + torch.where(even, c, 0.0)
        skip = torch.where(skip_ok, _shift(alpha, 2), NEG)
        nxt = lp[:, y] + torch.logaddexp(torch.logaddexp(alpha, adv), skip)
        alpha = torch.where((t_y > y)[:, None], nxt, alpha)
    n_s = 2 * t_x + 1
    ends = (ss[None, :] == (n_s - 1)[:, None]) | \
        (ss[None, :] == (n_s - 2)[:, None])
    return -torch.logsumexp(torch.where(ends, alpha, NEG), dim=1)
