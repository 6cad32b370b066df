"""MoBoAligner: monotonic boundary search with a max-duration constraint
(port of aligner_tpu/ops/mobo.py; arXiv 2005.08528).

Token i's boundary b_i lies at most D frames after b_{i-1}. In the log
domain, on frames 0..t_y-1 with a virtual boundary b_{-1} = -1 and the
final boundary pinned at t_y - 1:

    transition  log w_i(t' -> t'+d) = e_i(t'+d) - logsumexp_{d'<=D} e_i(t'+d')
    forward     logB_i(t) = e_i(t) + logsumexp_{d=1..D} [logB_{i-1}(t-d)
                                                         - z_i(t-d)]
    posterior   P(b_i = t | b_last = t_y-1) = exp(logB_i + logbeta_i - total)
    alignment   gamma[i, t] = F_{i-1}(t-1) - F_i(t-1)   (posterior CDFs)

The recursions are sequential in text tokens. On a CUDA tensor the
forward sweep is kernel H7, the backward sweep kernel H9 and the hard
(Viterbi) sweep with its walk kernel H8 (`ops/mobo_kernel.py`,
`csrc/mobo.cu`), at every shape the kernels accept; on a CPU tensor each
runs as its plain PyTorch version. The kernels are never differentiated:
`mobo_forward` and `mobo_loss` carry the JAX package's analytic adjoints
as `torch.autograd.Function`s, in plain PyTorch as there (the adjoint is
no kernel in the JAX package either). The posterior/CDF arithmetic after
the sweeps is left to autograd.

Layout: energies are frame-major [B, T_y, T_x]; t_x, t_y are per-item
lengths; the sweeps run on the token-major shifted grid of
`_prep_energies`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .mobo_kernel import (NEG, _sb, _window_lse, _window_normalizer,
                          mobo_alpha, mobo_beta, mobo_bp)


def _prep_energies(energies: torch.Tensor, t_x: torch.Tensor,
                   t_y: torch.Tensor) -> torch.Tensor:
    """energies [B, T_y, T_x] -> token-major [T_x, B, T_y+1] with padding
    frames masked to NEG and a NEG column prepended (the slot of the
    virtual frame -1)."""
    T_y = energies.shape[1]
    ys = torch.arange(T_y, device=energies.device)
    e = torch.where(ys[None, :, None] < t_y[:, None, None],
                    energies.to(torch.float32), NEG)
    return F.pad(e.permute(2, 0, 1), (1, 0), value=NEG)


def _lengths(energies: torch.Tensor, t_x, t_y):
    dev = energies.device
    return (torch.as_tensor(t_x).to(dev), torch.as_tensor(t_y).to(dev))


def _total_from_logB(logB: torch.Tensor, t_y: torch.Tensor) -> torch.Tensor:
    """log P(b_{t_x-1} = t_y-1): the frozen final carry at the shifted end
    position t_y."""
    final = logB[-1]
    pos = torch.arange(final.shape[1], device=final.device)
    onehot = (pos[None, :] == t_y[:, None]).to(final.dtype)
    return (final * onehot).sum(dim=1)


def _windows(x: torch.Tensor, D: int, forward: bool) -> torch.Tensor:
    """[..., T] -> a view [..., T, D] of the zero-padded x: column k holds
    x(t + 1 + k) when `forward`, else x(t - D + k), i.e. d = D - k."""
    padded = F.pad(x, (0, D) if forward else (D, 0))
    win = padded.unfold(-1, D + 1, 1)
    return win[..., 1:] if forward else win[..., :D]


def _mobo_ab_adjoint(e_tm, logB, betas, t_x, t_y, D, abar, bbar, tbar):
    """Adjoint of (logB, betas, total) in e_tm: the JAX package's
    `_mobo_ab_bwd` with every mask of its `astep` and `bstep`, each
    window gathered once (`_windows`) and reduced over the window axis.

    The softmax weights of both chains depend on the saved stacks alone,
    so they are computed for all tokens at once ([T_x, B, T_y1, D]
    tensors); only the cotangent carry walks the tokens, a few operations
    per token. The sums run over the window axis in one reduction, another
    order than the reference's d-ascending accumulation."""
    T_x, B, n = e_tm.shape
    dev = e_tm.device
    xs = torch.arange(T_x, device=dev)[:, None, None]
    pos = torch.arange(n, device=dev)
    tx = t_x[None, :, None]

    # total is the gather of the frozen final carry at position t_y.
    abar = abar.clone()
    abar[-1] += (pos[None, :] == t_y[:, None]).to(e_tm.dtype) * tbar[:, None]

    # ----- alpha chain, tokens T_x-1 .. 0 -----
    init_row = torch.full((1, B, n), NEG, dtype=e_tm.dtype, device=dev)
    init_row[..., 0] = 0.0
    alpha_prev = torch.cat([init_row, logB[:-1]], dim=0)
    live = xs < tx                                        # [T_x, B, 1]
    valid = (logB > 0.5 * NEG) & live
    z = _window_normalizer(e_tm, D)
    A = torch.where(z > 0.5 * NEG, alpha_prev - z, NEG)
    inner = logB - e_tm                    # only meaningful where `valid`
    ok = (A > 0.5 * NEG)[..., None] & _windows(valid, D, True)
    # w(q, d) = exp(A(q) - inner(q + d)), 0 off the live arcs
    w = torch.exp(torch.where(ok, A[..., None] - _windows(inner, D, True),
                              NEG))
    # u_l keeps D zeros after each row, so its windows need no padding.
    u_pad = e_tm.new_zeros((T_x, B, n + D))
    u_l = u_pad[..., :n]
    cprev = torch.empty_like(e_tm)
    cbar = e_tm.new_zeros((B, n))
    zero = e_tm.new_zeros(())
    for i in range(T_x - 1, -1, -1):
        u = abar[i] + cbar
        torch.where(valid[i], u, zero, out=u_l[i])
        torch.sum(u_pad[i].unfold(-1, D + 1, 1)[..., 1:] * w[i], -1,
                  out=cprev[i])
        cbar = torch.where(live[i], cprev[i], u)          # frozen: pass on
    del w, ok
    zb = _windows(-cprev, D, False)                       # zbar(p - d)
    v = torch.exp(torch.where(zb != 0.0,
                              e_tm[..., None] - _windows(z, D, False), NEG))
    grad = torch.where(live, u_l + (zb * v).sum(-1), 0.0)
    del zb, v
    if T_x < 2:
        return grad

    # ----- beta chain, tokens 0 .. T_x-2; step i writes token i + 1 -----
    beta_i, bnext, enext = betas[:-1], betas[1:], e_tm[1:]
    xs = xs[:-1]
    pinned = xs == tx - 1
    dead = xs >= tx
    valid = (beta_i > 0.5 * NEG) & ~pinned & ~dead
    z_n = z[1:]
    inner = beta_i + z_n                   # only meaningful where `valid`
    enext_ok = enext > 0.5 * NEG
    valid_b = _windows(valid, D, False)
    ok = (enext_ok & (bnext > 0.5 * NEG))[..., None] & valid_b
    s = torch.exp(torch.where(
        ok, (enext + bnext)[..., None] - _windows(inner, D, False), NEG))
    u_pad = e_tm.new_zeros((T_x - 1, B, D + n))           # D zeros before
    u_l = u_pad[..., D:]
    u_win = u_pad.unfold(-1, D + 1, 1)[..., :D]           # u_l(q - d)
    co = torch.empty_like(beta_i)
    carry = e_tm.new_zeros((B, n))
    for i in range(T_x - 1):
        u = bbar[i] + carry
        torch.where(valid[i], u, zero, out=u_l[i])
        torch.sum(u_win[i] * s[i], -1, out=co[i])
        # A pinned token has no valid cell, so its co is already zero.
        carry = torch.where(dead[i], u, co[i])
    del s
    ok = valid_b & _windows(z_n > 0.5 * NEG, D, False) & enext_ok[..., None]
    ve = (u_win * torch.exp(torch.where(
        ok, enext[..., None] - _windows(z_n, D, False), NEG))).sum(-1)
    grad[1:] += co - ve                    # already zero off the live rows
    return grad


class _MoBoAB(torch.autograd.Function):
    """(logB stack, beta stack, log-total), differentiable in e_tm by the
    analytic adjoint; cotangents on all three outputs are honoured."""

    @staticmethod
    def forward(ctx, e_tm, t_x, t_y, D):
        logB = mobo_alpha(e_tm, t_x, D)
        betas = mobo_beta(e_tm, t_x, t_y, D)
        total = _total_from_logB(logB, t_y)
        ctx.save_for_backward(e_tm, logB, betas, t_x, t_y)
        ctx.D = D
        return logB, betas, total

    @staticmethod
    @once_differentiable
    def backward(ctx, abar, bbar, tbar):
        e_tm, logB, betas, t_x, t_y = ctx.saved_tensors
        grad = _mobo_ab_adjoint(e_tm, logB, betas, t_x, t_y, ctx.D, abar,
                                bbar, tbar)
        return grad, None, None, None


def _posteriors_from_ab(logB, betas, total, t_x, t_y):
    T_x, B, n = logB.shape
    T_y = n - 1
    dev = logB.device
    # Posterior boundary marginals on the shifted grid.
    log_post = logB + betas - total[None, :, None]
    xs = torch.arange(T_x, device=dev)
    live = xs[:, None, None] < t_x[None, :, None]
    # Dead tokens i >= t_x are zeroed here (their raw posteriors are
    # pass-through carries, not zeros).
    post = torch.where(live, torch.exp(log_post), 0.0)    # [T_x, B, T_y1]

    # CDFs F_i(t) = P(b_i <= t) on the shifted grid; F_{-1} = 1 everywhere.
    cdf = torch.cumsum(post, dim=2)
    cdf_prev = torch.cat([torch.ones_like(cdf[:1]), cdf[:-1]], dim=0)
    gamma = (cdf_prev - cdf)[:, :, :-1]    # P(b_{i-1} <= t-1) - P(b_i <= t-1)
    # clip(gamma, 0, 1) as a max and a min, whose gradients split a tie
    # evenly as jnp.clip's do (torch.clamp passes it whole).
    gamma = torch.minimum(torch.maximum(gamma, gamma.new_zeros(())),
                          gamma.new_ones(()))
    ys = torch.arange(T_y, device=dev)
    gamma = torch.where(ys[None, None, :] < t_y[None, :, None], gamma, 0.0)
    return {
        "loss": -total,
        "log_boundaries": log_post[:, :, 1:].transpose(0, 1),  # [B,T_x,T_y]
        "soft_alignment": gamma.permute(1, 2, 0),              # [B,T_y,T_x]
        "expected_durations": gamma.sum(dim=2).T,              # [B, T_x]
    }


def mobo_forward(energies: torch.Tensor, t_x, t_y, max_duration: int):
    """Soft MoBo alignment (differentiable).

    energies: [B, T_y, T_x] (frame-major, matching the OTA layout);
    t_x, t_y: [B] int; max_duration: the window D >= 1. An item with
    t_y > t_x * D has no boundary sequence: its loss is about 1e15 and its
    posteriors are sentinels.

    Returns dict:
      loss            [B]  negative log P(final boundary at t_y - 1)
      log_boundaries  [B, T_x, T_y]  posterior log P(b_i = t)
      soft_alignment  [B, T_y, T_x]  gamma, P(token i active at frame t)
      expected_durations [B, T_x]

    Differentiable through every output: the alpha/beta sweeps run as
    kernels H7 and H9 on a CUDA tensor under `_MoBoAB`'s analytic
    adjoint; the posterior/CDF arithmetic is left to autograd.
    """
    t_x, t_y = _lengths(energies, t_x, t_y)
    e_tm = _prep_energies(energies, t_x, t_y)
    logB, betas, total = _MoBoAB.apply(e_tm, t_x, t_y, int(max_duration))
    return _posteriors_from_ab(logB, betas, total, t_x, t_y)


class _MoBoLogMarginal(torch.autograd.Function):
    """log P(b_{t_x-1} = t_y - 1) with the analytic gradient

        d total / d e_i(t) = xi_i(t) - sum_d xi_{i-1}(t-d) exp(e_i(t)
                                                              - z_i(t-d))

    (the posterior boundary marginal minus the expected window-softmax
    mass): one beta sweep (H9) and D shifted accumulations."""

    @staticmethod
    def forward(ctx, energies, t_x, t_y, D):
        e_tm = _prep_energies(energies, t_x, t_y)
        logB = mobo_alpha(e_tm, t_x, D)
        total = _total_from_logB(logB, t_y)
        ctx.save_for_backward(e_tm, logB, total, t_x, t_y)
        ctx.D = D
        ctx.dtype = energies.dtype
        return total

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        e_tm, logB, total, t_x, t_y = ctx.saved_tensors
        D = ctx.D
        T_x, B, n = e_tm.shape
        dev = e_tm.device
        betas = mobo_beta(e_tm, t_x, t_y, D)
        log_xi = logB + betas - total[None, :, None]      # [T_x, B, T_y1]
        # log xi_{i-1}: the virtual boundary xi_{-1} = delta(p = 0).
        xi_init = torch.full((1, B, n), NEG, dtype=e_tm.dtype, device=dev)
        xi_init[..., 0] = 0.0
        log_xi_prev = torch.cat([xi_init, log_xi[:-1]], dim=0)
        z = _window_normalizer(e_tm, D)
        a = torch.where(z > 0.5 * NEG, log_xi_prev - z, NEG)
        acc = _window_lse(a, D, _sb)
        xs = torch.arange(T_x, device=dev)
        live = xs[:, None, None] < t_x[None, :, None]
        xi = torch.where(live, torch.exp(log_xi), 0.0)
        c = torch.where(live, torch.exp(e_tm + acc), 0.0)
        grad_tm = (xi - c) * g[None, :, None]
        # back to [B, T_y, T_x], dropping the virtual frame -1 column
        return (grad_tm[:, :, 1:].permute(1, 2, 0).to(ctx.dtype), None, None,
                None)


def mobo_log_marginal(energies: torch.Tensor, t_x, t_y,
                      max_duration: int) -> torch.Tensor:
    """The MoBo log-marginal [B], differentiable in energies."""
    t_x, t_y = _lengths(energies, t_x, t_y)
    return _MoBoLogMarginal.apply(energies, t_x, t_y, int(max_duration))


def mobo_loss(energies: torch.Tensor, t_x, t_y,
              max_duration: int) -> torch.Tensor:
    """Mean per-frame MoBo NLL (differentiable, analytic gradient)."""
    t_x, t_y = _lengths(energies, t_x, t_y)
    total = mobo_log_marginal(energies, t_x, t_y, max_duration)
    return torch.mean(-total / t_y.clamp(min=1))


@torch.no_grad()
def mobo_hard_boundaries(energies: torch.Tensor, t_x, t_y,
                         max_duration: int):
    """Viterbi mode: the most likely boundary sequence under the same
    max-duration-constrained model (kernel H8 on a CUDA tensor, walk
    included). Returns (durations [B, T_x] int32, path [B, T_y, T_x]
    float32 0/1); it takes no gradient."""
    T_y = energies.shape[1]
    t_x, t_y = _lengths(energies, t_x, t_y)
    e_tm = _prep_energies(energies, t_x, t_y)
    _, durations = mobo_bp(e_tm, t_x, t_y, int(max_duration))
    # Token i covers frames [cum_{i-1}, cum_i).
    cum = torch.cumsum(durations, dim=1)                  # [B, T_x]
    start = cum - durations
    ys = torch.arange(T_y, device=energies.device)[None, :, None]
    path = ((ys >= start[:, None, :]) & (ys < cum[:, None, :])
            & (ys < t_y[:, None, None]))
    return durations, path.to(torch.float32)
