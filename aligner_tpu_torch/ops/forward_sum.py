"""Forward-sum (CTC-style) alignment loss and its gradient (port of
aligner_tpu/ops/forward_sum.py).

The negative marginal log-likelihood of all monotonic, surjective
text-to-mel alignments, the OTA objective (arXiv 2108.10447):

    alpha[x, y] = logp[x, y] + logaddexp(alpha[x, y-1], alpha[x-1, y-1])
    alpha[0, 0] = logp[0, 0];   loss = -alpha[t_x-1, t_y-1]

The gradient is the classical forward/backward one: a beta sweep gives
the posterior occupancy gamma = exp(alpha + beta - total), and
d loss / d logp = -gamma. On a CUDA tensor the alpha sweep is kernel H2
and the beta sweep kernel H3; on a CPU tensor both run as their plain
PyTorch versions (`ops/forward_sum_kernel.py`).

`alignment_posteriors` returns the posteriors with the log-marginal from
the same two sweeps.

Layout: log_probs are frame-major [B, T_y, T_x] (log-softmax over the text
axis); t_x, t_y are per-item lengths.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .forward_sum_kernel import NEG, forward_sum_alpha, forward_sum_grad


def _masked_logp(log_probs: torch.Tensor, t_x: torch.Tensor) -> torch.Tensor:
    """NEG at text positions x >= t_x, and caller values clamped to >= NEG
    so that -inf-masked log-probs become the finite sentinel."""
    T_x = log_probs.shape[2]
    xs = torch.arange(T_x, device=log_probs.device)
    log_probs = log_probs.clamp(min=NEG)
    return torch.where(xs[None, None, :] < t_x[:, None, None], log_probs,
                       NEG)


def _valid_items(t_x: torch.Tensor, t_y: torch.Tensor) -> torch.Tensor:
    """Items outside 1 <= t_x <= t_y have no monotonic surjective
    alignment; their loss is defined as 0."""
    return (t_x >= 1) & (t_x <= t_y)


def _total_from_alphas(final_col: torch.Tensor,
                       t_x: torch.Tensor) -> torch.Tensor:
    """Log-marginal per item: the frozen final alpha column at t_x - 1."""
    xs = torch.arange(final_col.shape[1], device=final_col.device)
    onehot = (xs[None, :] == t_x[:, None] - 1).to(final_col.dtype)
    return (final_col * onehot).sum(dim=1)


def _forward_sweeps(log_probs, t_x, t_y, *, posteriors: bool):
    """(lp_tm, alphas, total, t_x, t_y, gamma or None) on log_probs'
    device; total is 0 for invalid items, which keeps the exp of the
    beta sweep from overflowing."""
    t_x = t_x.to(log_probs.device)
    t_y = t_y.to(log_probs.device)
    lp_tm = _masked_logp(log_probs.to(torch.float32), t_x).transpose(0, 1)
    alphas, final = forward_sum_alpha(lp_tm, t_y)
    total = torch.where(_valid_items(t_x, t_y),
                        _total_from_alphas(final, t_x), 0.0)
    gamma = (forward_sum_grad(lp_tm, alphas, total, t_x, t_y)
             if posteriors else None)
    return lp_tm, alphas, total, t_x, t_y, gamma


class _ForwardSumLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, log_probs, t_x, t_y):
        lp_tm, alphas, total, t_x, t_y, _ = _forward_sweeps(
            log_probs, t_x, t_y, posteriors=False)
        ctx.save_for_backward(lp_tm, alphas, total, t_x, t_y)
        ctx.dtype = log_probs.dtype
        return -total

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        lp_tm, alphas, total, t_x, t_y = ctx.saved_tensors
        g = torch.where(_valid_items(t_x, t_y), grad, 0.0)
        gamma = forward_sum_grad(lp_tm, alphas, total, t_x, t_y)
        # d(-total)/d logp = -gamma, chained with the per-item cotangent.
        grad_lp = -gamma.transpose(0, 1) * g[:, None, None]
        return grad_lp.to(ctx.dtype), None, None


class _ForwardSumWithPosteriors(torch.autograd.Function):

    @staticmethod
    def forward(ctx, log_probs, t_x, t_y):
        *_, total, t_x, t_y, gamma = _forward_sweeps(
            log_probs, t_x, t_y, posteriors=True)
        valid = _valid_items(t_x, t_y)
        gamma = torch.where(valid[:, None, None], gamma.transpose(0, 1), 0.0)
        ctx.mark_non_differentiable(gamma)
        ctx.save_for_backward(gamma)
        ctx.dtype = log_probs.dtype
        return -total, gamma

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_loss, grad_gamma):
        # gamma's cotangent is dropped: the posteriors are not
        # differentiable, and they are already the loss gradient.
        gamma, = ctx.saved_tensors
        return (-gamma * grad_loss[:, None, None]).to(ctx.dtype), None, None


def forward_sum_loss(log_probs: torch.Tensor, t_x: torch.Tensor,
                     t_y: torch.Tensor) -> torch.Tensor:
    """Negative marginal log-likelihood of all monotonic alignments.

    log_probs: [B, T_y, T_x], log-softmax over the text axis (+ any
    prior); -inf-masked inputs are safe. t_x, t_y: [B] int with
    1 <= t_x <= t_y per item; other items get a loss of 0 and a zero
    gradient. Returns the per-item loss [B] (a sum over frames).
    """
    return _ForwardSumLoss.apply(log_probs, t_x, t_y)


def forward_sum_loss_with_posteriors(log_probs: torch.Tensor,
                                     t_x: torch.Tensor, t_y: torch.Tensor):
    """(loss [B], gamma [B, T_y, T_x]) from one forward-backward sweep.

    gamma is the alignment posterior, which is also the loss gradient up
    to its sign, so the backward reuses it with no further sweep. gamma
    itself is not differentiable; it is 0 for invalid items.
    """
    return _ForwardSumWithPosteriors.apply(log_probs, t_x, t_y)


class _AlignmentPosteriors(torch.autograd.Function):

    @staticmethod
    def forward(ctx, log_probs, t_x, t_y):
        *_, total, t_x, t_y, gamma = _forward_sweeps(
            log_probs, t_x, t_y, posteriors=True)
        valid = _valid_items(t_x, t_y)
        gamma = torch.where(valid[:, None, None], gamma.transpose(0, 1), 0.0)
        # A cotangent that never reaches gamma stays None, so that only a
        # gradient through gamma itself is refused below.
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(gamma)
        ctx.dtype = log_probs.dtype
        return gamma, total

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_gamma, grad_total):
        if grad_gamma is not None:
            raise RuntimeError(
                "alignment_posteriors: a gradient through gamma needs a "
                "second-order forward-backward sweep, which has no kernel; "
                "only the log-marginal `total` is differentiable (its "
                "gradient is gamma)")
        if grad_total is None:
            return None, None, None
        gamma, = ctx.saved_tensors
        return (gamma * grad_total[:, None, None]).to(ctx.dtype), None, None


def alignment_posteriors(log_probs: torch.Tensor, t_x: torch.Tensor,
                         t_y: torch.Tensor):
    """Soft alignment posteriors and the per-item log-marginal.

    Returns (gamma [B, T_y, T_x] float32, whose rows sum to 1 over the
    text for each real frame and which is 0 outside each item's t_x x t_y
    range, total [B]). Items outside 1 <= t_x <= t_y get gamma 0 and
    total 0. On a CUDA tensor the sweeps are kernels H2 and H3.

    `total` is differentiable, with gamma as its gradient. A gradient
    through gamma raises: it would need a second-order sweep (the JAX
    function gets one from autodiff over its lax scans).
    """
    return _AlignmentPosteriors.apply(log_probs, t_x, t_y)
