"""Skip-state lattice DPs, the primitive behind implicit pause modelling
(port of aligner_tpu/ops/skip_dp.py).

An optional shared pause state is interleaved between text tokens
(T_s = 2*t_x + 1 states: even s a pause, odd s token (s-1)//2) and the
column DP gains a skip move that hops over a pause, so every alignment
decides per gap whether a pause absorbs frames, with no silence tokens in
the transcript. The transition rules are in `ops/skip_dp_reference.py`.
Two DPs share the structure:

* `mas_skip_path_frame_major`: Viterbi, the hard path (kernel H4);
* `forward_sum_skip_loss`: the marginal NLL with its analytic gradient,
  the posterior occupancy from one beta sweep (kernels H5 and H6).

On a CUDA tensor they run as the kernels of `csrc/skip_dp.cu`, on a CPU
tensor as their plain PyTorch versions (`ops/skip_dp_kernel.py`).

Layouts match the plain ops: the Viterbi wrapper of `skip_dp_kernel`
takes state-major [B, T_s, T_y], everything here frame-major
[B, T_y, T_s]. t_x is the token count per item. Items outside
1 <= t_x <= t_y, or with more states than the lattice has, get an
all-zero path, a loss of 0 and a zero gradient.
"""
from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from .forward_sum import _masked_logp
from .forward_sum_kernel import NEG
from .skip_dp_kernel import (forward_sum_skip_alpha, forward_sum_skip_grad,
                             mas_skip_path)
from .skip_dp_reference import MAX_NEG_VAL, n_states

__all__ = ["expand_prior_to_states", "expand_tokens_with_pauses",
           "forward_sum_skip_loss", "mas_skip_path_frame_major", "n_states",
           "skip_posteriors", "split_state_durations"]


def _valid_items_skip(t_x: torch.Tensor, t_y: torch.Tensor,
                      T_s: int) -> torch.Tensor:
    return (t_x >= 1) & (t_x <= t_y) & (n_states(t_x) <= T_s)


def _total_from_alphas_skip(final_col: torch.Tensor,
                            t_x: torch.Tensor) -> torch.Tensor:
    """Log-marginal per item: logsumexp of the frozen final alpha column
    over the two end states, the last token and the trailing pause."""
    ss = torch.arange(final_col.shape[1], device=final_col.device)[None, :]
    ts = n_states(t_x)[:, None]
    pick = (ss == ts - 1) | (ss == ts - 2)
    return torch.logsumexp(torch.where(pick, final_col, NEG), dim=1)


def _skip_sweeps(log_probs, t_x, t_y, enter_cost, *, posteriors: bool):
    """(lp_tm, alphas, total, t_x, t_y, valid, gamma or None) on
    log_probs' device; total is 0 for invalid items, which keeps the exp
    of the beta sweep from overflowing."""
    t_x = t_x.to(log_probs.device)
    t_y = t_y.to(log_probs.device)
    lp_tm = _masked_logp(log_probs.to(torch.float32),
                         n_states(t_x)).transpose(0, 1)
    alphas, final = forward_sum_skip_alpha(lp_tm, t_y, enter_cost)
    valid = _valid_items_skip(t_x, t_y, log_probs.shape[2])
    total = torch.where(valid, _total_from_alphas_skip(final, t_x), 0.0)
    gamma = (forward_sum_skip_grad(lp_tm, alphas, total, t_x, t_y,
                                   enter_cost) if posteriors else None)
    return lp_tm, alphas, total, t_x, t_y, valid, gamma


class _ForwardSumSkipLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, log_probs, t_x, t_y, enter_cost):
        lp_tm, alphas, total, t_x, t_y, valid, _ = _skip_sweeps(
            log_probs, t_x, t_y, enter_cost, posteriors=False)
        ctx.save_for_backward(lp_tm, alphas, total, t_x, t_y, valid)
        ctx.enter_cost = enter_cost
        ctx.dtype = log_probs.dtype
        return -total

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        lp_tm, alphas, total, t_x, t_y, valid = ctx.saved_tensors
        gamma = forward_sum_skip_grad(lp_tm, alphas, total, t_x, t_y,
                                      ctx.enter_cost)
        # d(-total)/d logp = -gamma, chained with the per-item cotangent;
        # an invalid item's gamma is not meaningful and is dropped.
        grad_lp = torch.where(valid[:, None, None],
                              -gamma.transpose(0, 1) * grad[:, None, None],
                              0.0)
        return grad_lp.to(ctx.dtype), None, None, None


def forward_sum_skip_loss(log_probs: torch.Tensor, t_x: torch.Tensor,
                          t_y: torch.Tensor,
                          enter_cost: float = 0.0) -> torch.Tensor:
    """NLL of the pause-optional monotonic alignment marginal.

    log_probs: [B, T_y, T_s] frame-major over expanded states (T_s >=
    2*max(t_x)+1), log-softmax over states (+ prior); -inf-safe. t_x is
    the token count per item. Returns the per-item loss [B]; invalid
    items give 0 with a zero gradient. enter_cost: log-cost per pause
    entered; the gradient stays -gamma, the posterior occupancy under the
    penalised model.
    """
    return _ForwardSumSkipLoss.apply(log_probs, t_x, t_y, float(enter_cost))


def skip_posteriors(log_probs: torch.Tensor, t_x: torch.Tensor,
                    t_y: torch.Tensor):
    """Posterior state occupancy gamma [B, T_y, T_s] and the log-marginal
    [B] (diagnostics; no gradient)."""
    with torch.no_grad():
        *_, total, _, _, valid, gamma = _skip_sweeps(
            log_probs, t_x, t_y, 0.0, posteriors=True)
        gamma = torch.where(valid[:, None, None], gamma.transpose(0, 1), 0.0)
    return gamma, total


def mas_skip_path_frame_major(logp: torch.Tensor, t_x, t_y, *,
                              max_neg_val: float = MAX_NEG_VAL,
                              enter_cost: float = 0.0) -> torch.Tensor:
    """Hard pause-aware path in frame-major layout: logp [B, T_y, T_s] ->
    f32 0/1 path [B, T_y, T_s]. The kernel reads the lattice through its
    strides, so neither side is transposed in memory."""
    return mas_skip_path(logp.to(torch.float32).transpose(1, 2), t_x, t_y,
                         max_neg_val=max_neg_val, enter_cost=enter_cost,
                         frame_major=True)


def expand_tokens_with_pauses(tokens: torch.Tensor,
                              text_lengths: torch.Tensor, pause_id: int):
    """tokens [B, T_x] -> expanded ids [B, 2*T_x+1]: `pause_id` at even
    slots, token j at slot 2j+1, zeros past each item's 2*t_x+1 states."""
    B, T_x = tokens.shape
    T_s = 2 * T_x + 1
    ss = torch.arange(T_s, device=tokens.device)[None, :]
    ts = n_states(text_lengths.to(tokens.device))[:, None]
    exp = torch.full((B, T_s), pause_id, dtype=tokens.dtype,
                     device=tokens.device)
    exp[:, 1::2] = tokens
    return torch.where(ss < ts, exp, 0)


def split_state_durations(state_durations: torch.Tensor):
    """[B, T_s] per-state frame counts -> (token durations [B, T_x],
    pause durations [B, T_x+1]); pause j precedes token j."""
    return state_durations[:, 1::2], state_durations[:, 0::2]


def expand_prior_to_states(log_prior: torch.Tensor, t_x: torch.Tensor,
                           mode: str = "inherit") -> torch.Tensor:
    """Map a token-axis prior [B, T_y, T_x] onto the expanded state axis
    [B, T_y, 2*T_x+1].

    mode="inherit": state s takes the prior of token min(s // 2, t_x - 1),
    so a pause shares its following token's prior (the trailing pause its
    preceding token's).

    mode="bridge": token states keep their own prior; the pause between
    tokens j-1 and j gets logaddexp(prior[j-1], prior[j]) - log 2, a
    smooth bridge over both neighbours' diagonal peaks, so a pause is not
    pinned to one side of its gap. Edge pauses reduce to plain inheritance
    through the index clamps."""
    if mode not in ("inherit", "bridge"):
        raise ValueError(f"unknown pause-prior mode: {mode!r}")
    B, T_y, T_x = log_prior.shape
    T_s = 2 * T_x + 1
    ss = torch.arange(T_s, device=log_prior.device)[None, :]
    last = (t_x.to(log_prior.device).long()[:, None] - 1).clamp(min=0)
    idx = torch.minimum(ss // 2, last)
    inherit = log_prior.gather(2, idx[:, None, :].expand(B, T_y, T_s))
    if mode == "inherit":
        return inherit
    # the previous token's prior: token (s // 2) - 1, clamped into range
    idx_prev = torch.minimum((ss // 2 - 1).clamp(min=0), last)
    prev = log_prior.gather(2, idx_prev[:, None, :].expand(B, T_y, T_s))
    bridge = torch.logaddexp(inherit, prev) - math.log(2.0)
    return torch.where((ss % 2 == 0)[:, None, :], bridge, inherit)
