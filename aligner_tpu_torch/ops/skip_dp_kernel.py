"""Skip-state (implicit-pause) sweeps on the card and their plain PyTorch
versions (`csrc/skip_dp.cu`), counterpart of
aligner_tpu/ops/skip_dp_pallas.py:

* kernel H4, the pause-aware Viterbi (forward moves, start-state choice
  and walk in one launch), counterpart of mas_skip_pallas; plain version
  `mas_skip_plain`, the port of `mas_skip_lax`. It launches with
  `_skip_viterbi_plan`'s threads, cells per thread, ring of value rows
  fetched ahead (in tiles of 8 frames where the lattice's frames are
  contiguous), and the place of its move planes (shared memory where
  they fit, else a scratch in device memory);
* kernel H5, the skip forward-sum alpha sweep, counterpart of
  forward_sum_skip_alpha_pallas (its per-frame form); plain version
  `alpha_skip_plain`, the port of `_alpha_scan_skip`;
* kernel H6, the beta sweep that emits the posterior gamma, counterpart
  of forward_sum_skip_gamma_pallas; plain version `gamma_skip_plain`,
  the recursion of `_beta_scan_skip` in the message form of
  `_gamma_skip_kernel`.

The lattice has T_s = 2*t_x + 1 states per item (see
`ops/skip_dp_reference.py` for the transition rules). A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises. An item
whose 2*t_x + 1 exceeds the lattice's state axis counts as invalid, like
t_x < 1 or t_x > t_y: it gets an all-zero path (the JAX package reads a
clamped state there without saying so).
"""
from __future__ import annotations

import torch

from .. import _build
from .forward_sum_kernel import (MAX_THREADS, NEG, _check_grad_inputs,
                                 _gamma_out, _sweep_plan)
from .forward_sum_kernel import _check_lattice as _check_frame_major
from .mas_kernel import _check_lattice as _check_state_major
from .mas_kernel import _on_cuda
from .skip_dp_reference import MAX_NEG_VAL, n_states

KERNEL = "mas_skip_kernel"
ALPHA_KERNEL = "forward_sum_skip_alpha_kernel"
GAMMA_KERNEL = "forward_sum_skip_gamma_kernel"

MAX_SMEM = 232448             # a block's opt-in shared memory on the H100
# (cells per thread, ring depth, where the move planes live, how value
# rows are fetched) of H4, the plans `with_skip_plan` in csrc/skip_dp.cu
# builds, in order of preference. "tiles" (a ring of 32 frames; each warp
# copies 8 frames x 4 states an instruction) serves lattices whose frames
# are contiguous, such as serving's state-major [B, T_s, T_y]; "rows" (a
# ring of 8 or 4 frames; each thread copies its own cell of a frame) any
# other, such as the pause model's frame-major view. For each cell count:
# the planes in shared memory, behind the deeper ring first, then in
# device memory.
SKIP_VITERBI_PLANS = (
    (1, 32, "shared", "tiles"), (1, 32, "global", "tiles"),
    (1, 8, "shared", "rows"), (1, 4, "shared", "rows"),
    (1, 8, "global", "rows"),
    (2, 8, "shared", "rows"), (2, 4, "shared", "rows"),
    (2, 8, "global", "rows"),
    (4, 8, "shared", "rows"), (4, 4, "shared", "rows"),
    (4, 8, "global", "rows"),
    (8, 4, "shared", "rows"), (8, 4, "global", "rows"))


def _skip_viterbi_smem(pitch: int, ring: int, plane_frames: int) -> int:
    """H4's shared-memory bytes for threads holding `pitch` cells: the
    move planes of `plane_frames` frames (two 32-bit words per 32 cells a
    frame), `ring` value rows of pitch + 4 floats and two columns behind
    two pad cells each (csrc/skip_dp.cu: skip_viterbi_smem)."""
    return 8 * (pitch // 32) * plane_frames + 4 * (ring * (pitch + 4)
                                                   + 2 * (pitch + 2))


def _skip_viterbi_plan(T_s: int, T_y: int, frames_contiguous: bool
                       ) -> tuple[int, int, int, str, str, int]:
    """(threads, cells per thread, ring depth, planes, fetch,
    shared-memory bytes) of H4 over T_s states and T_y frames: the first
    plan of SKIP_VITERBI_PLANS whose cells cover the column with at most
    MAX_THREADS threads, whose fetch suits the lattice ("tiles" only where
    its frames are contiguous) and whose layout fits a block's shared
    memory, with the fewest threads, a multiple of 32, that cover the
    column. planes is "shared" or "global" (an int32 scratch
    [B, T_y, pitch / 16] in device memory). Chosen from the shape and
    strides alone, before the launch. Raises ValueError past 8192
    states."""
    for cells, ring, planes, fetch in SKIP_VITERBI_PLANS:
        if cells * MAX_THREADS < T_s or (fetch == "tiles"
                                         and not frames_contiguous):
            continue
        threads = 32 * -(-T_s // (32 * cells))
        smem = _skip_viterbi_smem(threads * cells, ring,
                                  T_y if planes == "shared" else 0)
        if smem <= MAX_SMEM:
            return threads, cells, ring, planes, fetch, smem
    raise ValueError(f"the skip Viterbi takes at most "
                     f"{SKIP_VITERBI_PLANS[-1][0] * MAX_THREADS} states, "
                     f"got {T_s}")


def _shift_right(col: torch.Tensor, n: int, fill: float) -> torch.Tensor:
    """col[:, s - n] at s, `fill` where s < n."""
    pad = col.new_full((col.shape[0], n), fill)
    return torch.cat([pad, col], dim=1)[:, :col.shape[1]]


def _shift_left(col: torch.Tensor, n: int, fill: float) -> torch.Tensor:
    """col[:, s + n] at s, `fill` past the end."""
    pad = col.new_full((col.shape[0], n), fill)
    return torch.cat([col, pad], dim=1)[:, n:]


def mas_skip_plain(value: torch.Tensor, t_x, t_y, *,
                   max_neg_val: float = MAX_NEG_VAL,
                   enter_cost: float = 0.0) -> torch.Tensor:
    """Batched pause-aware Viterbi paths in plain PyTorch, on any device.

    value: f32 [B, T_s, T_y] (state-major); t_x (token counts), t_y: [B]
    int. Returns f32 0/1 paths [B, T_s, T_y], bit-identical to
    `mas_skip_single`; invalid items get all zeros.
    """
    t_x, t_y = _check_state_major(value, t_x, t_y)
    B, T_s, T_y = value.shape
    dev = value.device
    path = torch.zeros((B, T_s, T_y), dtype=torch.float32, device=dev)
    if path.numel() == 0:
        return path
    neg, c = float(max_neg_val), float(enter_cost)
    ss = torch.arange(T_s, device=dev)
    ts = n_states(t_x.long())
    ty = t_y.long()[:, None]
    live = ss < ts[:, None]
    even = ss % 2 == 0
    can_skip = (ss % 2 == 1) & (ss >= 3)

    col0 = value[:, :, 0]
    prev = torch.where((ss <= 1) & live,
                       torch.where(ss == 0, col0 + c, col0), neg)
    moves = torch.zeros((T_y, B, T_s), dtype=torch.int8, device=dev)
    for y in range(1, T_y):
        p1 = _shift_right(prev, 1, neg)
        # the cost before the s == 0 mask, one rounded add, as the oracle
        p1 = torch.where(ss >= 1, torch.where(even, p1 + c, p1), neg)
        p2 = torch.where(can_skip, _shift_right(prev, 2, neg), neg)
        # ties prefer the smaller move: replace only if strictly greater
        take1 = p1 > prev
        best = torch.maximum(prev, p1)
        take2 = p2 > best
        best = torch.maximum(best, p2)
        new = torch.where(live, best + value[:, :, y], neg)
        active = ty > y
        # frames past t_y freeze the carry: the end state is chosen from
        # the column at frame t_y - 1
        prev = torch.where(active, new, prev)
        moves[y] = torch.where(take2, 2, take1.to(torch.int8)) * active

    valid = (t_x >= 1) & (t_x <= t_y) & (ts <= T_s) & (t_y <= T_y)
    last = max(T_s - 1, 0)
    s_tok = (ts - 2).clamp(min=0, max=last)
    s_pause = (ts - 1).clamp(min=0, max=last)
    v_tok = prev.gather(1, s_tok[:, None])[:, 0]
    v_pause = prev.gather(1, s_pause[:, None])[:, 0]
    # the last token unless the trailing pause is strictly better
    s = torch.where(v_pause > v_tok, s_pause, s_tok)
    rows = torch.arange(B, device=dev)
    for y in range(T_y - 1, -1, -1):
        active = valid & (t_y > y)
        path[rows, s, y] = active.float()
        s = s - moves[y, rows, s].long() * active
    return path


def mas_skip_path(value: torch.Tensor, t_x, t_y, *,
                  max_neg_val: float = MAX_NEG_VAL,
                  enter_cost: float = 0.0,
                  frame_major: bool = False) -> torch.Tensor:
    """Pause-aware Viterbi paths for a lattice read as [B, T_s, T_y].

    value: f32 [B, T_s, T_y], any strides (a transposed view of the
    model's frame-major [B, T_y, T_s] lattice is read in place); t_x
    (token counts, 2*t_x + 1 <= T_s), t_y: [B]. enter_cost: log-cost per
    pause entered. Returns f32 0/1 paths [B, T_s, T_y], or [B, T_y, T_s]
    when frame_major, bit-identical to aligner_tpu's `mas_skip_lax`;
    invalid items (see the module docstring) get all zeros.
    """
    t_x, t_y = _check_state_major(value, t_x, t_y)
    if not _on_cuda(value):
        path = mas_skip_plain(value, t_x, t_y, max_neg_val=max_neg_val,
                              enter_cost=enter_cost)
        return path.transpose(1, 2).contiguous() if frame_major else path
    B, T_s, T_y = value.shape
    shape = (B, T_y, T_s) if frame_major else (B, T_s, T_y)
    out = torch.zeros(shape, dtype=torch.float32, device=value.device)
    if out.numel() == 0:
        return out
    path = out.transpose(1, 2) if frame_major else out
    threads, cells, ring, planes, fetch, _ = _skip_viterbi_plan(
        T_s, T_y, frames_contiguous=value.stride(2) == 1)
    scratch = torch.empty(
        (B, T_y, threads * cells // 16) if planes == "global" else (0,),
        dtype=torch.int32, device=value.device)
    lib = _build.load_library()
    with torch.cuda.device(value.device):
        err = lib.mas_skip_launch(
            value.data_ptr(), *value.stride(), t_x.data_ptr(),
            t_y.data_ptr(), scratch.data_ptr(), path.data_ptr(),
            *path.stride(), B, T_s, T_y, threads, cells, ring,
            int(planes == "shared"), int(fetch == "tiles"),
            float(max_neg_val), float(enter_cost),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, KERNEL)
    _build.LAUNCHES[KERNEL] += 1
    return out


def alpha_skip_plain(lp_tm: torch.Tensor, t_y: torch.Tensor,
                     enter_cost: float = 0.0) -> torch.Tensor:
    """lp_tm: f32 [T_y, B, T_s], already NEG-masked at s >= 2*t_x + 1;
    t_y: [B]. Returns the alpha lattice [T_y, B, T_s]; frames past t_y
    freeze the carry, so alphas[-1] is each item's column at frame
    t_y - 1."""
    T_y, B, T_s = lp_tm.shape
    c = float(enter_cost)
    ss = torch.arange(T_s, device=lp_tm.device)
    even = ss % 2 == 0
    can_skip = (ss % 2 == 1) & (ss >= 3)
    first = torch.where(ss == 0, c, torch.where(ss == 1, 0.0, NEG)) \
        .to(lp_tm.dtype)
    ty = t_y.to(lp_tm.device)[:, None]
    prev = torch.full((B, T_s), NEG, dtype=lp_tm.dtype, device=lp_tm.device)
    alphas = torch.empty_like(lp_tm)
    for y in range(T_y):
        if y == 0:
            alpha = lp_tm[0] + first
        else:
            p1 = _shift_right(prev, 1, NEG)
            p1 = torch.where(ss >= 1, torch.where(even, p1 + c, p1), NEG)
            p2 = torch.where(can_skip, _shift_right(prev, 2, NEG), NEG)
            alpha = lp_tm[y] + torch.logaddexp(torch.logaddexp(prev, p1), p2)
        prev = torch.where(ty > y, alpha, prev)
        alphas[y] = prev
    return alphas


def forward_sum_skip_alpha(lp_tm: torch.Tensor, t_y,
                           enter_cost: float = 0.0):
    """Alpha lattice [T_y, B, T_s] and final column [B, T_s].

    lp_tm: f32 [T_y, B, T_s] (any strides), NEG-masked at
    s >= 2*t_x + 1; t_y: [B] int; enter_cost: log-cost per pause
    entered."""
    t_y = _check_frame_major(lp_tm, t_y, "t_y")
    T_y, B, T_s = lp_tm.shape
    if lp_tm.numel() == 0:
        return (torch.empty_like(lp_tm),
                torch.full((B, T_s), NEG, device=lp_tm.device))
    if lp_tm.device.type == "cpu":
        alphas = alpha_skip_plain(lp_tm, t_y, enter_cost)
        return alphas, alphas[-1]
    alphas = torch.empty((T_y, B, T_s), dtype=torch.float32,
                         device=lp_tm.device)
    final = torch.empty((B, T_s), dtype=torch.float32, device=lp_tm.device)
    t_y = t_y.contiguous()
    lib = _build.load_library()
    with torch.cuda.device(lp_tm.device):
        err = lib.forward_sum_skip_alpha_launch(
            lp_tm.data_ptr(), *lp_tm.stride(), t_y.data_ptr(),
            alphas.data_ptr(), final.data_ptr(), B, T_s, T_y,
            float(enter_cost), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, ALPHA_KERNEL)
    _build.LAUNCHES[ALPHA_KERNEL] += 1
    return alphas, final


def gamma_skip_plain(lp_tm: torch.Tensor, alphas: torch.Tensor,
                     total: torch.Tensor, t_x: torch.Tensor,
                     t_y: torch.Tensor,
                     enter_cost: float = 0.0) -> torch.Tensor:
    """Posterior state occupancy gamma = exp(alpha + beta - total),
    [T_y, B, T_s].

    lp_tm: f32 [T_y, B, T_s], NEG-masked at s >= ts = 2*t_x + 1; alphas:
    its alpha lattice; total: [B] log-marginal, already 0 for invalid
    items (else the exp overflows); t_x, t_y: [B]. A reverse sweep over
    the message M[y] = lp[y] + beta[y]: beta[y] is the three-arm
    logaddexp of M[y+1] at s, at s + 1 (the advance, with enter_cost on
    odd source states, where s + 1 < ts) and at s + 2 (the skip, out of
    odd s with s + 2 < ts); beta = 0 at s in {ts-1, ts-2} and NEG
    elsewhere on frame t_y - 1; frames past t_y pass the message through.
    Gamma is exactly 0 off the live cells (y < t_y and lp > NEG/2). The
    result is a [T_y, B, T_s] view of a [B, T_y, T_s] tensor, the layout
    the kernel writes."""
    T_y, B, T_s = lp_tm.shape
    dev = lp_tm.device
    c = float(enter_cost)
    ss = torch.arange(T_s, device=dev)[None, :]
    ts = n_states(t_x.to(dev).long())[:, None]
    ty = t_y.to(dev)[:, None]
    odd = ss % 2 == 1
    can_advance = ss + 1 < ts
    can_skip = odd & (ss + 2 < ts)
    end_col = torch.where((ss == ts - 1) | (ss == ts - 2), 0.0, NEG) \
        .to(lp_tm.dtype)
    tot = total.to(dev)[:, None]
    m_next = torch.full((B, T_s), NEG, dtype=lp_tm.dtype, device=dev)
    gamma = torch.empty((B, T_y, T_s), dtype=lp_tm.dtype, device=dev)
    for y in range(T_y - 1, -1, -1):
        lp = lp_tm[y]
        m1 = _shift_left(m_next, 1, NEG)
        m1 = torch.where(can_advance, torch.where(odd, m1 + c, m1), NEG)
        m2 = torch.where(can_skip, _shift_left(m_next, 2, NEG), NEG)
        beta = torch.logaddexp(torch.logaddexp(m_next, m1), m2)
        beta = torch.where(ty - 1 == y, end_col, beta)
        live = (ty > y) & (lp > 0.5 * NEG)
        gamma[:, y] = torch.where(live, torch.exp(alphas[y] + beta - tot),
                                  0.0)
        m = lp + beta
        m = torch.where(m > 0.5 * NEG, m, NEG)
        m_next = torch.where(ty > y, m, m_next)
    return gamma.transpose(0, 1)


def forward_sum_skip_grad(lp_tm: torch.Tensor, alphas: torch.Tensor,
                          total: torch.Tensor, t_x, t_y,
                          enter_cost: float = 0.0) -> torch.Tensor:
    """Posterior state occupancy gamma [T_y, B, T_s] (a view of a
    [B, T_y, T_s] tensor): see `gamma_skip_plain` for the contract.
    lp_tm and alphas are read through their strides; total is f32 [B]."""
    total, t_x, t_y = _check_grad_inputs(lp_tm, alphas, total, t_x, t_y)
    T_y, B, T_s = lp_tm.shape
    if lp_tm.device.type == "cpu":
        return gamma_skip_plain(lp_tm, alphas, total, t_x, t_y, enter_cost)
    gamma = _gamma_out(B, T_y, T_s, lp_tm.device)
    if lp_tm.numel() == 0:
        return gamma
    threads, cells, ring, _ = _sweep_plan(T_s)
    total, t_x, t_y = total.contiguous(), t_x.contiguous(), t_y.contiguous()
    lib = _build.load_library()
    with torch.cuda.device(lp_tm.device):
        err = lib.forward_sum_skip_gamma_launch(
            lp_tm.data_ptr(), *lp_tm.stride(), alphas.data_ptr(),
            *alphas.stride(), total.data_ptr(), t_x.data_ptr(),
            t_y.data_ptr(), gamma.data_ptr(), *gamma.stride(), B, T_s, T_y,
            threads, cells, ring, float(enter_cost),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, GAMMA_KERNEL)
    _build.LAUNCHES[GAMMA_KERNEL] += 1
    return gamma
