"""Hard paths in plain PyTorch on the lattice's device: the best
monotonic path through a lattice and the score of a path given by its
durations, in float64; and the path that the monotonic-alignment DP
finds in float32, with its tie rules.

A served answer is judged by its score on the reference's lattice: the
gap by which it lies below the reference's best path. Two paths that tie
on the lattice both score the best, so a tie broken the other way is no
fault, while a path that is not the best, or not a path at all, shows.

Token lattice: a path visits tokens 0..t_x-1 in order, each for at least
one frame, from frame 0 to frame t_y-1. Pause lattice: states 0..2 t_x
(even s a pause, odd s token (s-1)/2); it starts in state 0 or 1 and
ends in 2 t_x - 1 or 2 t_x, each token at least one frame, each pause
zero or more, and `enter_cost` is added once for every pause entered.
Moves: stay, advance one state, and on the pause lattice skip a pause
onto the next token.
"""
from __future__ import annotations

import numpy as np
import torch

NEG = -1e30


def _lattice(lp) -> torch.Tensor:
    return torch.as_tensor(lp).to(torch.float64)


def lengths(x, device) -> torch.Tensor:
    """Lengths (a numpy array or a tensor on any device) as int64 on
    `device`."""
    return torch.as_tensor(x).to(device=device, dtype=torch.int64)


def best_paths(lp, t_x, t_y, pauses: bool, enter_cost: float = 0.0,
               paths: bool = True):
    """(best score [B], durations [B, T_x], pause durations [B, T_x+1] or
    None), as numpy arrays, of the Viterbi paths through lp [B, T_y, T]
    (frame-major); with paths=False the score alone (durations None)."""
    lp = _lattice(lp)
    dev = lp.device
    B, T_y, T = lp.shape
    t_x, t_y = lengths(t_x, dev), lengths(t_y, dev)
    ss = torch.arange(T, device=dev)
    n = 2 * t_x + 1 if pauses else t_x
    live = ss[None, :] < n[:, None]
    c = float(enter_cost)
    v = torch.full((B, T), NEG, dtype=torch.float64, device=dev)
    v[:, 0] = lp[:, 0, 0] + (c if pauses else 0.0)
    if pauses:
        v[:, 1] = lp[:, 0, 1]
        into_pause = (ss % 2 == 0).double() * c
        skip_ok = (ss % 2 == 1) & (ss >= 3)
    v = torch.where(live, v, NEG)
    moves = torch.zeros((T_y, B, T), dtype=torch.int8, device=dev) \
        if paths else None
    pad = torch.full((B, 2), NEG, dtype=torch.float64, device=dev)
    for y in range(1, T_y):
        adv = torch.cat([pad[:, :1], v[:, :-1]], dim=1)
        cands = [v, adv + into_pause] if pauses else [v, adv]
        if pauses:
            cands.append(torch.where(skip_ok, torch.cat([pad, v[:, :-2]],
                                                        dim=1), NEG))
        best, m = torch.stack(cands).max(dim=0)
        go = (y < t_y)[:, None]
        v = torch.where(go, torch.where(live, best + lp[:, y], NEG), v)
        if paths:
            moves[y] = torch.where(go, m, 0).to(torch.int8)
    rows = torch.arange(B, device=dev)
    if pauses:
        last, before = v[rows, n - 1], v[rows, n - 2]
        score = torch.maximum(last, before)
        s = torch.where(last >= before, n - 1, n - 2)
    else:
        s = t_x - 1
        score = v[rows, s]
    if not paths:
        return score.cpu().numpy(), None, None
    occ = torch.zeros((B, T), dtype=torch.int64, device=dev)
    for y in range(T_y - 1, -1, -1):
        on = (y < t_y).long()
        occ.scatter_add_(1, s[:, None], on[:, None])
        step = moves[y].gather(1, s[:, None])[:, 0].long()
        s = s - step * on
    occ = occ.cpu().numpy()
    if pauses:
        return score.cpu().numpy(), occ[:, 1::2], occ[:, 0::2]
    return score.cpu().numpy(), occ, None


def path_score(lp, t_x, t_y, durations, pause_durations=None,
               enter_cost: float = 0.0) -> np.ndarray:
    """Score [B] on lp [B, T_y, T] of the paths that `durations` [B, T_x]
    (and `pause_durations` [B, T_x+1] on the pause lattice) describe;
    -inf for an item whose durations are no path of its lattice."""
    lp = _lattice(lp)
    B = lp.shape[0]
    out = np.empty(B)
    for i in range(B):
        tx, ty = int(t_x[i]), int(t_y[i])
        d = np.asarray(durations[i], np.int64)
        if pause_durations is None:
            lens = d[:tx]
            ok = (lens >= 1).all() and (d[tx:] == 0).all()
        else:
            p = np.asarray(pause_durations[i], np.int64)
            lens = np.zeros(2 * tx + 1, np.int64)
            lens[1::2] = d[:tx]
            lens[0::2] = p[:tx + 1]
            ok = ((d[:tx] >= 1).all() and (p[:tx + 1] >= 0).all()
                  and (d[tx:] == 0).all() and (p[tx + 1:] == 0).all())
        if not ok or lens.sum() != ty:
            out[i] = -np.inf
            continue
        state = torch.as_tensor(np.repeat(np.arange(len(lens)), lens),
                                device=lp.device)
        frames = torch.arange(ty, device=lp.device)
        out[i] = float(lp[i, frames, state].sum())
        if pause_durations is not None:
            out[i] += enter_cost * np.count_nonzero(lens[0::2])
    return out


MAX_NEG = -1e9


def float32_occupancy(lp, t_x, t_y, pauses: bool, enter_cost: float = 0.0):
    """Frames a state [B, T] of the Viterbi path that the
    monotonic-alignment reference DP finds in float32
    (monotonic_align/core.pyx, and its pause-aware extension), with its
    rounding and its tie rules, on lp [B, T_y, T] frame-major, on lp's
    device: the path the program's kernels are built to give bit for
    bit. Each step is one float32 addition or comparison, rounded alike
    on every device.

    Token lattice: cells in the band of frame y, t_x + y - t_y <= x <=
    min(t_x - 1, y), take max(stay, advance) + lp, a tie keeping the stay;
    the walk back from token t_x - 1 steps back a token where its own
    score is strictly below the previous token's. Pause lattice: a move
    (stay, advance plus `enter_cost` into a pause, skip over a pause onto
    a token) replaces the best only where strictly greater; the end is the
    last token unless the trailing pause is strictly greater."""
    lp = torch.as_tensor(lp)
    dev = lp.device
    # frame-leading [T_y, B, T]: each frame's cells lie together
    v = lp.detach().transpose(0, 1).to(torch.float32, copy=True).contiguous()
    T_y, B, T = v.shape
    t_x, t_y = lengths(t_x, dev), lengths(t_y, dev)
    rows = torch.arange(B, device=dev)
    occ = torch.zeros((B, T), dtype=torch.int64, device=dev)
    neg = torch.full((B, 2), MAX_NEG, dtype=torch.float32, device=dev)
    if not pauses:
        x = torch.arange(T, device=dev)[None, :]
        for y in range(T_y):
            lo = (t_x + y - t_y).clamp(min=0)[:, None]
            hi = t_x.clamp(max=y + 1)[:, None]
            band = (x >= lo) & (x < hi) & (y < t_y)[:, None]
            if y == 0:
                cur = torch.full((B, T), MAX_NEG, dtype=torch.float32,
                                 device=dev)
                prev = torch.where(x == 0, 0.0, MAX_NEG).expand(B, T)
            else:
                cur = torch.where(x == y, MAX_NEG, v[y - 1])
                prev = torch.cat([neg[:, :1], v[y - 1][:, :-1]], dim=1)
            best = torch.where(prev > cur, prev, cur)
            v[y] = torch.where(band, best + v[y], v[y])
        index = t_x - 1
        for y in range(T_y - 1, -1, -1):
            on = (y < t_y).long()
            occ.scatter_add_(1, index[:, None], on[:, None])
            if y == 0:
                break
            i0 = (index - 1).clamp(min=0)
            back = (index != 0) & ((index == y) | (v[y - 1][rows, index]
                                                   < v[y - 1][rows, i0]))
            index = torch.where((on > 0) & back, index - 1, index)
        return occ
    c = torch.tensor(enter_cost, dtype=torch.float32, device=dev)
    ss = torch.arange(T, device=dev)
    into = torch.where(ss % 2 == 0, c, 0.0)
    can_adv = (ss >= 1)[None, :]
    skip_ok = ((ss % 2 == 1) & (ss >= 3))[None, :]
    move = torch.zeros((T_y, B, T), dtype=torch.int8, device=dev)
    last = torch.full((B, T), MAX_NEG, dtype=torch.float32, device=dev)
    last[:, 0] = v[0, :, 0] + c
    last[:, 1] = v[0, :, 1]
    end = t_y - 1
    final = torch.where((end == 0)[:, None], last, MAX_NEG)
    for y in range(1, T_y):
        adv = torch.cat([neg[:, :1], last[:, :-1]], dim=1) + into
        take_adv = can_adv & (adv > last)
        best = torch.where(take_adv, adv, last)
        skip = torch.cat([neg, last[:, :-2]], dim=1)
        take_skip = skip_ok & (skip > best)
        last = torch.where(take_skip, skip, best) + v[y]
        move[y] = torch.where(take_skip, 2, take_adv.to(torch.int8))
        final = torch.where((end == y)[:, None], last, final)
    n = 2 * t_x + 1
    s = torch.where(final[rows, n - 1] > final[rows, n - 2], n - 1, n - 2)
    for y in range(T_y - 1, -1, -1):
        on = (y < t_y).long()
        occ.scatter_add_(1, s[:, None], on[:, None])
        s = s - on * move[y, rows, s].long()
    return occ


def float32_durations(lp, t_x, t_y, pauses: bool, enter_cost: float = 0.0):
    """(durations [B, T_x], pause durations [B, T_x+1] or None), as int64
    numpy arrays, of `float32_occupancy`'s path."""
    occ = float32_occupancy(lp, t_x, t_y, pauses, enter_cost).cpu().numpy()
    if pauses:
        return occ[:, 1::2], occ[:, 0::2]
    return occ, None


def path_mask(occ, t_y, T_y: int) -> torch.Tensor:
    """The 0/1 path [B, T_y, T] (float32) that visits the states in order
    for as many frames as `occ` [B, T] gives each; frames past an item's
    t_y are 0."""
    occ = torch.as_tensor(occ)
    dev = occ.device
    B, T = occ.shape
    ends = occ.cumsum(dim=1)                           # [B, T]
    ys = torch.arange(T_y, device=dev).expand(B, T_y).contiguous()
    state = torch.searchsorted(ends, ys, right=True).clamp(max=T - 1)
    on = ys < lengths(t_y, dev)[:, None]
    mask = torch.zeros((B, T_y, T), dtype=torch.float32, device=dev)
    mask.scatter_(2, state[..., None], on[..., None].float())
    return mask
