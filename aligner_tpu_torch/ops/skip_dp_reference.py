"""NumPy oracles for the skip-state (implicit-pause) lattice DPs, copies
of `n_states`, `mas_skip_single` and `forward_sum_skip_numpy` in
aligner_tpu/ops/skip_dp.py: the golden path the kernels and their plain
versions are held against.

An optional, shared pause state sits between text tokens:

    states  s = 0..T_s-1,  T_s = 2*t_x + 1
    even s  -> pause state (optional)
    odd  s  -> token (s-1)//2 (mandatory)

Moves are stay (0), advance (1) and skip (2); a skip hops from token
state s-2 to token state s over the pause between them, so it only lands
on odd s >= 3. Paths start in {0, 1} and end in {T_s-2, T_s-1}.
`enter_cost` is a log-domain cost added once per transition into a pause
state (an advance into an even s, and a start in state 0). Viterbi ties
prefer the smaller move (a candidate replaces only if strictly greater),
and the end state prefers the last token on a tie. Requires
1 <= t_x <= t_y.
"""
from __future__ import annotations

import numpy as np

MAX_NEG_VAL = -1e9


def n_states(t_x):
    """Expanded state count T_s = 2*t_x + 1 (ints, arrays or tensors)."""
    return 2 * t_x + 1


def mas_skip_single(value: np.ndarray, t_x: int, t_y: int,
                    max_neg_val: float = MAX_NEG_VAL,
                    enter_cost: float = 0.0) -> np.ndarray:
    """Viterbi over the pause-expanded lattice for one item.

    value: [T_s_pad, T_y_pad] float32, rows 0..2*t_x are live states.
    Returns an int32 0/1 path of value.shape (one state per frame).
    """
    if not (1 <= t_x <= t_y):
        raise ValueError(f"need 1 <= t_x <= t_y, got {t_x}, {t_y}")
    T_s = 2 * t_x + 1
    if T_s > value.shape[0]:
        raise ValueError(f"value has {value.shape[0]} state rows, "
                         f"need 2*t_x+1 = {T_s}")
    c = np.float32(enter_cost)
    v = np.full((T_s, t_y), np.float32(max_neg_val), np.float32)
    move = np.zeros((T_s, t_y), np.int8)
    v[0, 0] = np.float32(np.float32(value[0, 0]) + c)
    if T_s > 1:
        v[1, 0] = value[1, 0]
    for y in range(1, t_y):
        for s in range(T_s):
            best = v[s, y - 1]
            m = 0
            if s >= 1:
                cand = np.float32(v[s - 1, y - 1]
                                  + (c if s % 2 == 0 else np.float32(0.0)))
                if cand > best:
                    best = cand
                    m = 1
            if s >= 3 and s % 2 == 1 and v[s - 2, y - 1] > best:
                best = v[s - 2, y - 1]
                m = 2
            v[s, y] = np.float32(np.float32(best) + np.float32(value[s, y]))
            move[s, y] = m
    path = np.zeros(value.shape, np.int32)
    s = T_s - 2 if T_s >= 2 else 0
    if T_s >= 2 and v[T_s - 1, t_y - 1] > v[T_s - 2, t_y - 1]:
        s = T_s - 1
    for y in range(t_y - 1, -1, -1):
        path[s, y] = 1
        # int() guard: NumPy 2 would otherwise cast the Python-int state
        # into the move's int8 dtype, which overflows once T_s > 127
        # (t_x > 63).
        s -= int(move[s, y])
    return path


def forward_sum_skip_numpy(logp: np.ndarray, t_x: int, t_y: int,
                           enter_cost: float = 0.0) -> float:
    """Log-marginal over all pause-optional monotonic alignments.

    logp: [T_s_pad, T_y_pad], state-major like the Viterbi oracle.
    """
    T_s = 2 * t_x + 1
    a = np.full(T_s, -np.inf)
    a[0] = logp[0, 0] + enter_cost
    if T_s > 1:
        a[1] = logp[1, 0]
    for y in range(1, t_y):
        nxt = np.full(T_s, -np.inf)
        for s in range(T_s):
            terms = [a[s]]
            if s >= 1:
                terms.append(a[s - 1]
                             + (enter_cost if s % 2 == 0 else 0.0))
            if s >= 3 and s % 2 == 1:
                terms.append(a[s - 2])
            m = max(terms)
            if m == -np.inf:
                continue
            nxt[s] = m + np.log(sum(np.exp(t - m) for t in terms)) \
                + logp[s, y]
        a = nxt
    ends = [a[T_s - 1]] + ([a[T_s - 2]] if T_s >= 2 else [])
    m = max(ends)
    if m == -np.inf:
        return -np.inf
    return float(m + np.log(sum(np.exp(e - m) for e in ends)))
