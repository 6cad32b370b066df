"""The numbers that decide `correct`, each held to a limit of its own.

* `loss`: the largest relative gap of a loss between the program and the
  reference (a training cell: each of its first steps' losses, every
  term of the objective; the align path: each batch's forward-sum loss);
* `grad` and `change` (training): by the worst leaf, the gap between the
  program's norm of a leaf's first gradient (as the optimizer gets it),
  or of its change over the first steps, and the reference's, over the
  larger of the reference's norm of that leaf and of the median leaf.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's take no part: Adam moves them by round-off alone;
* `lattice`: the largest gap between the program's log-attention
  lattice (before the prior) and the reference's, on the items' own
  cells (a training cell: its first step's, from the same weights; the
  align path: sampled batches of its warm-up pass); `lattice_prior`
  (training) the same of the lattice with the prior;
* `path`: on the align path, the widest gap, in nats, by which a hard
  path the program gave (its durations) scores below the reference's best
  path on the reference's lattice, inf where it is no path of its
  lattice; a training cell counts the items whose path differs from the
  reference's float32 Viterbi on the program's own lattice, and holds the
  gap in nats as `path_nats` (the family's `step_numbers`).
"""
from __future__ import annotations

import math

import numpy as np

from reference import viterbi

QUIET_LEAF = 1e-3


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: dict, ref: dict, ref_grad: dict) -> dict:
    """Each counted leaf's gap of norms (see the module's doc)."""
    median_g = float(np.median(list(ref_grad.values())))
    median = float(np.median([ref[k] for k in ref]))
    out = {}
    for k, r in ref.items():
        if ref_grad[k] < QUIET_LEAF * median_g:
            continue
        gap = abs(prog.get(k, math.nan) - r) / max(r, median, 1e-30)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def lattice_gap(prog, ref, t_x, t_y, pauses: bool) -> float:
    """The largest |program - reference| of the log-attention lattice
    [B, T_y, T] over the items' own states and frames."""
    import torch
    ref = torch.as_tensor(ref)
    prog = torch.as_tensor(prog).to(ref.device, torch.float32)
    if prog.shape != ref.shape:
        return math.inf
    B, T_y, T = ref.shape
    t_x = viterbi.lengths(t_x, ref.device)
    t_y = viterbi.lengths(t_y, ref.device)
    n = 2 * t_x + 1 if pauses else t_x
    live = ((torch.arange(T_y, device=ref.device)[None, :, None]
             < t_y[:, None, None])
            & (torch.arange(T, device=ref.device)[None, None, :]
               < n[:, None, None]))
    gap = torch.where(live, (prog - ref.float()).abs(), 0.0).max()
    return float(gap) if torch.isfinite(gap) else math.inf


def path_gap(lattice, t_x, t_y, durations, pause_durations,
             enter_cost: float = 0.0) -> float:
    """The widest gap over a batch's items (see the module's doc)."""
    if not np.shape(durations)[0] == np.shape(lattice)[0] == len(t_x):
        return math.inf
    pauses = pause_durations is not None
    best, _, _ = viterbi.best_paths(lattice, t_x, t_y, pauses, enter_cost,
                                    paths=False)
    got = viterbi.path_score(lattice, t_x, t_y, durations, pause_durations,
                             enter_cost)
    gaps = best - got
    return float(np.max(np.where(np.isfinite(got), gaps, np.inf)))


def judge(numbers: dict, limits: dict) -> list:
    """[(name, value, limit)] in the order of `limits`; every number of
    the limits file has to be there."""
    return [(k, float(numbers.get(k, math.inf)), float(limits[k]))
            for k in limits if not k.startswith("_")]


def correct(checks: list) -> bool:
    return all(v <= lim for _, v, lim in checks)
