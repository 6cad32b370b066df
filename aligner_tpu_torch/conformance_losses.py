"""Conformance sweep on the card for the loss and skip-lattice kernels.

    python -m aligner_tpu_torch.conformance_losses [--seeds 2]
        [--device cuda] [--max-cells N]

The twin of scripts/conformance_sweep_losses.py:

* the skip-state Viterbi H4 (`mas_skip_path`) bit-identical to the copied
  NumPy oracle `mas_skip_single` (zero paths on invalid items), on
  state-major lattices read in both layouts (frames contiguous: its
  "tiles" fetch; a frame-major tensor through a transposed view: "rows"),
  over every plan of `SKIP_VITERBI_PLANS` (both forms of its move planes)
  and three enter costs, with t_x > 63, where NumPy 2 would promote the
  oracle's int8 moves;
* the forward-sum sweeps H2 (alpha) and H3 (posterior), and their
  skip-state twins H5 and H6, over every plan of `SWEEP_PLANS`: the alpha
  lattice, each item's total and the posterior occupancy against the
  kernels' plain versions on the same device, rtol 1e-5 / atol 1e-6 (the
  tolerance of the kernels' own checks), and each valid item's total
  against a float64 NumPy forward-sum, rtol 1e-5 / atol 1e-3 (float32
  sums over up to 1024 frames).

The plain versions are bound when this module is imported, so a harness
that refuses them to the kernels' wrappers (chip_smoke.py) still lets the
sweep call them as references. One line per case; the run stops with
exit code 1 at the first failure. `--max-cells` skips the lattices of more
cells (a reduced grid for the CPU, where the wrappers run the plain
versions themselves); the plan coverage is then not required.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .ops import forward_sum_kernel as fk
from .ops import skip_dp_kernel as sk
from .ops.forward_sum import _masked_logp, _total_from_alphas, _valid_items
from .ops.forward_sum_kernel import alpha_plain, gamma_plain
from .ops.skip_dp import _total_from_alphas_skip, _valid_items_skip
from .ops.skip_dp_kernel import alpha_skip_plain, gamma_skip_plain
from .ops.skip_dp_reference import (forward_sum_skip_numpy, mas_skip_single,
                                    n_states)

PLAIN_RTOL, PLAIN_ATOL = 1e-5, 1e-6
NUMPY_RTOL, NUMPY_ATOL = 1e-5, 1e-3
# The float64 skip forward-sum is a Python loop over states and frames:
# it checks the valid items of at most this many cells, two a case.
NUMPY_SKIP_CELLS = 60_000

# (B, T_x, T_y, lengths, enter cost, note); T_s = 2 * T_x + 1 states.
# `lengths` as in conformance.py, and "short" (t_x <= 32: a wide column
# whose items the oracle walks quickly).
SKIP_VITERBI = [
    (4, 16, 100, "ragged", 0.0, "small"),
    (8, 64, 256, "ragged", -1.2, "H4 (1,32,shared,tiles); (1,8,shared,rows)"),
    (4, 100, 300, "ragged", 0.6, "t_x > 63: the oracle's int8 moves"),
    (2, 1, 8, "ragged", 0.0, "t_x = 1"),
    (4, 24, 24, "diagonal", 0.0, "t_x = t_y: every pause skipped"),
    (3, 8, 40, "invalid", 0.0, "item 0 t_x > t_y: a zero path"),
    (4, 40, 200, "ties", -1.2, "ties everywhere"),
    (4, 64, 5300, "long", 0.0, "H4 (1,32,global,tiles); (1,8,shared,rows)"),
    (4, 64, 5680, "long", 0.6, "H4 frame-major (1,4,shared,rows)"),
    (4, 64, 5750, "long", -1.2, "H4 frame-major (1,8,global,rows)"),
    (4, 700, 200, "short", 0.0, "H4 (2,8,shared,rows)"),
    (4, 700, 520, "short", 0.6, "H4 (2,4,shared,rows)"),
    (4, 700, 600, "short", -1.2, "H4 (2,8,global,rows)"),
    (4, 1200, 100, "short", 0.0, "H4 (4,8,shared,rows)"),
    (4, 1200, 250, "short", 0.6, "H4 (4,4,shared,rows)"),
    (4, 1200, 300, "short", -1.2, "H4 (4,8,global,rows)"),
    (4, 2500, 50, "short", 0.0, "H4 (8,4,shared,rows)"),
    (4, 2500, 100, "short", 0.6, "H4 (8,4,global,rows)"),
]
# (B, T_x, T_y, lengths, note): H2 and H3, plan by T_x.
FORWARD_SUM = [
    (16, 128, 1024, "ragged", "headline; (1,8)"),
    (1, 16, 40, "ragged", "one item"),
    (2, 1, 8, "ragged", "t_x = 1"),
    (4, 24, 24, "diagonal", "t_x = t_y"),
    (3, 8, 40, "invalid", "item 0 t_x > t_y: zero loss and posterior"),
    (4, 1500, 200, "short", "(2,8)"),
    (4, 2500, 200, "short", "(3,8)"),
    (4, 3500, 200, "short", "(4,6)"),
    (4, 5000, 200, "short", "(6,3)"),
    (4, 7000, 200, "short", "(8,2)"),
]
# (B, T_x, T_y, lengths, enter cost, note): H5 and H6, plan by T_s.
SKIP_FORWARD_SUM = [
    (16, 128, 1024, "ragged", 0.0, "headline; (1,8)"),
    (4, 16, 100, "ragged", -1.2, "small"),
    (2, 1, 8, "ragged", 0.6, "t_x = 1"),
    (4, 24, 24, "diagonal", 0.0, "t_x = t_y"),
    (3, 8, 40, "invalid", 0.0, "item 0 t_x > t_y: zero loss and posterior"),
    (4, 700, 200, "short", -1.2, "(2,8)"),
    (4, 1200, 200, "short", 0.6, "(3,8)"),
    (4, 1800, 200, "short", 0.0, "(4,6)"),
    (4, 2500, 200, "short", -1.2, "(6,3)"),
    (4, 3500, 200, "short", 0.6, "(8,2)"),
]


def lengths(rng, B, T_x, T_y, mode):
    """Ragged (t_x, t_y) int32 for one case (see the grids)."""
    top = min(T_x, T_y, 32) if mode == "short" else min(T_x, T_y)
    t_x = rng.integers(1, top + 1, B)
    t_y = np.maximum(t_x, rng.integers(1, T_y + 1, B))
    if mode == "long":
        t_y = np.maximum(t_x, rng.integers(1, min(T_y, 256) + 1, B))
    if mode == "diagonal":
        t_y = t_x.copy()
    elif mode == "invalid":
        t_x[0], t_y[0] = min(T_x, 5), min(T_x, 5) - 1
    else:
        t_x[0], t_y[0] = top, T_y
    return t_x.astype(np.int32), t_y.astype(np.int32)


def close(got, want, rtol, atol):
    """(ok, max abs error) of two tensors or arrays."""
    got = torch.as_tensor(got).double().cpu()
    want = torch.as_tensor(want).double().cpu()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    return bool(torch.allclose(got, want, rtol=rtol, atol=atol)), err


def check_skip_viterbi(seed, B, T_x, T_y, mode, cost, device, plans):
    rng = np.random.default_rng(7000 * seed + B + T_x + T_y)
    T_s = 2 * T_x + 1
    if mode == "ties":
        value = rng.integers(-2, 3, (B, T_s, T_y)).astype(np.float32)
    else:
        value = rng.standard_normal((B, T_s, T_y), np.float32) * 3
    t_x, t_y = lengths(rng, B, T_x, T_y, mode)
    want = np.zeros(value.shape, np.int32)
    for i in range(B):
        if 1 <= t_x[i] <= t_y[i]:
            want[i] = mas_skip_single(value[i].copy(), int(t_x[i]),
                                      int(t_y[i]), enter_cost=cost)
    v = torch.from_numpy(value).to(device)
    tx, ty = (torch.from_numpy(a).to(device) for a in (t_x, t_y))
    lines = []
    for layout, view in (("natural", v), ("frame-major", v.transpose(1, 2)
                                          .contiguous().transpose(1, 2))):
        plan = sk._skip_viterbi_plan(T_s, T_y, layout == "natural")[1:5]
        plans.add(plan)
        got = sk.mas_skip_path(view, tx, ty, enter_cost=cost)
        ok = np.array_equal(got.to(torch.int32).cpu().numpy(), want)
        lines.append((ok, f"{layout:11s} H4 {plan}"))
    return lines


def forward_sum_numpy(lp: np.ndarray, t_x: int, t_y: int) -> float:
    """float64 log-marginal over monotonic alignments of one item; lp is
    frame-major [T_y, T_x]."""
    lp = lp.astype(np.float64)
    a = np.full(t_x, -np.inf)
    a[0] = lp[0, 0]
    for y in range(1, t_y):
        a = np.logaddexp(a, np.concatenate([[-np.inf], a[:-1]])) \
            + lp[y, :t_x]
    return float(a[t_x - 1])


def check_forward_sum(seed, B, T_x, T_y, mode, device, plans):
    rng = np.random.default_rng(9000 * seed + B + T_x + T_y)
    lp = rng.standard_normal((B, T_y, T_x), np.float32) - 2
    t_x, t_y = lengths(rng, B, T_x, T_y, mode)
    plans.add(fk._sweep_plan(T_x)[1:3])
    tx, ty = (torch.from_numpy(a).to(device) for a in (t_x, t_y))
    lp_tm = _masked_logp(torch.from_numpy(lp).to(device), tx).transpose(0, 1)
    valid = _valid_items(tx, ty)

    alphas, final = fk.forward_sum_alpha(lp_tm, ty)
    total = torch.where(valid, _total_from_alphas(final, tx), 0.0)
    gamma = fk.forward_sum_grad(lp_tm, alphas, total, tx, ty)
    alphas_ref = alpha_plain(lp_tm, ty)
    total_ref = torch.where(valid, _total_from_alphas(alphas_ref[-1], tx),
                            0.0)
    gamma_ref = gamma_plain(lp_tm, alphas_ref, total_ref, tx, ty)
    want = [forward_sum_numpy(lp[i], int(t_x[i]), int(t_y[i]))
            if 1 <= t_x[i] <= t_y[i] else 0.0 for i in range(B)]
    return compare(alphas, alphas_ref, total, total_ref, gamma, gamma_ref,
                   torch.tensor(want), range(B),
                   f"H2/H3 plan {fk._sweep_plan(T_x)[1:3]}")


def compare(alphas, alphas_ref, total, total_ref, gamma, gamma_ref, want,
            items, what):
    """(ok, detail) of a sweep against its plain version and NumPy."""
    checks = [("alpha", *close(alphas, alphas_ref, PLAIN_RTOL, PLAIN_ATOL)),
              ("total", *close(total, total_ref, PLAIN_RTOL, PLAIN_ATOL)),
              ("gamma", *close(gamma, gamma_ref, PLAIN_RTOL, PLAIN_ATOL))]
    items = list(items)
    checks.append(("numpy", *close(total.cpu()[items], want, NUMPY_RTOL,
                                   NUMPY_ATOL)))
    ok = all(c[1] for c in checks)
    detail = " ".join(f"{name} {err:.2e}" for name, _, err in checks)
    return ok, f"{what}: max abs errors {detail} ({len(items)} NumPy items)"


def check_skip_forward_sum(seed, B, T_x, T_y, mode, cost, device, plans):
    rng = np.random.default_rng(8000 * seed + B + T_x + T_y)
    T_s = 2 * T_x + 1
    lp = rng.standard_normal((B, T_y, T_s), np.float32) - 2
    t_x, t_y = lengths(rng, B, T_x, T_y, mode)
    plans.add(fk._sweep_plan(T_s)[1:3])
    tx, ty = (torch.from_numpy(a).to(device) for a in (t_x, t_y))
    lp_tm = _masked_logp(torch.from_numpy(lp).to(device),
                         n_states(tx)).transpose(0, 1)
    valid = _valid_items_skip(tx, ty, T_s)

    alphas, final = sk.forward_sum_skip_alpha(lp_tm, ty, cost)
    total = torch.where(valid, _total_from_alphas_skip(final, tx), 0.0)
    gamma = sk.forward_sum_skip_grad(lp_tm, alphas, total, tx, ty, cost)
    alphas_ref = alpha_skip_plain(lp_tm, ty, cost)
    total_ref = torch.where(valid, _total_from_alphas_skip(alphas_ref[-1],
                                                           tx), 0.0)
    gamma_ref = gamma_skip_plain(lp_tm, alphas_ref, total_ref, tx, ty, cost)
    items = [i for i in range(B) if 1 <= t_x[i] <= t_y[i]
             and (2 * t_x[i] + 1) * t_y[i] <= NUMPY_SKIP_CELLS][:2]
    want = [forward_sum_skip_numpy(lp[i].T.astype(np.float64), int(t_x[i]),
                                   int(t_y[i]), enter_cost=cost)
            for i in items]
    return compare(alphas, alphas_ref, total, total_ref, gamma, gamma_ref,
                   torch.tensor(want, dtype=torch.float64), items,
                   f"H5/H6 plan {fk._sweep_plan(T_s)[1:3]}")


def sweep(seeds: int, device: torch.device, max_cells: int | None,
          out=print) -> int:
    """Run the three grids; return the number of cases checked. Raises
    AssertionError at the first case that fails."""
    cases = skipped = 0
    viterbi_plans, fs_plans, skip_fs_plans = set(), set(), set()

    def report(ok, label, detail):
        out(f"{'OK  ' if ok else 'FAIL'} {label} {detail}")
        if not ok:
            raise AssertionError(f"{label}: {detail}")

    grids = (
        ("skip-viterbi", SKIP_VITERBI, True),
        ("forward-sum", [(*c[:4], None, c[4]) for c in FORWARD_SUM], False),
        ("skip-forward-sum", SKIP_FORWARD_SUM, True))
    for name, grid, skip in grids:
        for B, T_x, T_y, mode, cost, note in grid:
            cells = B * (2 * T_x + 1 if skip else T_x) * T_y
            shape = f"B={B} T_x={T_x} T_y={T_y}"
            if max_cells is not None and cells > max_cells:
                out(f"SKIP {name} {shape} [{note}] (over --max-cells)")
                skipped += 1
                continue
            for seed in range(seeds):
                label = (f"{name:16s} {shape} seed={seed}"
                         + ("" if cost is None else f" enter_cost={cost}"))
                if name == "skip-viterbi":
                    for ok, detail in check_skip_viterbi(
                            seed, B, T_x, T_y, mode, cost, device,
                            viterbi_plans):
                        cases += 1
                        report(ok, label, f"{detail} [{note}]")
                elif name == "forward-sum":
                    ok, detail = check_forward_sum(seed, B, T_x, T_y, mode,
                                                   device, fs_plans)
                    cases += 1
                    report(ok, label, f"{detail} [{note}]")
                else:
                    ok, detail = check_skip_forward_sum(
                        seed, B, T_x, T_y, mode, cost, device,
                        skip_fs_plans)
                    cases += 1
                    report(ok, label, f"{detail} [{note}]")
    if not skipped:
        missing = [("H4", p) for p in sk.SKIP_VITERBI_PLANS
                   if p not in viterbi_plans]
        missing += [("H2/H3", p) for p in fk.SWEEP_PLANS
                    if p not in fs_plans]
        missing += [("H5/H6", p) for p in fk.SWEEP_PLANS
                    if p not in skip_fs_plans]
        if missing:
            raise AssertionError(f"the grids missed the plans {missing}")
        out("plans reached: every SKIP_VITERBI_PLANS entry (H4), every "
            "SWEEP_PLANS entry (H2/H3 and H5/H6)")
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-cells", type=int, default=None,
                    help="skip lattices of more cells (B * T_x or T_s * T_y)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("conformance_losses: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    try:
        cases = sweep(args.seeds, device, args.max_cells)
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    print(f"all {cases} loss and skip-lattice cases conform on {device} "
          f"({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
