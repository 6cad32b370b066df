"""MAS conformance sweep on the card: every route against the NumPy oracle.

    python -m aligner_tpu_torch.conformance [--seeds 2] [--device cuda]
        [--max-cells N]

The twin of scripts/conformance_sweep.py. Every route of `mas_path`
(`fused`, the two-pass `two_pass`, `stage`, `split`, `chains2` and
`chains4`), H1's bits walked by 2 and 4 chains, and
`maximum_path(implementation="cpp")` must give paths bit-identical to the
copied NumPy oracle `mas_single`, on lattices read in both layouts: the
natural [B, T_x, T_y] (frames contiguous: H1's "tiles" fetch) and a
frame-major [B, T_y, T_x] tensor read through a transposed view ("rows").
Items outside 1 <= t_x <= t_y must get an all-zero path.

The grid is chosen so that H1 takes every plan of `MAS_PLANS` (cells a
thread, ring depth, where its bit plane lives, how rows are fetched) and
its wide kernel past 8192 tokens, and the ring walks H10, H11 and H14
every plan of `WALK_PLANS`; a run that reaches fewer fails. Ragged items,
ties (an integer-valued lattice), t_x = 1, t_x = t_y and t_x > t_y are
among the cases. Where a route's plan cannot take a shape (H13 with K
chains past its widest column, K not dividing the batch) the case is
printed as SKIP with the reason.

One line per case; the run stops with exit code 1 at the first failure.
`--max-cells` skips the lattices of more cells (a reduced grid for the
CPU, where every route runs its kernels' plain versions); the plan
coverage is then not required. With `--device cuda` and no card it
exits 1 and runs nothing.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .ops import mas_kernel as mk
from .ops.mas import maximum_path
from .ops.mas_reference import mas_single
from .utils.masks import lattice_mask

ROUTES = {
    "fused": {},
    "two_pass": {"fuse": False},
    "stage": {"fuse": False, "form": "stage"},
    "split": {"fuse": False, "form": "split"},
    "chains2": {"fuse": False, "chains": 2},
    "chains4": {"fuse": False, "chains": 4},
}
# H1's bits (one chain) walked by K chains (H14): the walk's plans past
# the widest column K of H13's chains take.
BIT_WALKS = {"bits1_walk2": 2, "bits1_walk4": 4}

# (B, T_x, T_y, lengths, note). `lengths`: "ragged" (item 0 the whole
# lattice where it is valid), "long" (item 0 takes every frame, the others
# at most 1024), "diagonal" (t_x = t_y), "ties" (ragged on an
# integer-valued lattice), "invalid" (item 0 has t_x > t_y), "deep" (every
# item within 50 tokens of T_x and 100 frames of its t_x, item 0 the whole
# lattice: narrow bands over the whole column, which the oracle walks
# quickly). The notes
# name the plans the shape is there for: H1's (natural; frame-major) and
# the ring walk's (frames a chunk, stages) with K chains.
MAS_CASES = [
    (32, 128, 1024, "ragged", "headline; H1 (1,32,shared,tiles); "
     "(1,8,shared,rows); walks (128,4)"),
    (4, 1, 64, "ragged", "t_x = 1"),
    (4, 24, 24, "diagonal", "t_x = t_y"),
    (8, 40, 200, "ties", "ties everywhere"),
    (8, 45, 300, "invalid", "odd shape; item 0 t_x > t_y, a zero path"),
    (4, 200, 400, "ragged", "walk (64,4) with 4 chains"),
    (4, 128, 12000, "long", "H1 (1,32,global,tiles); (1,8,shared,rows)"),
    (4, 128, 12700, "long", "H1 frame-major (1,4,shared,rows)"),
    (4, 128, 12800, "long", "H1 frame-major (1,8,global,rows)"),
    (4, 1500, 200, "ragged", "H1 (2,8,shared,rows); walks (32,4) (16,4) "
     "(8,4)"),
    (4, 1500, 950, "ragged", "H1 (2,4,shared,rows)"),
    (4, 1500, 1100, "ragged", "H1 (2,8,global,rows)"),
    (4, 3000, 200, "ragged", "H1 (4,8,shared,rows); walks (16,4) (8,4) "
     "(4,4)"),
    (4, 3000, 300, "ragged", "H1 (4,4,shared,rows)"),
    (4, 3000, 450, "ragged", "H1 (4,8,global,rows)"),
    (4, 5000, 100, "ragged", "H1 (8,4,shared,rows); walks (8,4) (4,4) "
     "(2,4)"),
    (4, 5000, 200, "ragged", "H1 (8,4,global,rows)"),
    (4, 8200, 64, "ragged", "H1 wide; walks (4,4) (2,4) (1,4)"),
    (2, 8200, 8300, "deep", "H1 wide over a whole 8200-token column"),
    (4, 15000, 64, "ragged", "H1 wide; walks (2,4) (1,4) (1,2)"),
    (4, 29010, 64, "ragged", "H1 wide near its widest column; walks "
     "(2,4) (1,2) (1,1)"),
]


def make_case(seed, B, T_x, T_y, lengths):
    """(value [B, T_x, T_y] float32, t_x, t_y) from a seed."""
    rng = np.random.default_rng(1000 * seed + B + T_x + T_y)
    if lengths == "ties":
        value = rng.integers(-2, 3, (B, T_x, T_y)).astype(np.float32)
    else:
        value = (rng.standard_normal((B, T_x, T_y), np.float32) * 3)
    top = min(T_x, T_y)
    t_x = rng.integers(1, top + 1, B)
    t_y = np.maximum(t_x, rng.integers(1, T_y + 1, B))
    if lengths == "long":
        t_y = np.maximum(t_x, rng.integers(1, min(T_y, 1024) + 1, B))
        t_x[0], t_y[0] = top, T_y
    elif lengths == "diagonal":
        t_y = t_x.copy()
    elif lengths == "deep":
        t_x = T_x - rng.integers(0, 50, B)
        t_y = np.minimum(t_x + rng.integers(0, 100, B), T_y)
        t_x[0], t_y[0] = T_x, T_y
    elif lengths == "invalid":
        t_x[0], t_y[0] = min(T_x, 5), min(T_x, 5) - 1
    else:
        t_x[0], t_y[0] = top, T_y
    return value, t_x.astype(np.int32), t_y.astype(np.int32)


def oracle(value, t_x, t_y):
    """int32 paths [B, T_x, T_y]: mas_single on each valid item, zeros on
    the others."""
    want = np.zeros(value.shape, np.int32)
    for i in range(value.shape[0]):
        tx, ty = int(t_x[i]), int(t_y[i])
        if 1 <= tx <= ty:
            want[i, :tx, :ty] = mas_single(value[i, :tx, :ty].copy(), tx, ty)
    return want


def route_chains(name):
    """K: the chains a route's walk (and, for `chainsK`, its forward)
    runs."""
    return (ROUTES[name].get("chains", 1) if name in ROUTES
            else BIT_WALKS[name])


def route_skip(name, B, T_x, T_y, contiguous):
    """Why a route cannot take the shape, or None."""
    chains = route_chains(name)
    if B % chains:
        return f"{chains} chains must divide B = {B}"
    try:
        if name in ("chains2", "chains4"):
            mk._chains_plan(T_x, T_y, chains, contiguous)
        if chains > 1 or name in ("stage", "split"):
            mk._walk_plan(T_x, T_y, chains, 0)
    except ValueError as e:
        return str(e)
    return None


def walk_plans(name, T_x, T_y):
    """The ring walk's (frames a chunk, stages) a route runs, if any."""
    chains = route_chains(name)
    if chains > 1 or name in ("stage", "split"):
        return [mk._walk_plan(T_x, T_y, chains, 0)[1:3]]
    return []


def run_route(name, v, t_x, t_y):
    if name in ROUTES:
        return mk.mas_path(v, t_x, t_y, **ROUTES[name])
    return mk.mas_backtrack(mk.mas_bits(v, t_x, t_y), t_x, t_y,
                            chains=BIT_WALKS[name])


def sweep(seeds: int, device: torch.device, max_cells: int | None,
          out=print) -> int:
    """Run the grid; return the number of cases checked. Raises
    AssertionError at the first path that differs from the oracle's."""
    h1_plans, walks = set(), set()
    cases = skipped = 0
    for B, T_x, T_y, lengths, note in MAS_CASES:
        shape = f"B={B} T_x={T_x} T_y={T_y}"
        if max_cells is not None and B * T_x * T_y > max_cells:
            out(f"SKIP mas {shape} [{note}] (over --max-cells)")
            skipped += 1
            continue
        for seed in range(seeds):
            value, t_x, t_y = make_case(seed, B, T_x, T_y, lengths)
            want = oracle(value, t_x, t_y)
            tx = torch.from_numpy(t_x).to(device)
            ty = torch.from_numpy(t_y).to(device)
            natural = torch.from_numpy(value).to(device)
            layouts = {"natural": natural,
                       "frame-major": natural.transpose(1, 2).contiguous()
                       .transpose(1, 2)}
            del natural
            for layout, v in layouts.items():
                contiguous = layout == "natural"
                plan = mk._mas_plan(T_x, T_y, contiguous)[1:5]
                h1_plans.add(plan)
                for name in (*ROUTES, *BIT_WALKS):
                    label = (f"mas {name:11s} {layout:11s} {shape} "
                             f"seed={seed}")
                    why = route_skip(name, B, T_x, T_y, contiguous)
                    if why:
                        out(f"SKIP {label} ({why})")
                        continue
                    got = run_route(name, v, tx, ty)
                    ok = np.array_equal(
                        got.to(torch.int32).cpu().numpy(), want)
                    cases += 1
                    found = walk_plans(name, T_x, T_y)
                    walks.update(found)
                    out(f"{'OK  ' if ok else 'FAIL'} {label} H1 {plan}"
                        f"{f' walk {found[0]}' if found else ''} [{note}]")
                    if not ok:
                        raise AssertionError(f"{label}: path differs from "
                                             "the oracle's")
            valid = (t_x >= 1) & (t_x <= t_y)
            keep = torch.from_numpy(np.flatnonzero(valid)).to(device)
            mask = lattice_mask(tx[keep], ty[keep], T_x, T_y)
            got = maximum_path(layouts["natural"][keep], mask,
                               implementation="cpp")
            ok = (got.device == layouts["natural"].device
                  and np.array_equal(got.to(torch.int32).cpu().numpy(),
                                     want[valid]))
            cases += 1
            label = f"mas {'cpp':11s} {'natural':11s} {shape} seed={seed}"
            out(f"{'OK  ' if ok else 'FAIL'} {label} ({int(valid.sum())} "
                f"valid items) [{note}]")
            if not ok:
                raise AssertionError(f"{label}: path differs from the "
                                     "oracle's")
    if not skipped:
        missing = [p for p in mk.MAS_PLANS if p not in h1_plans]
        if not any(p[3] == "wide" for p in h1_plans):
            missing.append("H1's wide kernel")
        missing += [p for p in mk.WALK_PLANS if p not in walks]
        if missing:
            raise AssertionError(f"the grid missed the plans {missing}")
        out(f"plans reached: H1 {len(h1_plans)} (every MAS_PLANS entry "
            f"and the wide kernel), ring walk {len(walks)} (every "
            "WALK_PLANS entry)")
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-cells", type=int, default=None,
                    help="skip lattices of more cells (B * T_x * T_y)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("conformance: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    try:
        cases = sweep(args.seeds, device, args.max_cells)
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    print(f"all {cases} MAS cases bit-identical to the oracle on {device} "
          f"({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
