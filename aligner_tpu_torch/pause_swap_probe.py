"""Probe the placement swaps of the pause-aware OTA model on the synthetic
corpus (the port of scripts/pause_swap_probe.py, the follow-up to
`pause_error_diag`).

It asks two questions of one trained model:

1. Is a placement swap (a true pause missed at gap g, a spurious one at an
   adjacent gap h) a decode problem or a lattice problem? For each swap it
   compares the model's own posterior pause occupancy (expected pause
   frames from `skip_posteriors`) at g and at h. Where the lattice puts
   more mass on the swapped gap, no decode-side lever can fix it.
2. What do decode-time levers buy on the fixed model? It sweeps the skip
   Viterbi's `enter_cost` (`mas_skip_path_frame_major`) and a post-filter
   that merges pauses shorter than k frames into the preceding token, and
   scores each decode.

    python -m aligner_tpu_torch.pause_swap_probe --steps 3000 --seed 0
        --hard [--device cuda]

Prints the lever grid as a markdown table, the swap count, the first 20
swaps as JSON and, last, one JSON line with all of it and the device.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ._build import device_label
from .pause_error_diag import (add_corpus_flags, batch_rows, forward,
                               train_pause_model)
from .utils.eval import pause_detection, token_boundary_f1


def minlen_filter(durs, pauses, k):
    """Merge decoded pauses shorter than k frames into the preceding
    token (gap 0 merges into token 0). durs [t_x], pauses [t_x+1]."""
    durs = durs.copy()
    pauses = pauses.copy()
    for g in range(len(pauses)):
        if 0 < pauses[g] < k:
            durs[max(g - 1, 0)] += pauses[g]
            pauses[g] = 0
    return durs, pauses


def pause_occupancy(gamma, t_x):
    """Expected frames in each pause state [t_x + 1] of one item's
    posterior state occupancy gamma [T_y, T_s] (pauses at even states)."""
    return gamma[:, 0:2 * t_x + 1:2].sum(axis=0)


def swap_rows(true_pauses, pred_pauses, occupancy):
    """A record for each placement swap of one item: a true pause (>= 2
    frames) decoded shorter at gap g beside a spurious decoded pause at
    h = g +- 1, with the posterior's expected pause frames at both."""
    tp, pp = true_pauses, pred_pauses
    rows = []
    for g in range(len(tp)):
        if tp[g] >= 2 and pp[g] < 2:
            for h in (g - 1, g + 1):
                if 0 <= h < len(tp) and pp[h] >= 2 and tp[h] < 2:
                    rows.append({"true_gap_mass": float(occupancy[g]),
                                 "swap_gap_mass": float(occupancy[h]),
                                 "true_len": int(tp[g]),
                                 "swap_len": int(pp[h])})
    return rows


def lever_scores(decodes, true_durs, true_pauses, min_lens):
    """{(enter_cost, k): (F1@2, pause precision, pause recall)} of one
    item's decodes {enter_cost: (durations [t_x], pauses [t_x+1])}, each
    after minlen_filter(k)."""
    out = {}
    for c, (d, p) in decodes.items():
        for k in min_lens:
            pd, pp = minlen_filter(d, p, k)
            f1 = token_boundary_f1(pd, true_durs, pred_pauses=pp,
                                   true_pauses=true_pauses,
                                   tolerance_frames=2)["f1"]
            det = pause_detection(pp, true_pauses)
            out[(c, k)] = (f1, det["precision"], det["recall"])
    return out


def grid_means(per_setting):
    """[(enter_cost, k, F1, precision, recall)] sorted, each the NaN-mean
    of its items' scores."""
    rows = []
    for (c, k), scores in sorted(per_setting.items()):
        m = np.nanmean(np.asarray(scores, dtype=np.float64), axis=0)
        rows.append((c, k, *(float(x) for x in m)))
    return rows


def report(grid, swaps, steps, seed, hard) -> list[str]:
    """The lines the probe prints before its JSON line."""
    lines = ["", "# decode-time lever grid (fixed model, "
             f"steps={steps} seed={seed} hard={hard})", "",
             "| enter_cost | min_len | F1@2 | pause P | pause R |",
             "|---|---|---|---|---|"]
    lines += [f"| {c:+.1f} | {k} | {f:.3f} | {p:.3f} | {r:.3f} |"
              for c, k, f, p, r in grid]
    prefers = sum(1 for r in swaps if r["swap_gap_mass"] > r["true_gap_mass"])
    lines += ["", f"# swap posterior probe: {len(swaps)} swaps; lattice "
                  f"puts MORE pause mass on the swapped gap in "
                  f"{prefers}/{len(swaps)}",
              json.dumps({"swaps": swaps[:20]}, indent=None)]
    return lines


def main(argv=None):
    from .cli import _device
    from .ops.skip_dp import (mas_skip_path_frame_major, skip_posteriors,
                              split_state_durations)

    ap = argparse.ArgumentParser("aligner_tpu_torch.pause_swap_probe")
    add_corpus_flags(ap)
    ap.add_argument("--enter-costs", type=float, nargs="*",
                    default=[0.0, -0.5, -1.0, -2.0])
    ap.add_argument("--min-lens", type=int, nargs="*", default=[1, 2, 3])
    args = ap.parse_args(argv)
    device = _device(args)
    model, corpus, batches = train_pause_model(args, device)

    per_setting = {}
    swaps = []
    for b in batches[:2]:
        out = forward(model, b, device)
        lp = out["logp_with_prior"]
        tl = torch.as_tensor(b["text_lengths"]).to(device)
        ml = torch.as_tensor(b["mel_lengths"]).to(device)
        gamma = skip_posteriors(lp, tl, ml)[0].cpu().numpy()
        base_pp = out["pause_durations"].cpu().numpy()
        decodes = {}
        for c in args.enter_costs:
            hard = mas_skip_path_frame_major(lp, tl, ml, enter_cost=c)
            d, p = split_state_durations(hard.sum(dim=1))
            decodes[c] = (d.cpu().numpy(), p.cpu().numpy())
        for i, item in batch_rows(corpus, b):
            t_x = len(item["tokens"])
            tp = np.asarray(item["pause_durations"])
            swaps += swap_rows(tp, base_pp[i][:t_x + 1],
                               pause_occupancy(gamma[i], t_x))
            scores = lever_scores(
                {c: (d[i][:t_x], p[i][:t_x + 1])
                 for c, (d, p) in decodes.items()},
                item["durations"], tp, args.min_lens)
            for key, s in scores.items():
                per_setting.setdefault(key, []).append(s)

    grid = grid_means(per_setting)
    for line in report(grid, swaps, args.steps, args.seed, args.hard):
        print(line)
    print(json.dumps({
        "steps": args.steps, "seed": args.seed, "hard": args.hard,
        "grid": [dict(zip(("enter_cost", "min_len", "f1_tol2",
                           "pause_precision", "pause_recall"), g))
                 for g in grid],
        "n_swaps": len(swaps),
        "lattice_prefers_swap": sum(
            1 for r in swaps if r["swap_gap_mass"] > r["true_gap_mass"]),
        "swaps": swaps, "device": device_label(device)}), flush=True)


if __name__ == "__main__":
    main()
