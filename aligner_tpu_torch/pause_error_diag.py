"""Break the pause errors of the pause-aware OTA model down by type, on the
synthetic corpus (the port of scripts/pause_error_diag.py).

Trains the pause-aware OTA model with the flagship recipe (bridge prior,
reconstruction, the pause-bias curriculum) and, on the first two batches,
sorts each token gap's pause into:

* spurious: a predicted pause of >= 2 frames where none is true, counted
  by its predicted length;
* missed: a true pause of >= 2 frames predicted shorter, counted by its
  true length; a miss beside a spurious pause one gap over is a placement
  swap;
* matched: both on, with the signed length error;

and reports the boundary residuals of token edges beside a true pause
against those of the others.

    python -m aligner_tpu_torch.pause_error_diag --steps 3000 --seed 0
        [--hard] [--device cuda]

Prints one JSON line, with the device it ran on.
"""
from __future__ import annotations

import argparse
import collections
import json

import numpy as np
import torch

from ._build import device_label
from .utils.eval import pause_detection, token_boundary_f1, token_spans

HARD = dict(coarticulation=0.3, proto_overlap=0.5, gain_var=0.3)


def add_corpus_flags(ap: argparse.ArgumentParser) -> None:
    """The flags both pause diagnostics take."""
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hard", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback to the "
                         "CPU)")
    ap.add_argument("--pause-prob", type=float, default=0.4)


def train_pause_model(args, device, *, enter_cost=0.0, silence_anchor=0.0,
                      bin_start=None, bin_ramp=None, anneal=None):
    """The pause-aware model trained on the seeded 64-utterance corpus of
    up to 16 tokens: (model, corpus, batches)."""
    from .data import SyntheticConfig, bucket_batches, make_corpus
    from .models.ota import OTAAligner, OTAConfig
    from .train.loop import train_aligner

    cfg = SyntheticConfig(seed=args.seed, max_tokens=16, max_duration=7,
                          pause_prob=args.pause_prob,
                          **(HARD if args.hard else {}))
    corpus = make_corpus(64, cfg)
    batches = list(bucket_batches(corpus, 16, shuffle_seed=args.seed))
    model = OTAAligner(OTAConfig(
        vocab_size=cfg.vocab_size, n_mels=cfg.n_mels, dim=96, hidden=128,
        temperature=0.15, model_pauses=True, use_recon=True,
        pause_prior="bridge", pause_enter_cost=enter_cost,
        pause_silence_anchor=silence_anchor), device=device)
    anneal = anneal or args.steps // 2

    def apply_extra(step_no):
        frac = min(max(step_no / max(anneal, 1), 0.0), 1.0)
        return {"pause_bias": -3.0 * (1.0 - frac)}

    train_aligner(model, batches, steps=args.steps, device=device,
                  learning_rate=3e-4,
                  bin_start=bin_start or args.steps // 6,
                  bin_ramp=bin_ramp or args.steps // 3,
                  log_fn=lambda s: None, seed=args.seed,
                  apply_extra=apply_extra)
    return model, corpus, batches


def match_item(corpus, tokens, t_x):
    """The corpus item a batch row holds (its first t_x tokens), or None."""
    for item in corpus:
        if len(item["tokens"]) == t_x and \
                (item["tokens"] == tokens[:t_x]).all():
            return item
    return None


def batch_rows(corpus, batch):
    """(row index, item) of each row of `batch` that holds a corpus item."""
    for i in range(batch["tokens"].shape[0]):
        item = match_item(corpus, np.asarray(batch["tokens"][i]),
                          int(batch["text_lengths"][i]))
        if item is not None:
            yield i, item


@torch.no_grad()
def forward(model, batch, device):
    return model(*(torch.as_tensor(batch[k]).to(device) for k in
                   ("tokens", "mel", "text_lengths", "mel_lengths")))


def classify(items) -> dict:
    """The error breakdown of `items`, each (predicted token durations
    [t_x], predicted pauses [t_x + 1], true durations, true pauses); pause
    g precedes token g. A pause is on at >= 2 frames."""
    spurious = collections.Counter()   # predicted length of false pauses
    missed = collections.Counter()     # true length of missed pauses
    swaps = []                         # missed pause, spurious neighbour
    matched_err = []                   # signed predicted - true length
    edge_err_pause, edge_err_free = [], []
    f1s, pauses = [], []
    for pd, pp, td, tp in items:
        t_x = len(td)
        f1s.append(token_boundary_f1(pd, td, pred_pauses=pp, true_pauses=tp,
                                     tolerance_frames=2)["f1"])
        pauses.append(pause_detection(pp, tp))
        for g in range(t_x + 1):
            t_on, p_on = tp[g] >= 2, pp[g] >= 2
            if p_on and not t_on:
                spurious[int(pp[g])] += 1
            elif t_on and not p_on:
                missed[int(tp[g])] += 1
                neigh = [h for h in (g - 1, g + 1)
                         if 0 <= h <= t_x and pp[h] >= 2 and tp[h] < 2]
                if neigh:
                    swaps.append({"true_len": int(tp[g]),
                                  "pred_neighbor_len": int(pp[neigh[0]]),
                                  "gap": g, "t_x": t_x,
                                  "tok_between": int(td[min(g, neigh[0])])})
            elif t_on and p_on:
                matched_err.append(int(pp[g]) - int(tp[g]))
        # token start and end edges, split by whether a true pause is
        # beside them
        ps, ts = token_spans(pd, pp), token_spans(td, tp)
        for j in range(t_x):
            (edge_err_pause if tp[j] >= 2 else edge_err_free).append(
                abs(int(ps[j, 0]) - int(ts[j, 0])))
            (edge_err_pause if tp[j + 1] >= 2 else edge_err_free).append(
                abs(int(ps[j, 1]) - int(ts[j, 1])))
    me = np.asarray(matched_err, dtype=np.float64)

    def mean(xs):
        return round(float(np.mean(xs)), 3) if len(xs) else 0

    return {
        "token_boundary_f1_tol2": round(float(np.mean(f1s)), 3),
        "pause_precision": round(float(np.mean(
            [p["precision"] for p in pauses])), 3),
        "pause_recall": round(float(np.mean(
            [p["recall"] for p in pauses if p["n_true"]])), 3),
        "spurious_by_pred_len": dict(sorted(spurious.items())),
        "missed_by_true_len": dict(sorted(missed.items())),
        "swaps": swaps,
        "n_swaps": len(swaps),
        "matched_n": int(me.size),
        "matched_len_err_mean": mean(me),
        "matched_len_err_abs_mean": mean(np.abs(me)),
        "edge_abs_err_pause_adjacent": mean(edge_err_pause),
        "edge_abs_err_pause_free": mean(edge_err_free),
    }


def main(argv=None):
    ap = argparse.ArgumentParser("aligner_tpu_torch.pause_error_diag")
    add_corpus_flags(ap)
    ap.add_argument("--enter-cost", type=float, default=0.0,
                    help="pause entry cost of the model (OTAConfig."
                         "pause_enter_cost; 0 = none)")
    ap.add_argument("--silence-anchor", type=float, default=0.0,
                    help="pause-key silence-anchor aux weight")
    ap.add_argument("--bin-start", type=int, default=None,
                    help="binarisation CE start step (default steps//6)")
    ap.add_argument("--bin-ramp", type=int, default=None,
                    help="binarisation CE ramp length (default steps//3)")
    ap.add_argument("--anneal", type=int, default=None,
                    help="pause-bias curriculum length (default steps//2)")
    args = ap.parse_args(argv)
    from .cli import _device
    device = _device(args)
    model, corpus, batches = train_pause_model(
        args, device, enter_cost=args.enter_cost,
        silence_anchor=args.silence_anchor, bin_start=args.bin_start,
        bin_ramp=args.bin_ramp, anneal=args.anneal)
    items = []
    for b in batches[:2]:
        out = forward(model, b, device)
        durs = out["durations"].cpu().numpy()
        pauses = out["pause_durations"].cpu().numpy()
        for i, item in batch_rows(corpus, b):
            t_x = len(item["tokens"])
            items.append((durs[i][:t_x], pauses[i][:t_x + 1],
                          item["durations"],
                          np.asarray(item["pause_durations"])))
    print(json.dumps({
        "steps": args.steps, "seed": args.seed, "hard": args.hard,
        "enter_cost": args.enter_cost,
        "silence_anchor": args.silence_anchor,
        "bin_start": args.bin_start, "bin_ramp": args.bin_ramp,
        "anneal": args.anneal, **classify(items),
        "device": device_label(device)}), flush=True)


if __name__ == "__main__":
    main()
