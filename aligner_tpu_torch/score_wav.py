"""Score `align` output against a wav corpus's ground truth
(`durations_truth.json` from scripts/make_wav_corpus.py); the port's copy
of scripts/score_wav_alignments.py, over the port's `utils/eval.py`.

    python -m aligner_tpu_torch.score_wav corpus_dir durations.jsonl
        [--truth-scale N] [--tolerance F]

Prints one JSON line: mean boundary F1@2, duration exact-match and MAE
over the corpus, and the pause metrics where the alignments have pauses.
Token spans are scored pause-aware when the truth has pauses (a
pause-blind model must absorb them, and is penalised for the edges it
therefore misses).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .utils.eval import pause_detection, token_boundary_f1


def score(corpus_dir: str, alignments: str, truth_scale: int = 1,
          tolerance: int = 2) -> dict:
    """The scores of a durations.jsonl against the corpus's truth."""
    with open(os.path.join(corpus_dir, "durations_truth.json")) as f:
        truth = json.load(f)
    f1s, exacts, maes, pdet = [], [], [], []
    n = 0
    with open(alignments) as f:
        recs = [json.loads(line) for line in f]
    for rec in recs:
        t = truth.get(rec["utt_id"])
        if t is None:
            continue
        pred = np.asarray(rec["durations"])
        want = np.asarray(t["durations"]) * truth_scale
        pauses = np.asarray(t["pauses"]) * truth_scale
        pred_pauses = (np.asarray(rec["pauses"])
                       if rec.get("pauses") is not None else None)
        if len(pred) != len(want):
            continue
        # The mel frame count is total samples // hop + 1 (center
        # padding): drop the surplus tail frame from the last token so
        # exact/MAE compare like with like.
        surplus = (pred.sum() - want.sum() - pauses.sum()
                   + (pred_pauses.sum() if pred_pauses is not None else 0))
        pred_adj = pred.copy()
        pred_adj[-1] = max(pred_adj[-1] - surplus, 0)
        f1s.append(token_boundary_f1(
            pred, want, pred_pauses=pred_pauses,
            true_pauses=pauses if pauses.any() else None,
            tolerance_frames=tolerance)["f1"])
        exacts.append(float((pred_adj == want).mean()))
        maes.append(float(np.abs(pred_adj - want).mean()))
        if pred_pauses is not None and pauses.any():
            d = pause_detection(pred_pauses, pauses)
            g1 = pause_detection(pred_pauses, pauses, gap_tolerance=1)
            d["precision_g1"], d["recall_g1"] = g1["precision"], \
                g1["recall"]
            pdet.append(d)
        n += 1
    out = {
        "corpus": corpus_dir, "n": n,
        **({"truth_scale": truth_scale, "tolerance": tolerance}
           if (truth_scale != 1 or tolerance != 2) else {}),
        "boundary_f1_tol2": round(float(np.mean(f1s)), 3),
        "duration_exact": round(float(np.mean(exacts)), 3),
        "duration_mae": round(float(np.mean(maes)), 3),
    }
    if pdet:
        for k in ("precision", "recall", "precision_g1", "recall_g1"):
            out[f"pause_{k}"] = round(float(np.nanmean(
                [d[k] for d in pdet])), 3)
        out["pause_length_mae"] = round(float(np.nanmean(
            [d["length_mae"] for d in pdet])), 3)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("aligner_tpu_torch.score_wav")
    ap.add_argument("corpus_dir")
    ap.add_argument("alignments", help="durations.jsonl from `align`")
    ap.add_argument("--truth-scale", type=int, default=1,
                    help="multiply truth durations/pauses by this "
                         "factor: the generator's truth is in hop-256 "
                         "frames, so alignments from a `--mel-hop 128` "
                         "run need --truth-scale 2")
    ap.add_argument("--tolerance", type=int, default=2,
                    help="boundary-F1 tolerance in mel frames "
                         "(default 2). Scale with --truth-scale to "
                         "hold the physical tolerance window fixed "
                         "across hop levers")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(json.dumps(score(args.corpus_dir, args.alignments,
                           args.truth_scale, args.tolerance)), flush=True)


if __name__ == "__main__":
    main()
