"""Alignment evaluation metrics (NumPy only, copied from
aligner_tpu/utils/eval.py).

Duration exact-match is a harsh metric (a single one-frame shift breaks
two tokens); the alignment literature evaluates **boundary placement
under a time tolerance** (commonly 10-20 ms). These helpers convert
durations to boundaries and score precision/recall/F1 at a tolerance,
plus the frame-level overlap rate of two alignments.
"""
from __future__ import annotations

import numpy as np


def boundaries_from_durations(durations) -> np.ndarray:
    """Internal boundary positions (frames) — cumulative sums, excluding
    the final utterance end (always shared)."""
    d = np.asarray(durations)
    return np.cumsum(d)[:-1]


def boundary_f1(pred_durations, true_durations, *, tolerance_frames: int = 2):
    """Precision/recall/F1 of predicted boundaries within +/- tolerance.

    Boundaries are matched greedily one-to-one in order. Returns a dict
    with precision, recall, f1, and the mean absolute boundary error (in
    frames) over matched pairs.
    """
    pred = boundaries_from_durations(pred_durations)
    true = boundaries_from_durations(true_durations)
    if len(pred) == 0 and len(true) == 0:
        return {"precision": 1.0, "recall": 1.0, "f1": 1.0,
                "matched_mae": 0.0}
    used = np.zeros(len(true), bool)
    hits, errs = 0, []
    for p in pred:
        cand = np.nonzero(~used & (np.abs(true - p) <= tolerance_frames))[0]
        if len(cand):
            j = cand[np.argmin(np.abs(true[cand] - p))]
            used[j] = True
            hits += 1
            errs.append(abs(float(true[j] - p)))
    precision = hits / max(len(pred), 1)
    recall = hits / max(len(true), 1)
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1,
            "matched_mae": float(np.mean(errs)) if errs else 0.0}


def token_spans(token_durations, pause_durations=None) -> np.ndarray:
    """Per-token (start, end) frame spans [t_x, 2].

    With `pause_durations` [t_x + 1] (pause j precedes token j), pauses
    shift the token spans; without, tokens tile the frames contiguously.
    """
    d = np.asarray(token_durations)
    p = (np.zeros(len(d) + 1, d.dtype) if pause_durations is None
         else np.asarray(pause_durations))
    starts = np.cumsum(p[:-1]) + np.concatenate([[0], np.cumsum(d)[:-1]])
    return np.stack([starts, starts + d], axis=1)


def token_boundary_f1(pred_durs, true_durs, *, pred_pauses=None,
                      true_pauses=None, tolerance_frames: int = 2):
    """Boundary F1 over token start/end events, pause-aware.

    Unlike `boundary_f1` (which assumes contiguous tokens), this scores
    the *token span edges*, so a model that absorbs a silence into a
    neighbouring token is penalised even if its inter-token cut sits
    somewhere inside the silence. This is the implicit-pause headline
    metric: only a model that routes silence frames around the tokens
    can place both edges of a pause-adjacent token correctly.
    """
    pred = np.unique(token_spans(pred_durs, pred_pauses).ravel())
    true = np.unique(token_spans(true_durs, true_pauses).ravel())
    used = np.zeros(len(true), bool)
    hits, errs = 0, []
    for p in pred:
        cand = np.nonzero(~used
                          & (np.abs(true - p) <= tolerance_frames))[0]
        if len(cand):
            j = cand[np.argmin(np.abs(true[cand] - p))]
            used[j] = True
            hits += 1
            errs.append(abs(float(true[j] - p)))
    precision = hits / max(len(pred), 1)
    recall = hits / max(len(true), 1)
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1,
            "matched_mae": float(np.mean(errs)) if errs else 0.0}


def pause_detection(pred_pauses, true_pauses, *, min_frames: int = 2,
                    gap_tolerance: int = 0):
    """Recall/precision of pause *slots* (which token gaps hold a pause
    of >= min_frames). Returns dict with recall, precision, and the MAE
    of pause lengths over true pause slots.

    gap_tolerance > 0 relaxes slot matching to within that many token
    gaps (greedy one-to-one nearest match). Motivation (measured, wav
    pause campaign, docs/PERF.md): on real-audio corpora the mel
    window smears silence evidence across the boundary token, so the
    dominant error mode is a pause detected but attributed to the
    adjacent gap — 272 of 337 seed-0 false positives sat within 2 gaps
    of a true pause. The strict metric scores placement; tolerance 1
    scores detection."""
    p = np.asarray(pred_pauses)
    t = np.asarray(true_pauses)
    true_on = t >= min_frames
    pred_on = p >= min_frames
    if gap_tolerance == 0:
        tp = int((true_on & pred_on).sum())
    else:
        true_idx = list(np.nonzero(true_on)[0])
        tp = 0
        for g in np.nonzero(pred_on)[0]:
            if not true_idx:
                break
            d = np.abs(np.asarray(true_idx) - g)
            j = int(np.argmin(d))
            if d[j] <= gap_tolerance:
                tp += 1
                true_idx.pop(j)
    recall = tp / max(int(true_on.sum()), 1)
    precision = tp / max(int(pred_on.sum()), 1)
    mae = (float(np.abs(p[true_on] - t[true_on]).mean())
           if true_on.any() else 0.0)
    return {"recall": recall, "precision": precision,
            "length_mae": mae, "n_true": int(true_on.sum())}


def frame_accuracy(pred_durations, true_durations) -> float:
    """Fraction of frames assigned to the same token index by both
    alignments (both must cover the same number of frames)."""
    def expand(d):
        d = np.asarray(d)
        return np.repeat(np.arange(len(d)), d)
    a, b = expand(pred_durations), expand(true_durations)
    assert len(a) == len(b), "alignments cover different frame counts"
    return float((a == b).mean()) if len(a) else 1.0
