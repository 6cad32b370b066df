"""Quality rows of the wav pipeline: build a seeded corpus with
scripts/make_wav_corpus.py, `train` the headline recipe on it, `align` it
and score the alignments (`score_wav`), one JSON line per row, with the
card, the corpus load time and the wall a training step.

    python -m aligner_tpu_torch.wav_rows [--rows baseline_s1,phone_s0]
        [--steps 6000] [--device cuda] [--out rows.jsonl]

The recipe is the JAX package's wav campaign's (scripts/round5_campaign.sh):
`--steps 6000 --recon --temperature 0.15 --bin-start 3000 --bin-ramp 2000
--seed S` at the CLI's default width, on 64 utterances.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from . import cli
from .score_wav import score

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = ["--recon", "--temperature", "0.15", "--bin-start", "3000",
          "--bin-ramp", "2000"]
# name: (seed, corpus flags, train flags)
ROWS = {
    "baseline_s0": (0, [], []),
    "baseline_s1": (1, [], []),
    "baseline_s2": (2, [], []),
    "phone_s0": (0, ["--transcripts", "phone"], ["--tokenizer", "phone"]),
    "bf16_s0": (0, [], ["--compute-dtype", "bfloat16"]),
}


def run_row(name, work, steps, device):
    seed, corpus_flags, train_flags = ROWS[name]
    corpus = os.path.join(work, f"corpus_{name}")
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "make_wav_corpus.py"),
                    corpus, "--seed", str(seed), *corpus_flags],
                   check=True, capture_output=True, timeout=600)
    ckpt = os.path.join(work, f"ck_{name}")
    times = cli.cmd_train(cli.build_parser().parse_args(
        ["train", corpus, "--checkpoint-dir", ckpt, "--steps", str(steps),
         *RECIPE, "--seed", str(seed), *train_flags, "--device", device]))
    out = os.path.join(ckpt, "durations.jsonl")
    t0 = time.perf_counter()
    cli.main(["align", corpus, "--checkpoint-dir", ckpt, "--output", out,
              "--device", device])
    align_s = time.perf_counter() - t0
    return {"run": name, "seed": seed, **score(corpus, out),
            "steps": times["steps"], "load_s": times["load_s"],
            "step_ms": times["step_ms"], "train_s": times["train_s"],
            "align_s": align_s}


def main(argv=None):
    ap = argparse.ArgumentParser("aligner_tpu_torch.wav_rows")
    ap.add_argument("--rows", default="baseline_s1,phone_s0",
                    help=f"comma-separated, of {', '.join(ROWS)}")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="also append each row to this file")
    args = ap.parse_args(argv)
    card = None
    if torch.device(args.device).type == "cuda":
        from ._build import card_label
        card = card_label(0)
    with tempfile.TemporaryDirectory() as work:
        for name in args.rows.split(","):
            rec = {**run_row(name, work, args.steps, args.device),
                   "device": card or args.device}
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main()
