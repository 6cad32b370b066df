"""Quality rows of the wav pipeline: the JAX package's wav campaigns on the
port. Each row builds a seeded corpus with scripts/make_wav_corpus.py,
`train`s its recipe on it, `align`s it and scores the alignments
(`score_wav`). Each row gives one JSON line with the card, the corpus load
time, the wall a training step and, as `jax`, the JAX package's row for the
same run, read from docs/.

    python -m aligner_tpu_torch.wav_rows [--rows round5,baseline_s0]
        [--steps 6000] [--utterances 64] [--device cuda] [--out rows.jsonl]

--rows takes group names and run names (a run name selects each of its
seeds). The groups are named after the JAX scripts whose `run` lines their
rows copy (seed, corpus flags, train flags, score flags; each row cites its
line):

  round5            scripts/round5_campaign.sh (hop128_tight_s0 scores
                    hop128_s0's alignments again at the tight tolerance)
  wav_pauses        scripts/wav_pause_campaign.sh, seeds 0 and 1
  wav_pause_levers  scripts/wav_pause_levers.sh, seeds 0 and 1
  enter_cost        scripts/enter_cost_sweep.sh: wav_pauses' seed-0
                    pause-aware checkpoint aligned at eight enter costs
  seed0_spread      baseline_s0, then the same corpus with `train --seed`
                    1 and 2, then baseline_s0 once more: the card's own
                    spread on the seed-0 corpus

The recipe is the campaigns' `--steps 6000 --recon --temperature 0.15
--bin-start 3000 --bin-ramp 2000 --seed S` at the CLI's default width, on
64 utterances.

With --out, a row whose (group, run, seed) is already in the file is
skipped, so a campaign may span several calls. A row that fails raises and
writes nothing. A row that aligns another row's checkpoint trains that row
first in the same process, again if an earlier call wrote it (its line is
not written twice).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

from . import cli
from . import score_wav
from ._build import device_label

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = ("--recon", "--temperature", "0.15", "--bin-start", "3000",
          "--bin-ramp", "2000")
PAUSE_CORPUS = ("--pause-prob", "0.4")


@dataclasses.dataclass(frozen=True)
class Row:
    """One run of a campaign. seed: the corpus's, and `train --seed`'s
    unless train_seed is set. reuses: the run (same seed) whose checkpoint
    this row aligns again with `align`, or, without `align` flags, whose
    alignments it scores again; the row trains nothing itself."""
    group: str
    run: str
    seed: int
    cite: str
    corpus: tuple[str, ...] = ()
    train: tuple[str, ...] = ()
    score: tuple[str, ...] = ()
    align: tuple[str, ...] = ()
    train_seed: int | None = None
    reuses: str | None = None

    @property
    def key(self) -> tuple[str, str, int]:
        return self.group, self.run, self.seed


R5 = "scripts/round5_campaign.sh"
PAUSES = "scripts/wav_pause_campaign.sh"
LEVERS = "scripts/wav_pause_levers.sh"
SWEEP = "scripts/enter_cost_sweep.sh"
ENTER_COSTS = ("-2", "-1", "-0.5", "0", "0.5", "1", "2", "4")
HOP128 = ("--truth-scale", "2", "--tolerance", "4")

ROWS = (
    Row("seed0_spread", "baseline_s0", 0, "docs/PERF.md:249"),
    *(Row("seed0_spread", f"baseline_s0_init{s}", 0, "docs/PERF.md:249",
          train_seed=s) for s in (1, 2)),
    Row("seed0_spread", "baseline_s0_again", 0, "docs/PERF.md:249"),
    *(Row("round5", f"baseline_s{s}", s, f"{R5}:59-61") for s in (1, 2)),
    Row("round5", "hop128_s0", 0, f"{R5}:65", train=("--mel-hop", "128"),
        score=HOP128),
    Row("round5", "win512_s0", 0, f"{R5}:66", train=("--mel-win", "512")),
    Row("round5", "nocenter_s0", 0, f"{R5}:67", train=("--no-mel-center",)),
    Row("round5", "hop128_tight_s0", 0, f"{R5}:68-75",
        score=("--truth-scale", "2"), reuses="hop128_s0"),
    Row("round5", "mobo_s0", 0, f"{R5}:78", train=("--model", "mobo")),
    Row("round5", "romo_s0", 0, f"{R5}:79", train=("--model", "romo")),
    Row("round5", "phone_s0", 0, f"{R5}:82-85",
        corpus=("--transcripts", "phone"), train=("--tokenizer", "phone")),
    Row("round5", "bf16_s0", 0, f"{R5}:88",
        train=("--compute-dtype", "bfloat16")),
    *(Row("wav_pauses", f"wav_pauses_{name}", s, f"{PAUSES}:{line}",
          corpus=PAUSE_CORPUS, train=flags)
      for s in (0, 1)
      for name, line, flags in (("pauseaware", 42, ("--model-pauses",)),
                                ("pauseblind", 43, ()))),
    *(Row("enter_cost", f"sweep_ec{c}", 0, f"{SWEEP}:15-19",
          corpus=PAUSE_CORPUS, align=("--pause-enter-cost", c),
          reuses="wav_pauses_pauseaware") for c in ENTER_COSTS),
    *(Row("wav_pause_levers", f"pa_{name}", s, f"{LEVERS}:{line}",
          corpus=PAUSE_CORPUS, train=("--model-pauses", *flags), score=score)
      for s in (0, 1)
      for name, line, score, flags in (
          ("hop128win512", 44, HOP128, ("--mel-hop", "128", "--mel-win",
                                        "512")),
          ("win512", 45, (), ("--mel-win", "512")))),
)
GROUPS = tuple(dict.fromkeys(r.group for r in ROWS))
JAX_ROWS = {"round5": "docs/r5_campaign_rows.jsonl",
            "wav_pauses": "docs/wav_pause_campaign_tpu.jsonl",
            "wav_pause_levers": "docs/wav_pause_levers_tpu.jsonl",
            "enter_cost": "docs/enter_cost_sweep_tpu.jsonl",
            "seed0_spread": "docs/PERF.md"}


def _round4_row(path: str) -> dict:
    """The JAX package's seed-0 row of the headline recipe (round 4): a
    line of the markdown table in docs/PERF.md."""
    with open(path) as f:
        for n, line in enumerate(f, 1):
            if line.startswith("| `--steps 6000 ... --bin-start 3000 "
                               "--bin-ramp 2000` | 0 |"):
                cells = [c.strip() for c in line.strip().strip("|")
                         .split("|")]
                return {"boundary_f1_tol2": float(cells[2]),
                        "duration_mae": float(cells[3]),
                        "source": f"docs/PERF.md:{n}"}
    raise LookupError(f"no round-4 seed-0 row in {path}")


def jax_row(row: Row) -> dict:
    """The JAX package's row for `row`, from its docs/ file (without the
    corpus's path on the machine that ran it)."""
    path = os.path.join(REPO, JAX_ROWS[row.group])
    if row.group == "seed0_spread":
        return _round4_row(path)
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    if row.group == "enter_cost":
        cost = float(row.align[1])
        hits = [r for r in recs if r["enter_cost"] == cost]
    else:
        hits = [r for r in recs
                if r["run"] == row.run and r["seed"] == row.seed]
    if len(hits) != 1:
        raise LookupError(f"{len(hits)} rows for {row.key} in {path}")
    return {k: v for k, v in hits[0].items() if k != "corpus"}


def select(names: str) -> list[Row]:
    """The rows of the comma-separated groups and run names, in table
    order."""
    want = set(names.split(","))
    unknown = want - set(GROUPS) - {r.run for r in ROWS}
    if unknown:
        raise SystemExit(f"unknown rows {sorted(unknown)}: groups "
                         f"{', '.join(GROUPS)} or run names")
    return [r for r in ROWS if r.group in want or r.run in want]


def read_done(path: str | None) -> set[tuple[str, str, int]]:
    """The (group, run, seed) of each line already in `path`."""
    if not path or not os.path.exists(path):
        return set()
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return {(r["group"], r["run"], r["seed"]) for r in recs}


def plan(rows: list[Row], done: set) -> list[tuple[Row, bool]]:
    """(row, write its line) in run order: the rows not done, each row
    that another reuses first (written only if not done)."""
    by_run = {(r.run, r.seed): r for r in ROWS}
    out: list[tuple[Row, bool]] = []
    for r in rows:
        if r.key in done:
            continue
        if r.reuses:
            src = by_run[(r.reuses, r.seed)]
            if all(src is not p for p, _ in out):
                out.append((src, src.key not in done))
        if all(r is not p for p, _ in out):
            out.append((r, True))
    return out


class Runner:
    """Runs rows in one work directory: a corpus is made once for each
    (seed, corpus flags), and the checkpoint and alignments of each run
    stay there for the rows that reuse them."""

    def __init__(self, work: str, steps: int, utterances: int, device: str):
        self.work, self.steps = work, steps
        self.utterances, self.device = utterances, device
        self.corpora: dict[tuple, str] = {}
        self.made: dict[tuple[str, int], tuple[str, str]] = {}

    def corpus(self, row: Row) -> str:
        key = (row.seed, row.corpus)
        if key not in self.corpora:
            path = os.path.join(self.work, f"corpus_{len(self.corpora)}")
            subprocess.run(
                [sys.executable,
                 os.path.join(REPO, "scripts", "make_wav_corpus.py"), path,
                 "--seed", str(row.seed), "--utterances",
                 str(self.utterances), *row.corpus],
                check=True, capture_output=True, timeout=600)
            self.corpora[key] = path
        return self.corpora[key]

    def run(self, row: Row) -> dict:
        corpus = self.corpus(row)
        rec = {"group": row.group, "run": row.run, "seed": row.seed}
        if row.reuses:
            ckpt, out = self.made[(row.reuses, row.seed)]
        else:
            ckpt = os.path.join(self.work, f"ck_{row.run}_s{row.seed}")
            seed = row.seed if row.train_seed is None else row.train_seed
            times = cli.cmd_train(cli.build_parser().parse_args(
                ["train", corpus, "--checkpoint-dir", ckpt, "--steps",
                 str(self.steps), *RECIPE, "--seed", str(seed), *row.train,
                 "--device", self.device]))
            rec.update(train_seed=seed, steps=times["steps"],
                       load_s=times["load_s"], step_ms=times["step_ms"],
                       train_s=times["train_s"])
            out = None
        if out is None or row.align:
            out = os.path.join(ckpt, f"durations_{row.run}.jsonl")
            t0 = time.perf_counter()
            cli.main(["align", corpus, "--checkpoint-dir", ckpt, "--output",
                      out, *row.align, "--device", self.device])
            rec["align_s"] = time.perf_counter() - t0
        self.made[(row.run, row.seed)] = (ckpt, out)
        flags = score_wav.build_parser().parse_args([corpus, out,
                                                     *row.score])
        rec.update(score_wav.score(corpus, out, flags.truth_scale,
                                   flags.tolerance))
        rec.pop("corpus")
        return rec


def line_of(rec: dict, jax: dict, device: str) -> dict:
    """A row's line: its record, the device, JAX's row and the F1@2
    difference from it."""
    diff = rec["boundary_f1_tol2"] - jax["boundary_f1_tol2"]
    return {**rec, "device": device, "jax": jax, "f1_diff": round(diff, 3)}


def append(path: str | None, line: dict) -> None:
    """Print a row's line and append it to `path` (if given)."""
    text = json.dumps(line)
    print(text, flush=True)
    if path:
        with open(path, "a") as f:
            f.write(text + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser("aligner_tpu_torch.wav_rows")
    ap.add_argument("--rows", default="baseline_s1,phone_s0",
                    help=f"comma-separated groups ({', '.join(GROUPS)}) or "
                         f"run names")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--utterances", type=int, default=64,
                    help="utterances a corpus (make_wav_corpus.py)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="append each row to this file; skip the rows "
                         "already in it")
    args = ap.parse_args(argv)
    todo = plan(select(args.rows), read_done(args.out))
    device = device_label(cli._device(args))
    with tempfile.TemporaryDirectory() as work:
        runner = Runner(work, args.steps, args.utterances, args.device)
        for row, write in todo:
            rec = runner.run(row)
            if write:
                append(args.out, line_of(rec, jax_row(row), device))


if __name__ == "__main__":
    main()
