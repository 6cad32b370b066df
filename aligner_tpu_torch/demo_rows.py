"""Quality rows of the synthetic demos: the JAX package's demo campaign on
the port. Each row runs `python -m aligner_tpu_torch <demo> ... --device D`
as a subprocess and prints the JSON record on its last line beside the JAX
package's record of the same invocation (`jax`, from
docs/quality_campaign_tpu.jsonl) and the F1@2 range of JAX's records that
differ from it only in `--seed` (`jax_seed_range`).

    python -m aligner_tpu_torch.demo_rows [--rows 0,5-7] [--device cuda]
        [--out rows.jsonl] [--steps N]

The 24 rows are the invocations that the `###` lines of
docs/quality_campaign_tpu.jsonl name, in that file's order; 15 of them are
scripts/quality_campaign2.sh:34-53. --rows takes their indices. --steps
replaces every row's step count (a smoke run: its records are not JAX's,
so write them to a file of their own).

With --out, a row whose invocation is already in the file is skipped. A
row that fails raises and writes nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shlex
import subprocess
import sys
import time

from ._build import device_label
from .cli import _device
from .wav_rows import append

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROWS = "docs/quality_campaign_tpu.jsonl"


def jax_rows() -> dict[str, dict]:
    """{invocation: JAX record} from the `###` lines of JAX_ROWS and the
    record that follows each."""
    rows, run = {}, None
    with open(os.path.join(REPO, JAX_ROWS)) as f:
        for line in f:
            line = line.strip()
            if line.startswith("### "):
                run = line[4:]
            elif line.startswith("{") and run is not None:
                rows[run] = json.loads(line)
                run = None
    return rows


DEMOS = tuple(jax_rows())
# seconds a demo may take; the longest takes about 100 s on an H100
DEMO_TIMEOUT_S = 3000


def seed_of(run: str) -> int:
    return int(re.search(r"--seed (\d+)", run).group(1))


def flags_without_seed(run: str) -> str:
    return re.sub(r" --seed \d+", "", run)


def f1_of(rec: dict) -> float | None:
    """A demo record's headline F1@2: the pause-aware model's token-edge
    F1, RoMo's refined F1, else the record's own."""
    if rec.get("demo") == "pauses":
        return rec["pause_aware"]["token_boundary_f1_tol2"]
    if rec.get("demo") == "romo":
        return rec["refined"]["boundary_f1_tol2"]
    return rec.get("boundary_f1_tol2")


def demo_of(run: str) -> str:
    return run.split()[0].removeprefix("demo-")


def jax_seed_range(run: str, jax: dict[str, dict]) -> list[float]:
    """[min, max] F1@2 of JAX's records of `run`'s flags over every seed
    (records of another demo than the invocation names are left out)."""
    f1s = [f1_of(rec) for r, rec in jax.items()
           if flags_without_seed(r) == flags_without_seed(run)
           and rec.get("demo") == demo_of(run)]
    return [min(f1s), max(f1s)] if f1s else []


def demo_argv(run: str, steps: int | None = None) -> list[str]:
    """The invocation's arguments, its --steps replaced by `steps`."""
    argv = shlex.split(run)
    if steps is not None:
        argv[argv.index("--steps") + 1] = str(steps)
    return argv


def run_demo(argv: list[str], device: str) -> tuple[dict, float]:
    """The demo's last-line record and its wall in seconds."""
    cmd = [sys.executable, "-m", "aligner_tpu_torch", *argv,
           "--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=DEMO_TIMEOUT_S, cwd=REPO)
    wall = time.perf_counter() - t0
    last = proc.stdout.strip().splitlines()[-1:] or [""]
    if proc.returncode != 0 or not last[0].startswith("{"):
        raise RuntimeError(f"{' '.join(cmd[1:])} exited {proc.returncode}:"
                           f"\n{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return json.loads(last[0]), wall


def line_of(run: str, steps: int, rec: dict, wall: float, device: str,
            jax: dict[str, dict]) -> dict:
    """A row's line: the port's record, JAX's, their F1@2 and the range
    of JAX's over seeds. A JAX record of another demo than the invocation
    names is kept as `jax` but not compared (`jax_demo_differs`)."""
    want = jax[run]
    line = {"group": "demo", "run": run, "seed": seed_of(run),
            "steps": steps, "result": rec, "wall_s": wall, "device": device,
            "jax": want, "f1": f1_of(rec),
            "jax_seed_range": jax_seed_range(run, jax)}
    if want.get("demo") == demo_of(run):
        line["jax_f1"] = f1_of(want)
        line["f1_diff"] = round(line["f1"] - line["jax_f1"], 3)
    else:
        line["jax_demo_differs"] = True
    return line


def parse_rows(spec: str | None) -> list[int]:
    """Indices into DEMOS from "0,5-7"; all of them for None."""
    if spec is None:
        return list(range(len(DEMOS)))
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += range(int(lo), int(hi or lo) + 1)
    return out


def read_done(path: str | None) -> set[str]:
    if not path or not os.path.exists(path):
        return set()
    with open(path) as f:
        return {json.loads(line)["run"] for line in f if line.strip()}


def main(argv=None):
    ap = argparse.ArgumentParser("aligner_tpu_torch.demo_rows")
    ap.add_argument("--rows", default=None,
                    help=f"indices into the {len(DEMOS)} rows, as 0,5-7 "
                         "(default all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="append each row to this file; skip the rows "
                         "already in it")
    ap.add_argument("--steps", type=int, default=None,
                    help="replace every row's --steps (a smoke run)")
    args = ap.parse_args(argv)
    jax = jax_rows()
    done = read_done(args.out)
    device = device_label(_device(args))
    for i in parse_rows(args.rows):
        run = DEMOS[i]
        if run in done:
            continue
        argv = demo_argv(run, args.steps)
        rec, wall = run_demo(argv, args.device)
        steps = int(argv[argv.index("--steps") + 1])
        append(args.out, line_of(run, steps, rec, wall, device, jax))


if __name__ == "__main__":
    main()
