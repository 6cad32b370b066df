"""The readings that the limits of `correct` are set from, on the chip, at
a cell's own size, in one process:

    python3 benchmark/calibrate.py --workload <name> --seeds 12 \
        --control-seeds 3 [--faults half_batch,answer_altered] \
        [--reordered-seeds 3] [--skip-program]

For each seed: the program's numbers (a training cell through its first
steps, no window; another cell through a short window at its own load),
on the first `--reordered-seeds` seeds the same run's numbers against
the reference with cuDNN off, so that its convolutions run through
another float32 algorithm (a sound reading of what reordering the
arithmetic costs), then on the first `--control-seeds` seeds the
control's numbers (the reference in the precision below the
configuration's, in the program's place) and each fault's
(`harness.faults`, planted under the program). One JSON line a reading
to standard output, then the largest sound reading (program and
reordered) and the smallest control and fault reading of each number.
The benchmark's runs never run this.
"""
import argparse
import contextlib
import gc
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import faults, spec  # noqa: E402

SEED0 = 2**31 + 1000          # seeds past 32 signed bits
ALIGN_SECONDS = 2.0


def program_run(cell, seed, device, fault=None):
    import torch
    path = cell.path()
    stop = 3 if cell.traffic["path"] == "train" else None
    secs = 0.0 if stop else ALIGN_SECONDS
    with faults.plant(fault, cell) if fault else contextlib.nullcontext():
        done = path.run(cell, seed, secs, False, device, stop_at=stop)
    gc.collect()
    torch.cuda.empty_cache()
    return done


def reordered(cell, seed, done, device):
    """The check with the reference's convolutions off cuDNN."""
    import torch
    with torch.backends.cudnn.flags(enabled=False):
        return cell.path().check(cell, seed, done, device)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--reordered-seeds", type=int, default=0)
    p.add_argument("--skip-program", action="store_true",
                   help="the reordered, control and fault readings only")
    p.add_argument("--first-seed", type=int, default=SEED0)
    args = p.parse_args()
    import torch
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda:0")
    rows = []

    def emit(kind, seed, numbers, t):
        row = {"cell": args.workload, "kind": kind, "seed": seed,
               "numbers": numbers, "seconds": time.perf_counter() - t}
        rows.append(row)
        print(json.dumps(row), flush=True)

    fault_names = [f for f in args.faults.split(",") if f]
    for i in range(args.seeds):
        seed = args.first_seed + i
        reorder = i < args.reordered_seeds
        if reorder or not args.skip_program:
            t = time.perf_counter()
            done = program_run(cell, seed, device)
            if not args.skip_program:
                emit("program", seed, cell.path().check(cell, seed, done,
                                                        device), t)
            if reorder:
                t = time.perf_counter()
                try:
                    emit("reordered", seed,
                         reordered(cell, seed, done, device), t)
                except RuntimeError as e:
                    print(json.dumps({"kind": "reordered", "seed": seed,
                                      "error": str(e)[:500]}), flush=True)
            del done
            gc.collect()
            torch.cuda.empty_cache()
        if i >= args.control_seeds:
            continue
        t = time.perf_counter()
        emit("control", seed, cell.path().control(cell, seed, device), t)
        gc.collect()
        torch.cuda.empty_cache()
        for f in fault_names:
            t = time.perf_counter()
            done = program_run(cell, seed, device, f)
            emit(f, seed, cell.path().check(cell, seed, done, device), t)
            del done
            gc.collect()
            torch.cuda.empty_cache()
    summary = {}
    for kind in sorted({r["kind"] for r in rows}):
        vals = [r["numbers"] for r in rows if r["kind"] == kind]
        pick = max if kind in ("program", "reordered") else min
        keys = {k for v in vals for k in v if not k.startswith("_")}
        summary[kind] = {k: pick(v.get(k, math.inf) for v in vals)
                         for k in sorted(keys)}
    print(json.dumps({"cell": args.workload, "summary": summary}),
          flush=True)


if __name__ == "__main__":
    main()
