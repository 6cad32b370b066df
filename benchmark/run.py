"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`), `device`, with `--trace 1` a `breakdown`, and last
`checks`, each number compared beside its limit, which the last lines
of standard error repeat. Without a CUDA device, with fewer devices than
the cell asks for, or with JAX loaded once the window has closed, it
prints no result and exits with a code other than 0.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import compare, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "aligner_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_label() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "power limit not read"


def per_layer(cell, done) -> tuple:
    """(metrics, breakdown, busy_s, window_s) of the traced stretch."""
    from harness import trace as tr
    path = done.get("trace_path")
    if path is None:
        raise RuntimeError("the window closed before its traced stretch")
    try:
        t = tr.load(path, len(done["traced"]), done["traced"], done["kind"],
                    cell)
    finally:
        os.remove(path)
    metrics = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"], cell.bench_dir).read(t,
                                                                   m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics, tr.breakdown(t), tr.busy_s(t), t.window_s


def run_cell(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set-up, the window, the readings and the comparison; the result as
    a dict (no check of the device: the tests run it on the CPU)."""
    import torch
    dev = torch.device(device)
    path = cell.path()
    t_run = time.perf_counter()
    done = path.run(cell, seed, seconds, trace, dev)
    parts = {"imports": t_run - T0, **done["setup_parts"]}
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()),
          file=sys.stderr)
    print(f"launches a step: {launches_per_step(done['steps_run'])}",
          file=sys.stderr)
    cuda = dev.type == "cuda"
    result = {"correct": False, "attempted": done["attempted"],
              "failed": done["failed"]}
    if trace:
        metrics, breakdown, busy, window_s = per_layer(cell, done)
    else:
        metrics = {}
        values = dict(done.get("metrics", {}))
        values["setup_s"] = done["t_start"] - T0
        for m in cell.end_to_end:
            # `<base>.<suffix>` is the path's `<base>`, held to a bound of
            # its own in the cells it lists
            name = m["name"] if m["name"] in values \
                else m["name"].split(".")[0]
            if name not in values:
                raise spec.SpecError(f"the {cell.traffic['path']} path "
                                     f"does not measure {m['name']!r}")
            metrics[m["name"]] = {"value": values[name], "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": cell.chips if cuda else 1,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if cuda else 0)}
    if trace:
        device_info.update(busy_s=busy, window_s=window_s)
    # The program's state is gone with `path.run`'s frame; free its blocks
    # before the reference runs.
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = path.check(cell, seed, done, dev)
    checks = compare.judge(numbers, cell.limits)
    result.update(correct=compare.correct(checks), metrics=metrics,
                  device=device_info)
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in checks}
    return result


def launches_per_step(steps: int) -> dict:
    """The port's kernel launches a step or batch (`_build.LAUNCHES`, a
    wrapper's count of its own launches) over every step of the run."""
    from aligner_tpu_torch import _build
    return {k: v / max(steps, 1) for k, v in
            sorted(_build.kernel_launches().items())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = spec.load_cell(args.workload)
    except spec.SpecError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"error: the cell needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import aligner_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"error: the program is not beside the benchmark: {e}",
              file=sys.stderr)
        return 4
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"error: loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 5
    label = card_label()
    print(f"card: {label}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
