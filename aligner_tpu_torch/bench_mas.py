"""Headline benchmark of the port: batched MAS paths per second on one GPU
(T_text=128, T_mel=1024 by default), route by route.

    python -m aligner_tpu_torch bench-mas [--batch 32 --t-text 128 --t-mel 1024]
        [--route fused|two_pass|stage|split|chains2|chains4|all] [--device cuda]

Counterpart of aligner_tpu's bench.py and of its A/B harnesses
scripts/bt_nat_ab.py and scripts/nat_tile_ab.py. Prints one JSON line per
route:

  {"metric": "mas_paths_per_sec_per_chip", "value": N, "unit": "paths/s",
   "vs_baseline": N / 2110, "p50_align_step_ms": t, "config": "...",
   "timing_method": "cuda_events", "route": "...", "device": "..."}

Baseline (BASELINE.md): the reference Cython kernel on one x86 core, B=32,
t_x=128, t_y=1024: about 2110 paths/s. The input is bench.py's (numpy
`default_rng(0)`, values * 3, the same ragged length draws). Before any
route is timed, its paths on two seeds must equal the numpy oracle
`mas_single` bit for bit; a mismatch, or `--device cuda` without a CUDA
device, prints the same line with value 0 and an `error` key and exits 1.
Nothing moves to the CPU on its own: `--device cpu` asks for the plain
PyTorch versions, timed by the host's clock and labelled so.

Timing: a few warm-up calls, then 50 calls with a CUDA event between
each; `value` is the batch over the mean call, `p50_align_step_ms` the
median call. `--route all` prints every route, the default one (`fused`)
last.
"""
from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch

from ._build import card_label
from .ops.mas_kernel import mas_path
from .ops.mas_reference import mas_single

BASELINE_PATHS_PER_SEC = 2110.0
METRIC = "mas_paths_per_sec_per_chip"
WARMUP, ITERS = 3, 50
# Route name -> mas_path options. `fused` is the default route of the
# package; the others are the two-pass route and its variants.
ROUTES = {
    "two_pass": {"fuse": False},
    "stage": {"fuse": False, "form": "stage"},
    "split": {"fuse": False, "form": "split"},
    "chains2": {"fuse": False, "chains": 2},
    "chains4": {"fuse": False, "chains": 4},
    "fused": {},
}
DEFAULT_ROUTE = "fused"


def inputs(seed: int, B: int, T_x: int, T_y: int):
    """The ragged lattice batch of bench.py for `seed`."""
    rng = np.random.default_rng(seed)
    value = (rng.standard_normal((B, T_x, T_y)) * 3).astype(np.float32)
    t_x = rng.integers(max(1, T_x // 2), T_x + 1, B).astype(np.int32)
    t_y = np.maximum(t_x, rng.integers(max(1, T_y // 4), T_y + 1, B)) \
        .astype(np.int32)
    return value, t_x, t_y


def _fail(error: str, **extra) -> int:
    print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "paths/s",
                      "vs_baseline": 0.0, **extra, "error": error}),
          flush=True)
    return 1


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu (plain PyTorch versions, host clock)"
    return card_label(torch.cuda.current_device() if device.index is None
                      else device.index)


def call_ms(fn, device: torch.device) -> list[float]:
    """Milliseconds of each of ITERS calls of fn() after WARMUP calls:
    CUDA events between the calls on a card, the host's clock on the
    CPU."""
    for _ in range(WARMUP):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return times
    torch.cuda.synchronize(device)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(ITERS + 1)]
    marks[0].record()
    for mark in marks[1:]:
        fn()
        mark.record()
    torch.cuda.synchronize(device)
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def run(batch: int = 32, t_text: int = 128, t_mel: int = 1024,
        route: str = DEFAULT_ROUTE, device: str = "cuda") -> int:
    """Gate and time `route` (or every route); print the JSON lines and
    return the exit code."""
    names = list(ROUTES) if route == "all" else [route]
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        return _fail(f"--device {device}: no CUDA device is available")
    for name in names:
        chains = ROUTES[name].get("chains", 1)
        if batch % chains:
            return _fail(f"route {name}: chains {chains} must divide the "
                         f"batch {batch}", route=name)

    def paths(name, value, t_x, t_y):
        return mas_path(value, t_x, t_y, **ROUTES[name])

    # correctness gate: bit-identical to the reference oracle (two seeds)
    for seed in (0, 1):
        value, t_x, t_y = inputs(seed, batch, t_text, t_mel)
        want = np.stack([mas_single(value[i].copy(), int(t_x[i]), int(t_y[i]))
                         for i in range(batch)])
        on_dev = [torch.from_numpy(a).to(dev) for a in (value, t_x, t_y)]
        for name in names:
            out = paths(name, *on_dev).cpu().numpy().astype(np.int32)
            if not np.array_equal(out, want):
                return _fail(f"paths not bit-identical (route {name}, "
                             f"seed {seed})", route=name)

    on_dev = [torch.from_numpy(a).to(dev)
              for a in inputs(0, batch, t_text, t_mel)]
    label = device_label(dev)
    for name in names:
        times = call_ms(lambda: paths(name, *on_dev), dev)
        paths_per_sec = batch / (statistics.fmean(times) * 1e-3)
        print(json.dumps({
            "metric": METRIC,
            "value": round(paths_per_sec, 1),
            "unit": "paths/s",
            "vs_baseline": round(paths_per_sec / BASELINE_PATHS_PER_SEC, 2),
            "p50_align_step_ms": round(statistics.median(times), 4),
            "config": f"B={batch},T_text={t_text},T_mel={t_mel},ragged",
            "timing_method": ("cuda_events" if dev.type == "cuda"
                              else "host_clock"),
            "route": name,
            "device": label,
        }), flush=True)
    return 0
