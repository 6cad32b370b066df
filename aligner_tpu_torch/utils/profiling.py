"""Device-time measurement over `torch.profiler` (port of
aligner_tpu/utils/profiling.py).

A host clock around a call reads the host's launch work as much as the
card, and on a shared host it moves with the neighbours: walls moved
1.5-3x between runs while the kernels' device time held. The measure here
is the device time of the kernels a call launched, read from a
`torch.profiler` trace. `chip_smoke.py` takes its kernel times from it, and
users can time their own kernels with it.

Kernel names in a trace carry a return type and namespaces
(`void (anonymous namespace)::mas_kernel(float const*, ...)`); a name
prefix is matched against the name with a leading `void ` and every
`(anonymous namespace)::` taken out, as well as against the name itself.
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile

# Categories of a torch.profiler chrome trace that run on the device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# Now and then CUPTI hands back a session with no kernel records at all;
# such a session is profiled again, up to this many sessions in all.
PROFILE_TRIES = 3


def _trace_file(trace: str) -> str:
    if os.path.isdir(trace):
        files = [f for pattern in ("*.json", "*.json.gz")
                 for f in glob.glob(os.path.join(trace, "**", pattern),
                                    recursive=True)]
        if not files:
            raise FileNotFoundError(f"no chrome trace under {trace}")
        return max(files, key=os.path.getmtime)
    return trace


def _top_level(ops: list[dict]) -> list[dict]:
    """The CPU operators that no other operator of their thread encloses."""
    out = []
    ends: dict = {}
    for e in sorted(ops, key=lambda e: (e["ts"], -e["dur"])):
        key = (e.get("pid"), e.get("tid"))
        if e["ts"] >= ends.get(key, float("-inf")):
            out.append(e)
            ends[key] = e["ts"] + e["dur"]
    return out


def device_op_durations(trace: str, *, device_only: bool = False
                        ) -> dict[str, list[float]]:
    """{name: [seconds]} of the device events (kernels, copies, fills) of a
    `torch.profiler` chrome trace: a file (`.json` or `.json.gz`), or the
    newest such file under a directory.

    A trace with no device events (a session with only CPU activities, as
    on a machine without CUDA) gives its top-level CPU operators instead:
    host time, never to be reported as a device time. With `device_only`
    (a session that asked for CUDA activity) such a trace gives {}.
    """
    path = _trace_file(trace)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    chosen = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if not chosen and not device_only:
        chosen = _top_level([e for e in events if e.get("cat") == "cpu_op"])
    durs: dict[str, list[float]] = collections.defaultdict(list)
    for e in chosen:
        durs[e["name"]].append(float(e["dur"]) / 1e6)
    return dict(durs)


def short_name(name: str) -> str:
    """A kernel's name without a leading `void ` and without
    `(anonymous namespace)::`."""
    name = name.replace("(anonymous namespace)::", "")
    return name[5:] if name.startswith("void ") else name


def _matches(name: str, prefix: str | None) -> bool:
    return prefix is None or name.startswith(prefix) or \
        short_name(name).startswith(prefix)


def device_time_by_kernel(fn, *args, iters: int = 20,
                          name_prefix: str | None = None
                          ) -> dict[str, float]:
    """Mean device seconds per call of `fn(*args)`, by kernel name.

    Calls fn once to warm up (builds, caches), then profiles `iters`
    calls, synchronised at the end, and sums each device event's time over
    the session. With `name_prefix`, only the kernels whose name starts
    with it count. A session in which the profiler recorded nothing that
    matches is profiled again, up to PROFILE_TRIES sessions; then it raises
    RuntimeError. A CUDA session without device events (CUPTI recorded
    none) counts as empty, whatever CPU operators it holds. Without CUDA
    the session holds CPU activities only, and the times are the top-level
    CPU operators' (see `device_op_durations`).
    """
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    fn(*args)
    if cuda:
        torch.cuda.synchronize()
    seen: list[str] = []
    for _ in range(PROFILE_TRIES):
        with profile(activities=activities) as prof:
            for _ in range(iters):
                fn(*args)
            if cuda:
                torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(prefix="aligner_prof_") as d:
            prof.export_chrome_trace(os.path.join(d, "trace.json"))
            durs = device_op_durations(d, device_only=cuda)
        matched = {name: sum(ds) / iters for name, ds in durs.items()
                   if _matches(name, name_prefix)}
        if matched:
            return matched
        seen = list(durs)[:5]
    raise RuntimeError(
        f"no device events matching {name_prefix!r} in {PROFILE_TRIES} "
        f"profiler sessions (have: {seen})")


def measure_device_time(fn, *args, iters: int = 20,
                        name_prefix: str | None = None) -> float:
    """Mean device seconds per call of `fn(*args)`: of every kernel it
    launched (the counterpart of the JAX package's whole jit program), or,
    with `name_prefix`, of the kernels whose name starts with it. See
    `device_time_by_kernel`."""
    return sum(device_time_by_kernel(fn, *args, iters=iters,
                                     name_prefix=name_prefix).values())
