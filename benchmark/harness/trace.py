"""Reading a `torch.profiler` chrome trace of the window's traced stretch.

The parsing of device events follows the port's
`aligner_tpu_torch/utils/profiling.py` (`device_op_durations`,
`short_name`), copied so that the yardstick does not move when the
program does: the device's events are the categories `kernel`,
`gpu_memcpy` and `gpu_memset`; a kernel's name loses a leading `void `
and every `(anonymous namespace)::`. Kernels fall into classes by the
patterns of `kernel_classes.json`, the first class that matches.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re

from . import window

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
CLASSES_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "kernel_classes.json")
NAME_CHARS = 120        # a breakdown entry's name, at most


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return name[5:] if name.startswith("void ") else name


def identifier(name: str) -> str:
    """A kernel's function name without namespaces, template arguments or
    parameters: `void ns::foo<4>(float*)` -> `foo`."""
    head = re.split(r"[<(]", short_name(name), maxsplit=1)[0]
    return head.rsplit("::", 1)[-1].strip()


@dataclasses.dataclass
class Event:
    name: str
    ts: float           # microseconds
    dur: float
    tid: object = None


@dataclasses.dataclass
class Trace:
    """The traced stretch: device events, top-level CPU operators, the
    window mark, and what the path ran in it: `steps` steps or batches,
    whose padded batches (`batches`, numpy dicts with `text_lengths`,
    `mel_lengths`, `tokens` and `mel`) and FLOPs the readers use."""
    device: list
    cpu_ops: list
    mark: Event
    steps: int
    batches: list
    kind: str
    cell: object

    @property
    def window_s(self) -> float:
        return self.mark.dur / 1e6

    def clipped(self):
        """Device events clipped to the window mark, as (start, end)."""
        a, b = self.mark.ts, self.mark.ts + self.mark.dur
        out = []
        for e in self.device:
            s, t = max(e.ts, a), min(e.ts + e.dur, b)
            if t > s:
                out.append((s, t))
        return out


def load(path: str, steps: int, batches: list, kind: str, cell) -> Trace:
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    mark = next((e for e in events if e.get("name") == window.MARK
                 and e.get("cat") == "user_annotation"), None)
    if mark is None:
        raise RuntimeError("the trace holds no window mark")
    mark = Event(mark["name"], float(mark["ts"]), float(mark["dur"]))
    device = [Event(e["name"], float(e["ts"]), float(e["dur"]))
              for e in events if e.get("cat") in DEVICE_CATEGORIES]
    cpu = [Event(e["name"], float(e["ts"]), float(e["dur"]),
                 (e.get("pid"), e.get("tid")))
           for e in events if e.get("cat") == "cpu_op"]
    return Trace(device, _top_level(cpu), mark, steps, batches, kind, cell)


def _top_level(ops: list) -> list:
    """The CPU operators that no other operator of their thread encloses."""
    out, ends = [], {}
    for e in sorted(ops, key=lambda e: (e.ts, -e.dur)):
        if e.ts >= ends.get(e.tid, float("-inf")):
            out.append(e)
            ends[e.tid] = e.ts + e.dur
    return out


def merged(intervals: list) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which some operation ran on the device."""
    return sum(t - s for s, t in merged(trace.clipped())) / 1e6


def classes() -> dict:
    with open(CLASSES_FILE) as f:
        spec = json.load(f)
    return {k: [re.compile(p) for p in v] for k, v in spec.items()
            if not k.startswith("_")}


def class_of(name: str, table: dict) -> str:
    short = short_name(name)
    for cls, patterns in table.items():
        if any(p.search(short) for p in patterns):
            return cls
    return "other"


def seconds_by_class(trace: Trace) -> dict:
    table = classes()
    out: dict = {}
    for e in trace.device:
        c = class_of(e.name, table)
        out[c] = out.get(c, 0.0) + e.dur / 1e6
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device named by the host operator running across them
    ("host" where none was)."""
    by_op: dict = {}
    for e in trace.device:
        key = short_name(e.name)[:NAME_CHARS]
        by_op[key] = by_op.get(key, 0.0) + e.dur / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    busy = merged(trace.clipped())
    a, b = trace.mark.ts, trace.mark.ts + trace.mark.dur
    edges = [a] + [x for s, t in busy for x in (s, t)] + [b]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    threads: dict = {}
    for o in trace.cpu_ops:             # top-level: disjoint in a thread
        threads.setdefault(o.tid, []).append(o)
    starts = {k: [o.ts for o in v] for k, v in threads.items()}
    named: dict = {}
    for s, t in gaps:
        mid = (s + t) / 2
        host = "host"
        for k, ops_k in threads.items():
            i = bisect.bisect_right(starts[k], mid) - 1
            if i >= 0 and mid <= ops_k[i].ts + ops_k[i].dur:
                host = ops_k[i].name[:NAME_CHARS]
                break
        named[host] = named.get(host, 0.0) + (t - s) / 1e6
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
