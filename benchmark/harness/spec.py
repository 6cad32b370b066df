"""A cell's files, found by the names that `BENCHMARK.json` gives.

Whatever belongs to one configuration, one traffic mix, one model
family, one path, one per-layer metric or one kernel sits in a file of
its own under the benchmark's folder:

    configs/<config>.json        the configuration; `family` names its family
    families/<family>.py         how the program builds it, its FLOPs, its
                                 plain reference, what the paths keep of a
                                 forward pass and compare, its faults
    traffic/<traffic>.json       the traffic mix; `path` names its path
    paths/<path>.py              what the window drives
    limits/<cell>.json           the limits of the comparison that decides
                                 `correct`
    metrics/<metric>.py          a per-layer metric's reader: the file of the
                                 whole name, else of the part before the
                                 first dot, else, for `<kernel>_roofline...`,
                                 metrics/roofline.py
    roofline/<kernel>.py         a kernel's bytes and operations

There is no table of names in the code: a new cell, mix or metric is new
files and new entries in `BENCHMARK.json`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class SpecError(Exception):
    """A name that `BENCHMARK.json` or a cell's files do not resolve."""


def load_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"missing file {os.path.relpath(path, ROOT)}")


def load_module(path: str, name: str):
    """Import the Python file `path` once, under `name` and a tag of the
    path (two benchmark folders may hold files of one name)."""
    if not os.path.exists(path):
        raise SpecError(f"missing file {os.path.relpath(path, ROOT)}")
    name = f"{name}_{hashlib.sha1(path.encode()).hexdigest()[:8]}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything it names."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench_dir: str = BENCH_DIR

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def family(self):
        fam = self.config["family"]
        return load_module(os.path.join(self.bench_dir, "families",
                                        f"{fam}.py"), f"bench_family_{fam}")

    def path(self):
        p = self.traffic["path"]
        return load_module(os.path.join(self.bench_dir, "paths", f"{p}.py"),
                           f"bench_path_{p}")


def _for_cell(metric: dict, cell: str, reported: set) -> bool:
    """A metric belongs to a cell when its `workloads` name the cell, or,
    without `workloads`, when the cell reports the metric it moves (an
    end-to-end metric without `workloads` belongs to every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(name: str, bench_json: str | None = None,
              bench_dir: str = BENCH_DIR) -> Cell:
    bench_json = bench_json or os.path.join(ROOT, "BENCHMARK.json")
    root = os.path.dirname(os.path.abspath(bench_json))
    spec = load_json(bench_json)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    conf = next((c for c in spec["configs"] if c["name"] == entry["config"]),
                None)
    if conf is None:
        raise SpecError(f"workload {name!r} names no known config")
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     f"{entry['traffic']}.json"))
    limits = load_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    e2e = [m for m in spec["end_to_end"] if _for_cell(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _for_cell(m, name, reported)]
    return Cell(name, entry, config, traffic, limits, e2e, per_layer,
                bench_dir)


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The module whose `read(trace)` gives the per-layer metric `name`."""
    base = name.split(".")[0]
    candidates = [name, base]
    if base.endswith("_roofline"):
        candidates.append("roofline")
    for c in candidates:
        path = os.path.join(bench_dir, "metrics", f"{c}.py")
        if os.path.exists(path):
            return load_module(path, f"bench_metric_{c.replace('.', '_')}")
    raise SpecError(f"no reader for per-layer metric {name!r} under "
                    "metrics/")


def roofline_of(kernel: str, bench_dir: str = BENCH_DIR):
    """The module with a kernel's trace names and per-call work."""
    return load_module(os.path.join(bench_dir, "roofline", f"{kernel}.py"),
                       f"bench_roofline_{kernel}")
