"""On the card, at each cell's own size: the control (the reference one
precision below the configuration's, in the program's place) comes out
not correct under the cell's limits. Skips where torch sees no CUDA
device; `calibrate.py` reads the same on more seeds."""
import json
import os

import pytest

from harness import compare, spec

ROOT = os.path.dirname(spec.BENCH_DIR)
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name):
    cell = spec.load_cell(name)
    numbers = cell.path().control(cell, 2**31 + 77, card)
    checks = compare.judge(numbers, cell.limits)
    assert not compare.correct(checks), checks
