"""A whole run, past the look for a card, with the timed path broken
underneath: `correct` has to come out false for each fault a cell can
have (one chip: no exchange between chips to leave out), and true with
none."""
import pytest

import tiny
from harness import faults, spec

TRAIN = ("ota_f32.train_long", "ota_pauses_bf16.train_long")
ALIGN = ("ota_f32.align_long",)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    return tiny.make(str(root)), str(root / "benchmark")


def run_cell(bench, name, fault=None):
    import run
    cell = spec.load_cell(name, *bench)
    if fault is None:
        return run.run_cell(cell, 11, 0.5, False, "cpu")
    with faults.plant(fault, cell):
        return run.run_cell(cell, 11, 0.5, False, "cpu")


@pytest.mark.parametrize("name", TRAIN + ALIGN)
def test_sound_run_is_correct(bench, name):
    assert run_cell(bench, name)["correct"]


@pytest.mark.parametrize("name,fault", [
    *[(n, f) for n in TRAIN for f in ("state_unchanged", "half_batch",
                                      "answer_altered", "bin_detached")],
    *[(n, f) for n in ALIGN for f in ("half_batch", "answer_altered")]])
def test_fault_is_not_correct(bench, name, fault):
    res = run_cell(bench, name, fault)
    assert not res["correct"]
    failed = [k for k, c in res["checks"].items()
              if not c["value"] <= c["limit"]]
    assert failed, res["checks"]
