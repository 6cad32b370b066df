"""A configuration, a traffic mix and a per-layer metric added as files
alone are found and run, with no edit to the harness."""
import json
import os

import pytest

import tiny
from harness import spec

NEW_METRIC = '''
def read(trace, name):
    return float(trace.steps)
'''


def test_added_files_are_found_and_run(tmp_path):
    import run
    bj = tiny.make(str(tmp_path), cells=())
    bench = tmp_path / "benchmark"
    with open(bench / "configs" / "ota_f32.json") as f:
        conf = json.load(f)
    conf.update(tiny.TINY_MODEL, temperature=0.3)
    (bench / "configs" / "ota_warm.json").write_text(json.dumps(conf))
    mix = dict(tiny.TINY_TRAIN, path="train", noise=0.5)
    (bench / "traffic" / "tiny_mix.json").write_text(json.dumps(mix))
    (bench / "limits" / "ota_warm.tiny_mix.json").write_text(json.dumps(
        {"loss": 1e-4, "grad": 1e-3, "change": 1e-3, "path": 1e-3}))
    (bench / "metrics" / "steps_traced.py").write_text(NEW_METRIC)
    with open(bj) as f:
        s = json.load(f)
    s["configs"].append({"name": "ota_warm", "source": "test",
                         "file": "benchmark/configs/ota_warm.json",
                         "reduced": [], "why": "test"})
    s["workloads"].append({"name": "ota_warm.tiny_mix",
                           "config": "ota_warm", "traffic": "tiny_mix",
                           "chips": 1, "why": "test"})
    s["per_layer"].append({"name": "steps_traced", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "train step",
                           "moves": "train_frames_per_s",
                           "workloads": ["ota_warm.tiny_mix"]})
    s["end_to_end"][0]["workloads"].append("ota_warm.tiny_mix")
    with open(bj, "w") as f:
        json.dump(s, f)
    cell = spec.load_cell("ota_warm.tiny_mix", bj, str(bench))
    assert cell.config["temperature"] == 0.3
    assert cell.traffic["noise"] == 0.5
    assert "steps_traced" in [m["name"] for m in cell.per_layer]
    res = run.run_cell(cell, 3, 1.5, True, "cpu")
    assert res["correct"]
    assert res["metrics"]["steps_traced"]["value"] >= 1
    assert res["metrics"]["steps_traced"]["unit"] == "steps"
    res = run.run_cell(cell, 3, 0.5, False, "cpu")
    assert set(res["metrics"]) == {"train_frames_per_s", "setup_s"}


def test_metric_reader_lookup(tmp_path):
    assert spec.metric_reader("conv_ms.train").__name__.startswith(
        "bench_metric_conv_ms")
    assert spec.metric_reader("mas_kernel_roofline.align").__name__ \
        .startswith("bench_metric_roofline")
    with pytest.raises(spec.SpecError):
        spec.metric_reader("no_such_metric.train")


def test_every_benchmark_entry_resolves():
    root = os.path.dirname(spec.BENCH_DIR)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        s = json.load(f)
    for w in s["workloads"]:
        cell = spec.load_cell(w["name"])
        cell.family(), cell.path()
        assert set(cell.limits) >= {"loss", "path"}
        for m in cell.per_layer:
            spec.metric_reader(m["name"])
            base = m["name"].split(".")[0]
            if base.endswith("_roofline"):
                spec.roofline_of(base.removesuffix("_roofline"))


@pytest.mark.parametrize("name,throughput", [
    ("ota_f32.train_long", "train_frames_per_s"),
    ("ota_pauses_bf16.train_long", "train_frames_per_s.pauses"),
    ("ota_f32.align_long", "align_frames_per_s")])
def test_cell_reports_its_own_end_to_end_metrics(tmp_path, name,
                                                 throughput):
    """A metric `<base>.<suffix>` carries the path's `<base>` in the cells
    it lists, under a bound of its own."""
    import run
    bj = tiny.make(str(tmp_path))
    cell = spec.load_cell(name, bj, str(tmp_path / "benchmark"))
    res = run.run_cell(cell, 5, 0.5, False, "cpu")
    assert set(res["metrics"]) == {throughput, "setup_s"}
    assert res["metrics"][throughput]["value"] > 0
