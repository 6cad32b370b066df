"""run.py's refusals: no card, no program beside it, JAX in the process;
and a set-up that loads nothing of JAX or the JAX package."""
import json
import os
import shutil
import subprocess
import sys

import tiny

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def run_py(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ota_f32.train_long", "--seed", "1", "--seconds", "1", "--trace",
         "0", *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    """Where torch sees no CUDA device the run fails and prints no result:
    it never falls back to the CPU."""
    out = run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "aligner_tpu_torchish", sys)
    assert "aligner_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "aligner_tpu.ops", sys)
    assert run.forbidden_modules() == ["aligner_tpu"]


SETUP = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}, {tests!r}]
import tiny, run
from harness import spec
bj = tiny.make({tmp!r})
for name in ("ota_f32.train_long", "ota_pauses_bf16.train_long",
             "ota_f32.align_long"):
    cell = spec.load_cell(name, bj, {tmp!r} + "/benchmark")
    assert run.run_cell(cell, 2**31 + 1, 0.5, False, "cpu")["correct"]
print(json.dumps(run.forbidden_modules()))
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] == "aligner_tpu_torch"))[:200])
"""


def test_setup_loads_no_jax(tmp_path):
    """A tiny set-up, window and check in a fresh process leaves no
    module whose top-level name is jax, jaxlib, flax or aligner_tpu
    (while the port, whose name begins with aligner_tpu, is loaded)."""
    code = SETUP.format(bench=BENCH, root=ROOT,
                        tests=os.path.join(BENCH, "tests"),
                        tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []
    assert "aligner_tpu_torch" in lines[-1]
