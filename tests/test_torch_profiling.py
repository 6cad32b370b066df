"""`aligner_tpu_torch.utils.profiling` on the CPU: the chrome-trace reader
on traces torch.profiler writes here (CPU activities only, so the reader
falls back to the top-level CPU operators) and on a written trace with
device events; `measure_device_time` and `device_time_by_kernel` over
CPU activities, the retry of an empty session, and the error when nothing
matches, and a CUDA session whose trace holds CPU operators but no
kernel (as an empty CUPTI session does), which counts as empty and is
profiled again. The card's case (`mas_kernel` by its device time) is in
tests/test_torch_package.py under the `cuda` mark."""
import gzip
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aligner_tpu_torch.utils import profiling


def cpu_trace(path):
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            torch.mm(a, a)
            torch.relu(a)
    prof.export_chrome_trace(str(path))
    return str(path)


def test_cpu_trace_gives_the_top_level_operators(tmp_path):
    durs = profiling.device_op_durations(cpu_trace(tmp_path / "t.json"))
    assert len(durs["aten::mm"]) == 3 and len(durs["aten::relu"]) == 3
    # aten::relu calls aten::clamp_min inside: only the outer one counts
    assert "aten::clamp_min" not in durs
    assert all(0 < d < 10 for ds in durs.values() for d in ds)


def test_directory_reads_its_newest_trace_gzipped_or_not(tmp_path):
    first = cpu_trace(tmp_path / "a.json")
    with open(first, "rb") as f, gzip.open(tmp_path / "b.json.gz",
                                           "wb") as g:
        g.write(f.read())
    os.utime(tmp_path / "b.json.gz", (2e9, 2e9))
    assert profiling.device_op_durations(str(tmp_path)) == \
        profiling.device_op_durations(first)
    with pytest.raises(FileNotFoundError):
        profiling.device_op_durations(str(tmp_path / "empty_dir_missing"))


def write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


KERNEL = "void (anonymous namespace)::mas_kernel(float const*, int)"


def test_device_events_win_over_cpu_operators(tmp_path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
         "dur": 50, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1, "dur": 5, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": KERNEL, "ts": 10, "dur": 12.5,
         "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": KERNEL, "ts": 30, "dur": 7.5,
         "pid": 0, "tid": 7},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "ts": 40, "dur": 1.0, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step",
         "ts": 0, "dur": 60, "pid": 0, "tid": 8},
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 1, "pid": 1,
         "tid": 1},
    ]
    durs = profiling.device_op_durations(write_trace(tmp_path / "t.json",
                                                     events))
    assert durs == {KERNEL: [12.5e-6, 7.5e-6], "Memset (Device)": [1e-6]}


def test_prefix_matches_the_kernels_short_name():
    assert profiling.short_name(KERNEL) == "mas_kernel(float const*, int)"
    assert profiling._matches(KERNEL, "mas_kernel")
    assert profiling._matches(KERNEL, "void (anonymous")
    assert not profiling._matches(KERNEL, "mas_walk")
    assert profiling._matches("aten::mm", None)


def test_measure_device_time_over_cpu_activities():
    a = torch.randn(128, 128)
    calls = []

    def fn(x):
        calls.append(1)
        return torch.relu(torch.mm(x, x))

    by_kernel = profiling.device_time_by_kernel(fn, a, iters=4)
    assert set(by_kernel) == {"aten::mm", "aten::relu"}
    assert all(0 < s < 1 for s in by_kernel.values())
    assert len(calls) == 1 + 4                  # a warm-up, then iters
    only = profiling.device_time_by_kernel(fn, a, iters=4,
                                           name_prefix="aten::mm")
    assert set(only) == {"aten::mm"}
    assert 0 < profiling.measure_device_time(fn, a, iters=4) < 1


def test_no_match_raises_after_every_try():
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(4) + 1

    with pytest.raises(RuntimeError, match="no device events matching"):
        profiling.measure_device_time(fn, iters=2, name_prefix="mas_kernel")
    assert len(calls) == 1 + 2 * profiling.PROFILE_TRIES


def test_an_empty_session_is_profiled_again(monkeypatch):
    """A session with no records (as CUPTI sometimes returns one) does not
    end the measurement: the next session's events count."""
    real = profiling.device_op_durations
    sessions = []

    def first_empty(trace, **kwargs):
        sessions.append(trace)
        return {} if len(sessions) == 1 else real(trace, **kwargs)

    monkeypatch.setattr(profiling, "device_op_durations", first_empty)
    a = torch.randn(32, 32)
    assert profiling.measure_device_time(torch.mm, a, a, iters=2) > 0
    assert len(sessions) == 2


CPU_OPS = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::eq", "ts": 0, "dur": 40,
     "pid": 1, "tid": 1},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1,
     "dur": 5, "pid": 1, "tid": 1},
]
KERNELS = [
    {"ph": "X", "cat": "kernel", "name": KERNEL, "ts": 10, "dur": 6.0,
     "pid": 0, "tid": 7},
    {"ph": "X", "cat": "kernel", "name": KERNEL, "ts": 20, "dur": 2.0,
     "pid": 0, "tid": 7},
]


def test_device_only_trace_without_device_events_is_empty(tmp_path):
    trace = write_trace(tmp_path / "t.json", CPU_OPS)
    assert profiling.device_op_durations(trace) == {"aten::eq": [40e-6]}
    assert profiling.device_op_durations(trace, device_only=True) == {}


def fake_cuda_sessions(monkeypatch, traces):
    """Stand in for a CUDA machine whose profiler sessions export the given
    traces' events in turn; returns the activities each session asked for."""
    asked = []

    class Session:
        def __init__(self, activities):
            asked.append(list(activities))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            write_trace(path, traces[min(len(asked), len(traces)) - 1])

    monkeypatch.setattr(profiling.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling.torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(profiling, "profile", Session)
    return asked


def test_a_cuda_session_without_kernels_is_profiled_again_then_raises(
        monkeypatch):
    """Host operators of a CUDA session are never read as device time:
    without a kernel the session is empty, is profiled again, and after
    PROFILE_TRIES sessions the measurement raises."""
    asked = fake_cuda_sessions(monkeypatch, [CPU_OPS])
    with pytest.raises(RuntimeError, match="no device events matching None"):
        profiling.measure_device_time(lambda: None, iters=2)
    assert len(asked) == profiling.PROFILE_TRIES
    assert all(profiling.ProfilerActivity.CUDA in a for a in asked)


def test_a_cuda_session_after_an_empty_one_counts_its_kernels_only(
        monkeypatch):
    asked = fake_cuda_sessions(monkeypatch, [CPU_OPS, CPU_OPS + KERNELS])
    by_kernel = profiling.device_time_by_kernel(lambda: None, iters=2)
    assert len(asked) == 2
    assert by_kernel == pytest.approx({KERNEL: 4e-6})
