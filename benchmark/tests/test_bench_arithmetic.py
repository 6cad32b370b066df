"""The yardstick's arithmetic on hand-computed shapes, and the trace
readers on a hand-written trace and on a recorded CPU profile."""
import json
import os
import types

import numpy as np
import pytest
import torch

from harness import peaks, spec
from harness import trace as tr
from harness import window

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_live_cells_and_bound_by_hand():
    # items: (t_x, t_y) = (2, 5) and (3, 4); (5, 4) has no path
    assert peaks.live_cells([2, 3, 5], [5, 4, 4]) == 2 * 5 + 3 * 4
    assert peaks.live_cells([2, 3, 5], [5, 4, 4], skip=True) == \
        5 * 5 + 7 * 4
    s, by = peaks.kernel_bound_s(cells=1000, in_lattices=2, out_bytes=4000,
                                 ops_per_cell=13, sfu_per_cell=3)
    terms = {"bytes": (8000 + 4000) / 3.35e12,
             "operations": 13000 / 67e12,
             "sfu": 3000 / (16 * 132 * 1.98e9)}
    assert by == max(terms, key=terms.get)
    assert s == pytest.approx(terms[by], rel=1e-12)


def test_roofline_files_count_each_kernel():
    batch = {"tokens": np.zeros((2, 4), np.int32),
             "mel": np.zeros((2, 10, 8), np.float32),
             "text_lengths": np.array([4, 2]),
             "mel_lengths": np.array([10, 7])}
    live, skip = 4 * 10 + 2 * 7, 9 * 10 + 5 * 7
    want = {"mas_kernel": (live, 1, 4 * 2 * 10 * 4, 3, 0),
            "forward_sum_alpha_kernel": (live, 1, 4 * 2 * 10 * 4 + 4 * 2 * 4,
                                         8, 2),
            "forward_sum_grad_kernel": (live, 2, 4 * 2 * 10 * 4, 13, 3),
            "mas_skip_kernel": (skip, 1, 4 * 2 * 10 * 9, 5, 0),
            "forward_sum_skip_alpha_kernel": (skip, 1,
                                              4 * 2 * 10 * 9 + 4 * 2 * 9,
                                              16, 4),
            "forward_sum_skip_gamma_kernel": (skip, 2, 4 * 2 * 10 * 9, 21,
                                              5)}
    for kernel, w in want.items():
        got = spec.roofline_of(kernel).work(batch)
        assert (got["cells"], got["in_lattices"], got["out_bytes"],
                got["ops_per_cell"], got["sfu_per_cell"]) == w, kernel


def test_family_flops_by_hand():
    fam = spec.load_module(os.path.join(BENCH, "families", "ota.py"),
                           "bench_family_ota")
    cfg = {"hidden": 4, "dim": 2, "n_mels": 3, "model_pauses": True,
           "use_recon": True}
    batch = {"text_lengths": np.array([2]), "mel_lengths": np.array([5])}
    text = 2 * 2 * (3 * 4 * 4 + 3 * 4 * 4 + 4 * 2)
    mel = 5 * 2 * (3 * 3 * 4 + 3 * 4 * 4 + 4 * 2)
    energy = 5 * 3 * 2 * 2
    recon = 3 * 2 * 2 * 3 + 5 * 3 * 2 * 3
    assert fam.flops(cfg, batch) == text + mel + energy + recon


def fake_trace(kind="train", steps=2):
    """Two steps of 1000 us each in a 3000 us window: conv 400 + 400 us,
    H1 100 us, an elementwise kernel 200 us, idle elsewhere; the host in
    pin_memory across the first gap."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": window.MARK,
         "ts": 0, "dur": 3000},
        {"ph": "X", "cat": "kernel", "name":
         "void cudnn::cnn::conv2d_grouped_direct_kernel<float>(int)",
         "ts": 100, "dur": 400},
        {"ph": "X", "cat": "kernel", "name":
         "void (anonymous namespace)::mas_kernel<4, true>(float const*)",
         "ts": 500, "dur": 100},
        {"ph": "X", "cat": "kernel", "name":
         "void at::native::vectorized_elementwise_kernel<4>(int)",
         "ts": 1200, "dur": 200},
        {"ph": "X", "cat": "kernel", "name":
         "void cudnn::cnn::conv2d_grouped_direct_kernel<float>(int)",
         "ts": 1400, "dur": 400},
        {"ph": "X", "cat": "cpu_op", "name": "aten::pin_memory",
         "ts": 650, "dur": 500, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::_pin_memory",
         "ts": 700, "dur": 400, "pid": 1, "tid": 1},
    ]
    batch = {"tokens": np.zeros((2, 4), np.int32),
             "mel": np.zeros((2, 10, 8), np.float32),
             "text_lengths": np.array([4, 2]),
             "mel_lengths": np.array([10, 7])}
    cfg = {"hidden": 4, "dim": 2, "n_mels": 8, "model_pauses": False,
           "use_recon": False, "compute_dtype": "float32"}
    fam = spec.load_module(os.path.join(BENCH, "families", "ota.py"),
                           "bench_family_ota")
    cell = types.SimpleNamespace(config=cfg, bench_dir=BENCH,
                                 family=lambda: fam)
    return ev, [batch] * steps, cell, kind


def load_fake(tmp_path, **kw):
    ev, batches, cell, kind = fake_trace(**kw)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return tr.load(str(path), len(batches), batches, kind, cell)


def read(name, t):
    return spec.metric_reader(name).read(t, name)


def test_readers_on_a_hand_written_trace(tmp_path):
    t = load_fake(tmp_path)
    assert t.window_s == pytest.approx(3e-3)
    assert tr.busy_s(t) == pytest.approx(1.1e-3)
    assert read("device_idle_share.train", t) == pytest.approx(
        100 * (1 - 1.1 / 3))
    assert read("conv_ms.train", t) == pytest.approx(0.4)
    assert read("torch_ops_ms.train", t) == pytest.approx(0.1)
    assert read("input_pin_ms.train", t) == pytest.approx(0.25)
    b = t.batches[0]
    bound = peaks.kernel_bound_s(**spec.roofline_of("mas_kernel").work(b))
    assert read("mas_kernel_roofline.train", t) == pytest.approx(
        100 * bound[0] / 1e-4)         # one call over two like batches
    assert read("forward_sum_alpha_kernel_roofline.train", t) is None
    fam = t.cell.family()
    assert read("train_mfu", t) == pytest.approx(
        100 * 3 * 2 * fam.flops(t.cell.config, b) / (3e-3 * 67e12))
    assert read("align_mfu", t) is None
    bd = tr.breakdown(t)
    assert bd["device_ops"][0] == [
        "cudnn::cnn::conv2d_grouped_direct_kernel<float>(int)",
        pytest.approx(8e-4)]
    # the gap 600-1200 us lies under pin_memory; 0-100 and 1800-3000 not
    assert dict(bd["idle_gaps"]) == {"aten::pin_memory": pytest.approx(6e-4),
                                     "host": pytest.approx(1.3e-3)}


def test_kernel_classes():
    table = tr.classes()
    assert tr.class_of("void (anonymous namespace)::forward_sum_grad_kernel"
                       "<2, 8>(float const*)", table) == "port"
    assert tr.class_of("void at::native::reduce_kernel<512, 1>(int)",
                       table) == "torch_ops"
    assert tr.class_of("Memcpy HtoD (Pinned -> Device)", table) == "copy"
    assert tr.identifier("void (anonymous namespace)::mas_kernel<4, true>"
                         "(float const*, long long)") == "mas_kernel"


def test_readers_on_a_recorded_cpu_profile(tmp_path):
    """A CPU session has no device events: every device reader finds
    nothing and says so, and none reads 0."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(window.MARK):
            for _ in range(3):
                torch.nn.functional.conv1d(x[None], x[:, :, None]).relu()
    path = tmp_path / "cpu.json"
    prof.export_chrome_trace(str(path))
    _, batches, cell, _ = fake_trace()
    t = tr.load(str(path), 2, batches, "train", cell)
    assert t.device == [] and t.window_s > 0
    assert any(o.name == "aten::conv1d" for o in t.cpu_ops)
    for name in ("device_idle_share.train", "conv_ms.train",
                 "torch_ops_ms.train", "input_pin_ms.train",
                 "mas_kernel_roofline.train"):
        assert read(name, t) is None, name
    assert tr.breakdown(t)["device_ops"] == []
