"""The readers of the program's own spans (`harness/spans.py`): the idle
share split by the issuing thread's innermost span on a hand-written
trace, the base rule of the trace's clock, spans outside the mark, a
program without spans, and a tiny traced run on the CPU."""
import pytest

import tiny
from harness import spans as sp
from harness import spec
from harness import trace as tr
from harness import window

PERIOD_NS = sp.BASE_PERIOD_S * 10**9
BASE_NS = 227 * PERIOD_NS            # a trace's base, in 2026


class Span:
    """The fields of the program's recorded span that the readers use."""

    def __init__(self, name, thread, ts, end, base=BASE_NS):
        self.name, self.thread = name, thread
        self.start_ns = base + int(ts * 1e3)
        self.end_ns = base + int(end * 1e3)


def hand_trace(mark_ts=1000.0):
    """Mark [1000, 1100] us; the device busy over [1010, 1040] and
    [1070, 1080]: idle 10 + 30 + 20 us, 60% of the mark."""
    device = [tr.Event("k", mark_ts + s, d) for s, d in
              ((10, 20), (25, 15), (70, 10))]
    return tr.Trace(device, [], tr.Event(window.MARK, mark_ts, 100.0), 2,
                    [], "train", None)


def hand_spans(base=BASE_NS, at=1000.0):
    """Thread 1 runs the model's forward; thread 2's spans are ignored.
    The idle splits into input 10 us ([1000, 1010]), issue 20 us
    (`model.encode` 5, `model.forward` 14, `step.forward` 1 in
    [1040, 1060]) and other 30 us (`train.step` 10 + 5 + 5, `train.log`
    10). One span starts before the mark, and `train.log` ends past it."""
    rows = [("train.step", 1, 0, 100), ("input.next", 1, 0, 15),
            ("step.forward", 1, 15, 60), ("model.forward", 1, 16, 59),
            ("model.encode", 1, 16, 45), ("train.log", 1, 85, 95),
            ("input.next", 2, 0, 100), ("step.update", 1, -50, 5)]
    return [Span(n, t, at + s, at + e, base) for n, t, s, e in rows]


def shares(monkeypatch, trace, spans):
    monkeypatch.setattr(sp, "recorded", lambda: spans)
    return {k: sp.idle_share(trace, k) for k in ("input", "issue", "other")}


def test_idle_splits_by_the_innermost_span(monkeypatch):
    trace = hand_trace()
    got = shares(monkeypatch, trace, hand_spans())
    assert got == pytest.approx({"input": 10.0, "issue": 20.0,
                                 "other": 30.0}, abs=1e-9)
    idle = 100.0 * (1.0 - tr.busy_s(trace) / trace.window_s)
    assert abs(sum(got.values()) - idle) < 1e-9
    by_span = sp.idle_by_span(trace)
    assert by_span["model.encode"] == pytest.approx(5e-6)
    assert by_span["model.forward"] == pytest.approx(14e-6)
    assert by_span["train.log"] == pytest.approx(10e-6)
    assert by_span.get(None, 0.0) == pytest.approx(0.0, abs=1e-12)


def test_idle_outside_every_span_is_other(monkeypatch):
    trace = hand_trace()
    got = shares(monkeypatch, trace,
                 [Span("model.forward", 1, 1010, 1020)])
    assert got["input"] == 0.0 and got["issue"] == 0.0
    assert got["other"] == pytest.approx(60.0)


def test_a_base_before_the_spans_own(monkeypatch):
    """A trace whose base was taken before a period's boundary: its spans
    map under the base before their own."""
    ts = PERIOD_NS / 1e3 + 1000.0
    trace = hand_trace(mark_ts=ts)
    spans = hand_spans(base=BASE_NS, at=ts)
    assert spans[0].start_ns // PERIOD_NS * PERIOD_NS == BASE_NS + PERIOD_NS
    got = shares(monkeypatch, trace, spans)
    assert got == pytest.approx({"input": 10.0, "issue": 20.0,
                                 "other": 30.0}, abs=1e-6)


def test_spans_outside_the_mark_are_ignored(monkeypatch):
    trace = hand_trace()
    spans = hand_spans(at=5000.0)
    monkeypatch.setattr(sp, "recorded", lambda: spans)
    assert sp.in_mark(trace) is None
    assert shares(monkeypatch, trace, spans) == {
        "input": None, "issue": None, "other": None}
    assert sp.host_s(trace, "input.next") is None
    spans = hand_spans() + hand_spans(at=5000.0)
    monkeypatch.setattr(sp, "recorded", lambda: spans)
    kept = sp.in_mark(trace)
    assert len(kept) == 7            # `step.update` starts before the mark
    assert all(1000.0 <= s.ts <= s.end <= 1100.0 for s in kept)


def test_no_recorded_span_reads_nothing(monkeypatch):
    trace = hand_trace()
    assert shares(monkeypatch, trace, []) == {
        "input": None, "issue": None, "other": None}
    assert shares(monkeypatch, trace, None)["issue"] is None


def test_input_host_ms_reads_the_issuing_threads_input(monkeypatch):
    trace = hand_trace()
    monkeypatch.setattr(sp, "recorded", hand_spans)
    reader = spec.metric_reader("input_host_ms.train")
    # thread 1's `input.next`: 15 us over the trace's 2 steps
    assert reader.read(trace, "input_host_ms.train") == pytest.approx(
        1e3 * 15e-6 / 2)


def test_traced_tiny_train_run_reads_input_host_ms(tmp_path):
    import run
    bj = tiny.make(str(tmp_path))
    cell = spec.load_cell("ota_f32.train_long", bj,
                          str(tmp_path / "benchmark"))
    assert "input_host_ms.train" in [m["name"] for m in cell.per_layer]
    res = run.run_cell(cell, 2**31 + 7, 1.5, True, "cpu")
    assert res["correct"]
    assert res["metrics"]["input_host_ms.train"]["value"] > 0
    assert res["metrics"]["input_host_ms.train"]["unit"] == "ms/step"
