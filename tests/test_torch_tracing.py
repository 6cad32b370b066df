"""`aligner_tpu_torch.utils.tracing` on the CPU: no span outside a
profiler session; nesting, parents and threads inside one; the spans on
the chrome trace's clock (each `record_function` twin inside its span);
the span tree of `train_aligner`'s steps, plain and with pauses, and of an
eval-mode forward; and training that a profiler session leaves bit for
bit as it was."""
import json
import statistics
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aligner_tpu_torch import OTAAligner, OTAConfig
from aligner_tpu_torch.train.loop import train_aligner
from aligner_tpu_torch.utils import tracing

VOCAB, N_MELS, DIM, HIDDEN = 20, 16, 16, 16
B, T_X, T_Y = 4, 12, 40
BASE_PERIOD_S = 7889238     # libkineto's ChromeTraceBaseTime period
MODEL_CHILDREN = ["model.encode", "model.lattice", "model.prior",
                  "model.forward_sum", "model.mas", "model.losses"]
STEP_CHILDREN = ["input.next", "step.forward", "step.backward",
                 "step.update", "train.log"]


def make_batch(seed):
    rng = np.random.default_rng(seed)
    text_lengths = rng.integers(T_X // 2, T_X + 1, B).astype(np.int32)
    text_lengths[0] = T_X
    mel_lengths = np.maximum(text_lengths,
                             rng.integers(T_Y // 2, T_Y + 1, B)).astype(
                                 np.int32)
    mel_lengths[0] = T_Y
    return {"tokens": rng.integers(0, VOCAB, (B, T_X)).astype(np.int32),
            "mel": rng.standard_normal((B, T_Y, N_MELS)).astype(np.float32),
            "text_lengths": text_lengths, "mel_lengths": mel_lengths}


def tiny_model(pauses=False):
    kw = dict(vocab_size=VOCAB, n_mels=N_MELS, dim=DIM, hidden=HIDDEN,
              use_recon=True)
    if pauses:
        kw.update(model_pauses=True, pause_silence_anchor=0.5)
    return OTAAligner(OTAConfig(**kw))


def cpu_session():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


def children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


def test_no_session_no_spans():
    assert not torch.autograd._profiler_enabled()
    first, second = tracing.span("train.step", step=0), tracing.span("x")
    assert first is second
    with first:
        with tracing.span("model.forward"):
            pass
    assert tracing.spans() == []


def test_spans_nest_with_their_parents_and_thread():
    with cpu_session():
        with tracing.span("outer", step=3):
            with tracing.span("middle"):
                with tracing.span("inner"):
                    pass
            with tracing.span("sibling"):
                pass
        with tracing.span("root2"):
            pass
    spans = {s.name: s for s in tracing.spans()}
    assert list(spans) == ["inner", "middle", "sibling", "outer", "root2"]
    assert spans["outer"].parent is None and spans["root2"].parent is None
    assert spans["middle"].parent == spans["outer"].id
    assert spans["sibling"].parent == spans["outer"].id
    assert spans["inner"].parent == spans["middle"].id
    assert spans["outer"].step == 3 and spans["inner"].step is None
    assert len({s.id for s in spans.values()}) == 5
    assert {s.thread for s in spans.values()} == {threading.get_native_id()}
    for s in spans.values():
        assert s.start_ns <= s.end_ns
    assert spans["outer"].start_ns <= spans["middle"].start_ns
    assert spans["inner"].end_ns <= spans["middle"].end_ns


def test_each_thread_keeps_its_own_parents(monkeypatch):
    """Spans open on one thread are never the parents of another thread's
    spans. (A profiler session records the thread that started it, so the
    recorder is switched on here by hand.)"""
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    opened, done = threading.Event(), threading.Event()
    seen = {}

    def other():
        opened.wait(10)
        with tracing.span("other.root"):
            with tracing.span("other.child"):
                pass
        seen["thread"] = threading.get_native_id()
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with tracing.span("main.root"):
        opened.set()
        assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    spans = {s.name: s for s in tracing.spans()}
    assert spans["other.root"].parent is None
    assert spans["other.child"].parent == spans["other.root"].id
    assert spans["main.root"].parent is None
    assert spans["other.root"].thread == seen["thread"]
    assert spans["main.root"].thread == threading.get_native_id()
    assert seen["thread"] != threading.get_native_id()


def test_spans_share_the_traces_clock(tmp_path):
    """Mapped by libkineto's base rule (Unix seconds floored to a multiple
    of 7889238), each span holds its `record_function` twin of the chrome
    trace, and the median gap at either end is under 50 us."""
    a = torch.randn(32, 32)
    with cpu_session() as prof:
        for _ in range(200):
            with tracing.span("clock.check"):
                torch.mm(a, a)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        doc = json.load(f)
    twins = sorted((e for e in doc["traceEvents"]
                    if e.get("ph") == "X" and e.get("name") == "clock.check"),
                   key=lambda e: e["ts"])
    spans = tracing.spans()
    assert len(spans) == len(twins) == 200
    period = BASE_PERIOD_S * 10**9
    rule = spans[0].start_ns // period * period
    base = doc["baseTimeNanoseconds"]
    assert base in (rule, rule - period)
    starts, ends = [], []
    for s, e in zip(spans, twins):
        ts, end = (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3
        starts.append(e["ts"] - ts)
        ends.append(end - (e["ts"] + e["dur"]))
    # the trace writes microseconds with three decimals
    assert min(starts) >= -1e-3 and min(ends) >= -1e-3
    assert statistics.median(starts) < 50
    assert statistics.median(ends) < 50


@pytest.mark.parametrize("pauses", [False, True], ids=["plain", "pauses"])
def test_train_steps_record_the_span_tree(pauses):
    model = tiny_model(pauses)
    with cpu_session():
        train_aligner(model, [make_batch(s) for s in (1, 2)], steps=3,
                      device="cpu", learning_rate=1e-3, log_every=1,
                      log_fn=lambda line: None)
    spans = tracing.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["train.step"] * 3
    assert [s.step for s in roots] == [0, 1, 2]
    by_id = {s.id: s for s in spans}
    for root in roots:
        assert children(spans, root) == STEP_CHILDREN
        forward = next(s for s in spans if s.parent == root.id
                       and s.name == "step.forward")
        (model_fwd,) = [s for s in spans if s.parent == forward.id]
        assert model_fwd.name == "model.forward"
        assert children(spans, model_fwd) == MODEL_CHILDREN
    for s in spans:             # every span of a step reaches its root
        while s.parent is not None:
            s = by_id[s.parent]
        assert s.name == "train.step"
    assert len(spans) == 3 * (1 + len(STEP_CHILDREN) + 1
                              + len(MODEL_CHILDREN))


def test_eval_forward_records_the_model_spans():
    model = tiny_model().eval()
    batch = {k: torch.from_numpy(v) for k, v in make_batch(3).items()}
    with cpu_session(), torch.no_grad():
        model(batch["tokens"], batch["mel"], batch["text_lengths"],
              batch["mel_lengths"])
    spans = tracing.spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "model.forward"
    assert children(spans, root) == MODEL_CHILDREN
    assert len(spans) == 1 + len(MODEL_CHILDREN)


@pytest.mark.parametrize("pauses", [False, True], ids=["plain", "pauses"])
def test_a_profiler_session_leaves_training_bit_identical(pauses):
    def run(traced):
        model = tiny_model(pauses)
        batches = [make_batch(s) for s in (4, 5)]
        kw = dict(steps=3, device="cpu", learning_rate=1e-3, log_every=1,
                  log_fn=lambda line: None, bin_start=0, bin_ramp=1)
        if traced:
            with cpu_session():
                _, hist = train_aligner(model, batches, **kw)
        else:
            _, hist = train_aligner(model, batches, **kw)
        return hist, {k: v.detach().clone()
                      for k, v in model.state_dict().items()}

    hist0, params0 = run(False)
    assert tracing.spans() == []
    hist1, params1 = run(True)
    assert tracing.spans()
    assert hist0 == [dict(h, wall_s=h0["wall_s"])
                     for h, h0 in zip(hist1, hist0)]
    for k, v in params0.items():
        assert torch.equal(v, params1[k]), k
