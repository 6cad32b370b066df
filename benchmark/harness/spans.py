"""The program's own spans on the trace's clock, and the device's idle
time split by the span the issuing thread was in.

The port records a span at each of its layer boundaries
(`aligner_tpu_torch.utils.tracing`) while a `torch.profiler` session
records, with its start and end in Unix-epoch nanoseconds, the clock the
profiler puts its events on. A chrome trace writes an event's `ts` as
microseconds since its `baseTimeNanoseconds`, which libkineto's
`ChromeTraceBaseTime` takes as the Unix seconds floored to a multiple of
BASE_PERIOD_S (as torch's `profiler/_chrome_trace_export.py` documents).
A span maps into the trace under the base of its own time, or under the
one before it, where the trace's base was taken before a boundary. The
spans that start inside the window mark are kept, their ends clipped to
the mark.

The device's idle intervals inside the mark (the complement of the union
of its events) are split by the innermost span open on the issuing
thread, the one that runs the model's forward (`model.forward`). Each
span falls into a category: `input` (`input.*`: the batch draw, pinning
and the copy's issue), `issue` (`step.*` and `model.*`: the step's and
the model's own host work), and `other` (the rest: the loop's own time,
`train.log`, a callback, and time under no span). The three sum to the
idle share.

A program without the recorder, or a stretch in which it recorded no
span, gives None.
"""
from __future__ import annotations

import collections
import dataclasses

from . import trace as tr

BASE_PERIOD_S = 7889238
ISSUING_SPAN = "model.forward"


@dataclasses.dataclass(frozen=True)
class Mapped:
    """A span in the trace's frame: microseconds since the trace's base."""
    name: str
    thread: int
    ts: float
    end: float


def recorded() -> list | None:
    """The program's recorded spans, or None where it has no recorder."""
    try:
        from aligner_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans()


def in_mark(trace) -> list | None:
    """The spans that start inside the window mark, in the trace's frame
    and clipped to the mark; None where none does."""
    spans = recorded()
    if not spans:
        return None
    period_ns = BASE_PERIOD_S * 10**9
    newest = max(s.start_ns for s in spans)
    base = newest // period_ns * period_ns
    a, b = trace.mark.ts, trace.mark.ts + trace.mark.dur
    for base_ns in (base, base - period_ns):
        out = []
        for s in spans:
            ts = (s.start_ns - base_ns) / 1e3
            if a <= ts < b:
                end = min((s.end_ns - base_ns) / 1e3, b)
                out.append(Mapped(s.name, s.thread, ts, max(end, ts)))
        if out:
            return out
    return None


def issuing_thread(spans: list) -> int:
    """The thread that runs the model's forward (where no span is a
    forward: the thread with the most spans)."""
    forward = collections.Counter(s.thread for s in spans
                                  if s.name == ISSUING_SPAN)
    return (forward or collections.Counter(s.thread for s in spans)) \
        .most_common(1)[0][0]


def innermost(spans: list) -> list:
    """(start, end, name) pieces of one thread's nested spans, each named by
    the innermost span open over it; sorted and disjoint."""
    pieces, stack, at = [], [], None     # stack: (end, name), innermost last
    for s in sorted(spans, key=lambda s: (s.ts, -s.end)):
        while stack and stack[-1][0] <= s.ts:
            end, name = stack.pop()
            pieces.append((at, end, name))
            at = end
        if stack and s.ts > at:
            pieces.append((at, s.ts, stack[-1][1]))
        at = s.ts
        stack.append((min(s.end, stack[-1][0]) if stack else s.end, s.name))
    while stack:
        end, name = stack.pop()
        pieces.append((at, end, name))
        at = end
    return [p for p in pieces if p[1] > p[0]]


def idle_gaps(trace) -> list:
    """The device's idle intervals inside the mark, as (start, end) in us."""
    a, b = trace.mark.ts, trace.mark.ts + trace.mark.dur
    edges = [a] + [x for s, t in tr.merged(trace.clipped())
                   for x in (s, t)] + [b]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_by_span(trace) -> dict | None:
    """{span name, or None for no span: idle seconds} over the mark, by the
    issuing thread's innermost open span."""
    spans = in_mark(trace)
    if spans is None:
        return None
    thread = issuing_thread(spans)
    pieces = innermost([s for s in spans if s.thread == thread])
    out: dict = collections.defaultdict(float)
    j = 0
    for s, t in idle_gaps(trace):
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        covered = 0.0
        k = j
        while k < len(pieces) and pieces[k][0] < t:
            lap = min(t, pieces[k][1]) - max(s, pieces[k][0])
            if lap > 0:
                out[pieces[k][2]] += lap / 1e6
                covered += lap
            k += 1
        out[None] += (t - s - covered) / 1e6
    return dict(out)


def category(name: str | None) -> str:
    if name is None:
        return "other"
    if name.startswith("input."):
        return "input"
    if name.startswith(("step.", "model.")):
        return "issue"
    return "other"


def idle_share(trace, which: str) -> float | None:
    """% of the mark in which the device idled while the issuing thread was
    in a span of category `which`."""
    if not trace.device:
        return None
    by_span = idle_by_span(trace)
    if by_span is None:
        return None
    s = sum(v for k, v in by_span.items() if category(k) == which)
    return 100.0 * s / trace.window_s


def host_s(trace, name: str) -> float | None:
    """Seconds of the mark the issuing thread spent in spans called `name`
    (None where it has none)."""
    spans = in_mark(trace)
    if spans is None:
        return None
    thread = issuing_thread(spans)
    named = [s for s in spans if s.thread == thread and s.name == name]
    if not named:
        return None
    return sum(s.end - s.ts for s in named) / 1e6
