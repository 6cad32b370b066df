"""Spans of the program's layers, on the clock of `torch.profiler`'s traces.

`span(name)` marks a stretch of the program as a context manager. A span is
recorded only while a `torch.profiler` session records
(`torch.autograd._profiler_enabled()`); outside one, `span` returns one
shared object that does nothing. Inside one, the span also opens
`torch.profiler.record_function(name)`, so it shows in the session's chrome
trace beside the device's kernels, and a `Span` is kept in memory: its
name, its id, the id of the span open around it on the same thread, the
thread, and its start and end in Unix-epoch nanoseconds (`time.time_ns()`,
the clock onto which the profiler puts its CPU operators and the device's
events; a chrome trace writes them as microseconds since its
`baseTimeNanoseconds`). The root span of a training step carries the
step's index. `spans()` returns the recorded spans, oldest first; the
newest `MAX_SPANS` are kept.

The spans, by layer (nothing else is spanned):

    train/loop.py   train.step (one iteration of the loop; `step` set),
                    input.next (the next batch of `prefetch_to_device`:
                    the draw, pinning and the copy's issue, or the wait
                    for them), train.log (metrics read back at log points)
    train/step.py   step.forward (the model and the objective),
                    step.backward (zero_grad and the backward pass),
                    step.update (the clip and AdamW)
    models/ota.py   model.forward, and inside it model.encode, model.lattice,
                    model.prior, model.forward_sum, model.mas, model.losses

The recorded spans are one store for the whole process; a thread records
while a profiler session records on it.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time

import torch

MAX_SPANS = 1 << 16


@dataclasses.dataclass(frozen=True, slots=True)
class Span:
    name: str
    id: int
    parent: int | None      # the enclosing span's id on the same thread
    thread: int             # threading.get_native_id()
    start_ns: int           # Unix epoch, time.time_ns()
    end_ns: int
    step: int | None = None


_recorded: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_open = threading.local()       # .stack: ids of the thread's open spans


class _NoSpan:
    """The span outside a profiler session: nothing is recorded."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Recording:
    __slots__ = ("name", "step", "id", "parent", "start_ns", "_annotation")

    def __init__(self, name: str, step: int | None):
        self.name, self.step = name, step
        self.id = next(_ids)

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        # The span encloses its profiler annotation: the clock is read
        # before the annotation opens and after it closes.
        self.start_ns = time.time_ns()
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        return self

    def __exit__(self, *exc):
        self._annotation.__exit__(*exc)
        end = time.time_ns()
        _open.stack.pop()
        _recorded.append(Span(self.name, self.id, self.parent,
                              threading.get_native_id(), self.start_ns, end,
                              self.step))
        return False


def span(name: str, step: int | None = None):
    """A context manager over one stretch of the program, recorded (and
    annotated in the profiler's trace) while a profiler session records.
    `step`: the training step's index, on the root span of a step."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return _Recording(name, step)


def spans() -> list[Span]:
    """The recorded spans, oldest first (at most MAX_SPANS)."""
    return list(_recorded)


def clear() -> None:
    """Forget the recorded spans."""
    _recorded.clear()
