"""The measured window, driven from inside the program's own loop.

`Window.on_step(step)` is called before the work of each step or batch
is issued (the train path passes it to `train_aligner` as `apply_extra`,
which the loop calls once a step). Steps before `first` are set-up: the
warm-up of every shape the traffic uses. At step `first` the device is
synchronised and the window opens. It closes on a whole number of passes
over the corpus' `period` batches: the first call at or past the
deadline that starts a pass raises `WindowClosed` before its step is
issued, and `close()` synchronises, so every step issued in the window
has finished inside it, and every run's window holds the same work a
pass (a window measures `--seconds` and at most one pass more).

With `trace`, a stretch of the window, opening a quarter of the way in,
is recorded by `torch.profiler`, between two synchronisations, under a
`bench.window` annotation; `close()` returns the chrome trace's path.
"""
from __future__ import annotations

import os
import tempfile
import time

import torch

MARK = "bench.window"
TRACE_AT = 0.25          # share of the window before the traced stretch
TRACE_SECONDS = 2.0      # host seconds of the traced stretch, at most
TRACE_STEPS = 64         # steps in the traced stretch, at most


class WindowClosed(Exception):
    """Raised from `on_step` when the window's time is up."""


class Window:

    def __init__(self, device, seconds: float, first: int, period: int,
                 trace: bool, stop_at: int | None = None):
        self.device = torch.device(device)
        self.seconds = seconds
        self.first = first
        self.period = period
        self.trace = trace
        self.stop_at = stop_at
        self.issued: list[int] = []
        self.traced: list[int] = []
        self.t_start = self.t_end = None
        self._prof = self._mark = None
        self._trace_t0 = None
        self.trace_path = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def on_step(self, step: int) -> dict:
        if self.stop_at is not None and step >= self.stop_at:
            raise WindowClosed
        if step < self.first:
            return {}
        now = time.perf_counter()
        if self.t_start is None:
            self.sync()
            now = self.t_start = time.perf_counter()
        elif now >= self.t_start + self.seconds and \
                (step - self.first) % self.period == 0:
            raise WindowClosed
        if self.trace:
            self._trace_step(step, now)
        self.issued.append(step)
        return {}

    def _trace_step(self, step: int, now: float):
        if self._prof is None and self._trace_t0 is None and \
                now >= self.t_start + TRACE_AT * self.seconds:
            self._start_trace()
            self._trace_t0 = time.perf_counter()
        elif self._prof is not None and (
                now >= self._trace_t0 + min(TRACE_SECONDS,
                                            TRACE_AT * self.seconds)
                or len(self.traced) >= TRACE_STEPS):
            self._stop_trace()
        if self._prof is not None:
            self.traced.append(step)

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        self._prof = profile(activities=acts)
        self._prof.start()
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()

    def _stop_trace(self):
        self.sync()
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
        os.close(fd)
        self._prof.export_chrome_trace(path)
        self.trace_path = path
        self._prof = self._mark = None

    def close(self) -> None:
        """Synchronise and end the window (and the traced stretch)."""
        self.sync()
        self.t_end = time.perf_counter()
        if self._prof is not None:
            self._stop_trace()

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start
