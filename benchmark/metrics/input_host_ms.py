"""Host milliseconds a step the issuing thread spent in the program's
`input.next` span (the next batch from `prefetch_to_device`: the draw,
pinning and the copy's issue, or the wait for them): the program-side
reading of what `input_pin_ms` times from the profiler's operators.
Read from the program's own spans (`harness/spans.py`)."""
from harness import spans


def read(trace, name):
    s = spans.host_s(trace, "input.next")
    if not s or not trace.steps:
        return None
    return 1e3 * s / trace.steps
