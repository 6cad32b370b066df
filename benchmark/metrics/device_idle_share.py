"""Share of the traced stretch in which nothing ran on the device, in %:
1 - (union of the device's kernels, copies and fills) / (the stretch).
Moves the path's throughput (`.train`, `.align`)."""
from harness import trace as tr


def read(trace, name):
    if not trace.device:
        return None
    return 100.0 * (1.0 - tr.busy_s(trace) / trace.window_s)
