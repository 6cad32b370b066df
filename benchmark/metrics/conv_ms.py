"""Device milliseconds a step (or batch) in cuDNN's convolutions, their
FFT stages and layout transposes included: the `conv` class of
`harness/kernel_classes.json`."""
from harness import trace as tr


def read(trace, name):
    s = tr.seconds_by_class(trace).get("conv", 0.0)
    if s == 0.0 or not trace.steps:
        return None
    return 1e3 * s / trace.steps
