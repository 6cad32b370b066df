"""Host milliseconds a step in pinning the next batch
(`aten::pin_memory`, the input layer's `prefetch_to_device`), from the
trace's top-level CPU operators."""

PIN = ("aten::pin_memory", "aten::_pin_memory")


def read(trace, name):
    s = sum(o.dur for o in trace.cpu_ops if o.name in PIN) / 1e6
    if s == 0.0 or not trace.steps:
        return None
    return 1e3 * s / trace.steps
