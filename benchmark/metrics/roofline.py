"""A kernel's share of its roofline, in %, for a metric named
`<kernel>_roofline[.<suffix>]`: the least time the card could take for
the kernel's calls in the traced stretch (`harness.peaks.kernel_bound_s`
on each call's work from `roofline/<kernel>.py`), over the device time
the trace gives those calls. Each traced step or batch makes the same
number of calls, one batch's work each."""
from harness import peaks, spec
from harness import trace as tr


def read(trace, name):
    kernel = name.split(".")[0].removesuffix("_roofline")
    mod = spec.roofline_of(kernel, trace.cell.bench_dir)
    calls = [e for e in trace.device
             if tr.identifier(e.name) in mod.TRACE_NAMES]
    if not calls or not trace.batches:
        return None
    per_batch = sum(peaks.kernel_bound_s(**mod.work(b))[0]
                    for b in trace.batches)
    bound = per_batch * len(calls) / len(trace.batches)
    return 100.0 * bound / (sum(e.dur for e in calls) / 1e6)
