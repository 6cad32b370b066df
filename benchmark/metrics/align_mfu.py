"""The whole forward pass's share of the chip's peak on the align path,
in %: its convolution and matrix-product FLOPs on the valid lengths,
over the traced stretch's seconds times the peak of the
configuration's compute dtype."""
from harness import peaks


def read(trace, name):
    if trace.kind != "align" or not trace.batches:
        return None
    fam = trace.cell.family()
    flops = sum(fam.flops(trace.cell.config, b) for b in trace.batches)
    peak = peaks.FLOPS[trace.cell.config["compute_dtype"]]
    return 100.0 * flops / (trace.window_s * peak)
