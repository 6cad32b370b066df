"""The whole training step's share of the chip's peak, in %: the step's
convolution and matrix-product FLOPs on the valid lengths (forward x 3:
the backward takes twice the forward's), over the traced stretch's
seconds times the peak of the configuration's compute dtype. Padding
is work the chip does and this does not count, so it shows as lost
utilisation."""
from harness import peaks


def read(trace, name):
    if trace.kind != "train" or not trace.batches:
        return None
    fam = trace.cell.family()
    flops = 3 * sum(fam.flops(trace.cell.config, b) for b in trace.batches)
    peak = peaks.FLOPS[trace.cell.config["compute_dtype"]]
    return 100.0 * flops / (trace.window_s * peak)
