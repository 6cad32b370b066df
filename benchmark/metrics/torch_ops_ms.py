"""Device milliseconds a step (or batch) in PyTorch's own kernels
(elementwise, reductions, scans, foreach, indexing): the `torch_ops`
class of `harness/kernel_classes.json`. On the OTA paths: the prior,
the softmax, the pause states' spread, the losses and the optimizer."""
from harness import trace as tr


def read(trace, name):
    s = tr.seconds_by_class(trace).get("torch_ops", 0.0)
    if s == 0.0 or not trace.steps:
        return None
    return 1e3 * s / trace.steps
