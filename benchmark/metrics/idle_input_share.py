"""Share of the traced stretch in which the device idled while the issuing
thread was in the input layer's spans (`input.*`: the next batch's draw,
pinning and copy issue, or the wait for them), in %. Read from the
program's own spans (`harness/spans.py`). Moves the path's throughput."""
from harness import spans


def read(trace, name):
    return spans.idle_share(trace, "input")
