"""Share of the traced stretch in which the device idled while the issuing
thread was in the train step's or the model's spans (`step.*`,
`model.*`: the host's issue of the forward, backward and update), in %.
Read from the program's own spans (`harness/spans.py`). Moves the path's
throughput."""
from harness import spans


def read(trace, name):
    return spans.idle_share(trace, "issue")
