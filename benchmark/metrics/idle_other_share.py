"""Share of the traced stretch in which the device idled while the issuing
thread was in none of the input, step or model spans (the loop's own
time, `train.log`, the benchmark's callback and read-back, or no span at
all), in %: what the program's spans cannot name. With
`idle_input_share` and `idle_issue_share` it sums to
`device_idle_share`. Read from the program's own spans
(`harness/spans.py`)."""
from harness import spans


def read(trace, name):
    return spans.idle_share(trace, "other")
