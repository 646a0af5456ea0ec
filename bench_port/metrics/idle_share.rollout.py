"""The device's idle share (%) of the traced stretch: 1 - the union of its
device intervals over the stretch's length, on rank 0."""

from bench_port.lib.readers import idle_share


def read(summaries):
    return idle_share(summaries)
