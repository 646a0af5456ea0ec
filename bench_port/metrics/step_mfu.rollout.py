"""The whole step's share (%) of the card's peak: the time the stretch's
counted operations (float32 and bfloat16, work/) take at the card's peaks
over the stretch's length, on rank 0."""

from bench_port.lib.readers import step_mfu


def read(summaries):
    return step_mfu(summaries)
