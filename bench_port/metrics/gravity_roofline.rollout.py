"""The gravity kernel's share (%) of its roofline: the least time its
counted work needs (work/gravity.py at the card's peaks, work/peaks.py)
over its summed device time in the traced stretch."""

from bench_port.lib.readers import roofline


def read(summaries):
    return roofline(summaries, "gravity_kernel")
