"""Device time (ms an iteration) of ATen's elementwise and reduction
kernels: casts, tanh and its backward, cat, adds, means and their
backward (lib/trace.py's `elementwise` category: not the GEMMs, copies,
Adam, NCCL or the hand-written kernels)."""

from bench_port.lib.readers import device_ms


def read(summaries):
    return device_ms(summaries, "elementwise")
