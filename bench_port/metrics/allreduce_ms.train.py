"""Device time (ms an iteration) of NCCL's kernels: the gradient
all-reduce and the trainer's global sums across processes."""

from bench_port.lib.readers import device_ms


def read(summaries):
    return device_ms(summaries, "nccl")
