"""Host time (ms) of each training iteration's call into the trainer (the
benchmark's `train_step` span around it, which does not synchronize)."""

from bench_port.lib.readers import host_ms


def read(summaries):
    return host_ms(summaries, "train_step")
