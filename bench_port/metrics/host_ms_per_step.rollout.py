"""Host time (ms) of each step call into the env or the scene (the
benchmark's `step` span around it, which does not synchronize)."""

from bench_port.lib.readers import host_ms


def read(summaries):
    return host_ms(summaries, "step")
