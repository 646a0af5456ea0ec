"""Device ms an iteration of the program's `apg.rollout` span: the spawns
and the horizon's eye renders, dynamics, policy and rewards (CUDA events
at the span's ends, over the record's `apg.iteration` spans)."""

from bench_port.lib.program_record import span_ms


def read(summaries):
    return span_ms("apg.iteration", "apg.rollout")
