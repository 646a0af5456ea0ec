"""Device ms an iteration of the program's `apg.backward` span:
loss.backward(), the eye's pullback, the gravity VJP, the MLP's backward
and ATen's backward work (over the record's `apg.iteration` spans)."""

from bench_port.lib.program_record import span_ms


def read(summaries):
    return span_ms("apg.iteration", "apg.backward")
