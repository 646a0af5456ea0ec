"""Device ms an iteration of the program's `apg.update` span: the
gradients' sync across processes (with the wait for the slowest), the grad
norm and the optimizer's step (over the record's `apg.iteration` spans)."""

from bench_port.lib.program_record import span_ms


def read(summaries):
    return span_ms("apg.iteration", "apg.update")
