"""Device ms a step of the program's `policy.forward` span: the bf16
casts, GEMMs, tanh and the fp32 head (over the record's `env.step` spans)."""

from bench_port.lib.program_record import span_ms


def read(summaries):
    return span_ms("env.step", "policy.forward")
