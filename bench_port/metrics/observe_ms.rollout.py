"""Device ms a step of the program's `env.observe` span: the eye's render
and the observation's concatenation (over the record's `env.step` spans; an
episode's first observation falls into its first step)."""

from bench_port.lib.program_record import span_ms


def read(summaries):
    return span_ms("env.step", "env.observe")
