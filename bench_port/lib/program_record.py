"""What the readers of the program's own spans share. The program
(nenbody_tpu_torch.utils.profiling) records spans while a torch.profiler
records, so in a traced run its record covers the driver's lead unit and
its traced stretch. A reader reads the record in rank 0's process, the
one that prints the line, after the run, and divides by the record's own
count of the spans that make a unit (`apg.iteration` or `env.step`). A
program without the record, or with nothing recorded, gives None: the
line then leaves the metric out."""

from __future__ import annotations


def record():
    """The program's record (its `record()`: spans by name, counters), or
    None where the program has none or it holds no span."""
    try:
        from nenbody_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "record", None)
    if read is None:
        return None
    rec = read()
    return rec if rec.get("spans") else None


def span_ms(unit: str, span: str):
    """Device ms of the program's span `span` a unit: its summed device
    time over the calls of the span `unit`; None where either is missing."""
    rec = record()
    if rec is None:
        return None
    units, s = rec["spans"].get(unit), rec["spans"].get(span)
    if not units or not s or not units["calls"]:
        return None
    return s["device_ms"] / units["calls"]

