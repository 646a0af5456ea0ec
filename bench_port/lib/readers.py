"""What the per-layer readers (metrics/<name>.py) share. Each reader takes
the traced stretch's summaries, one a rank (lib/trace.py), and returns
its number from rank 0's (the first), or None where the stretch holds
nothing to read."""

from __future__ import annotations

from ..work import peaks


def first(summaries):
    """Rank 0's summary, or None."""
    return summaries[0] if summaries else None


def per_unit_ms(seconds: float, summary: dict) -> float:
    """`seconds` of the stretch as milliseconds a unit (step or iteration)."""
    return seconds / summary["units"] * 1e3


def device_ms(summaries, category: str):
    """Device time (ms a unit) of one category of kernels (lib/trace.py),
    or None where the stretch ran none."""
    s = first(summaries)
    if s is None or s["device_s"].get(category, 0.0) <= 0:
        return None
    return per_unit_ms(s["device_s"][category], s)


def host_ms(summaries, span: str):
    """Host time (ms a call) of the benchmark's span `span` around each call
    into the program, which does not synchronize."""
    s = first(summaries)
    calls = s["host_s_by_span"].get(span) if s else None
    if not calls or not calls["calls"]:
        return None
    return calls["s"] / calls["calls"] * 1e3


def roofline(summaries, kernel: str):
    """100 x the least time the counted work of `kernel` needs over the
    kernel's summed device time."""
    s = first(summaries)
    if s is None:
        return None
    w, t = s["work"].get(kernel), s["device_s"].get(kernel, 0.0)
    if w is None or t <= 0:
        return None
    return 100.0 * peaks.least_seconds(fp32_ops=w["fp32_ops"], bytes_moved=w["bytes"]) / t


def step_mfu(summaries):
    """100 x the time the stretch's counted operations take at the card's
    peaks over the stretch's length."""
    s = first(summaries)
    if s is None or s["work"].get("op_seconds", 0.0) <= 0 or s["window_s"] <= 0:
        return None
    return 100.0 * s["work"]["op_seconds"] / s["window_s"]


def idle_share(summaries):
    """100 x the stretch's idle share: 1 - the union of its device
    intervals over its length."""
    s = first(summaries)
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
