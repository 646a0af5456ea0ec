"""A traced stretch that the result line could not carry is traced again.

The line's `device.busy_s`, the mean of the ranks' busy seconds, has to lie
in (0, window_s], window_s being rank 0's stretch. A stretch for which the
card's profiler handed back no device event reads busy 0 (the profiler has
been seen to drop kernel events, PERF.md); across processes, ranks whose
stretches differ in length can read a mean over rank 0's (drivers/
apg_train.py opens them at one barrier, which makes that rare). The
driver then discards the stretch and traces the next unit or stretch, at
most RETRIES times, each retry said on standard error; after the last it
ends the run with an error instead of printing such a line.

Only a tracer of the card expects device work: on the CPU a stretch holds
none, and is read as it is.
"""

from __future__ import annotations

import sys

RETRIES = 2


def fault(stretches: list) -> str | None:
    """Why the line could not carry these stretches ({"busy_s", "window_s"}
    of each rank, rank 0 first), or None where it can."""
    busy = sum(s["busy_s"] for s in stretches) / len(stretches)
    if busy <= 0:
        return "holds no device work (busy_s 0)"
    if busy > stretches[0]["window_s"]:
        return f"reads busy_s {busy!r} over rank 0's window_s {stretches[0]['window_s']!r}"
    return None


class Retrace:
    """The traced stretches of one run, for a tracer that does (`device`)
    or does not expect device work."""

    def __init__(self, device: bool):
        self.device, self.tries = device, 0

    def again(self, stretches: list) -> bool:
        """Whether to discard the stretch just traced and trace another;
        raises where RETRIES stretches have already been traced again."""
        why = fault(stretches) if self.device else None
        if why is None:
            return False
        self.tries += 1
        if self.tries > RETRIES:
            raise RuntimeError(f"bench_port: {self.tries} traced stretches in a row could not be "
                               f"read, the last {why}: no result line")
        print(f"bench_port: the traced stretch {why}; tracing another (retry {self.tries} of "
              f"{RETRIES})", file=sys.stderr, flush=True)
        return True
