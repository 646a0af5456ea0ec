"""The measured window: `seconds` on the host clock from a synchronize to
a synchronize, with a CUDA event recorded on the stream at every unit
boundary, so that each unit's time on the device (its work and any wait
for the host) can be read after the window without stopping it."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

def card_state() -> str:
    """nvidia-smi's reading of this process's card, or '' where it cannot be read."""
    query = "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu"
    try:
        return subprocess.run(["nvidia-smi", "-i", str(torch.cuda.current_device()), query,
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


class Window:
    """`card`, where given, gets the card's SM clock, power draw and limit
    and temperature at the opening and the closing (card_state)."""

    def __init__(self, seconds: float, cuda: bool, per_unit: bool = True, card: list | None = None):
        self.seconds, self.cuda, self.per_unit, self.card = seconds, cuda, per_unit, card
        self.units = 0
        self.events = []
        self.t_open = self.t_close = None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def _mark(self) -> None:
        if self.cuda and self.per_unit:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)

    def open(self) -> float:
        self._sync()
        if self.cuda and self.card is not None:
            self.card.append(("open", card_state()))
        self.t_open = time.perf_counter()
        self._mark()
        return self.t_open

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_open

    def running(self) -> bool:
        return self.elapsed() < self.seconds

    def tick(self) -> None:
        """One unit (a step or an iteration) has been issued."""
        self.units += 1
        self._mark()

    def close(self) -> float:
        self._sync()
        self.t_close = time.perf_counter()
        if self.cuda and self.card is not None:
            self.card.append(("close", card_state()))
        return self.t_close - self.t_open

    @property
    def length(self) -> float:
        return self.t_close - self.t_open

    def unit_ms(self) -> list:
        """Each unit's milliseconds between its boundary events."""
        return [a.elapsed_time(b) for a, b in zip(self.events[:-1], self.events[1:])]


def p95(values) -> float:
    """The 95th percentile (statistics.quantiles, inclusive)."""
    return statistics.quantiles(values, n=100, method="inclusive")[94]
