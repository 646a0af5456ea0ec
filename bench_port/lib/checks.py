"""A uniform sample, drawn from the seed, of the units (steps) of a window
whose inputs and outputs are kept for the check after the window, in
buffers allocated at set-up, so that neither the memory nor the work of
keeping them depends on how many units the window holds."""

from __future__ import annotations

import random

import torch


class Reservoir:
    """Slot 0 keeps the first unit of set-up (the start: its input is the
    benchmark's own spawn); slots 1..k a reservoir sample of the window's
    units."""

    def __init__(self, k: int, rng: random.Random, shapes: dict, device):
        self.k, self.rng, self.seen = k, rng, 0
        self.unit = [None] * (k + 1)
        self.buf = {name: torch.empty((k + 1, *shape), dtype=dtype, device=device)
                    for name, (shape, dtype) in shapes.items()}

    def slot(self) -> int | None:
        """The slot the window's next unit goes to, or None."""
        self.seen += 1
        if self.seen <= self.k:
            return self.seen
        j = self.rng.randrange(self.seen)
        return j + 1 if j < self.k else None

    def keep(self, slot: int, unit: int, **tensors) -> None:
        self.unit[slot] = unit
        for name, x in tensors.items():
            self.buf[name][slot].copy_(x)

    def kept(self) -> list:
        """The slots that hold a unit."""
        return [i for i, u in enumerate(self.unit) if u is not None]
