"""bench_port.work: each kernel's counted operations and bytes, a module a
kernel (work/<kernel>.py), and the card's peaks (work/peaks.py)."""

from __future__ import annotations

import importlib
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_]{1,64}$")


def of(kernel: str) -> ModuleType:
    """work/<kernel>.py, found by its name: a cell of another eye brings its
    eye's work modules as new files."""
    path = HERE / f"{kernel}.py"
    if not NAME.match(kernel) or not path.is_file():
        raise FileNotFoundError(f"no work module for {kernel!r} at {path}")
    return importlib.import_module(f"{__name__}.{kernel}")
