"""The reference eye of a configuration: reference/<sprite_mode>_eye.py,
found by the name the configuration's `vision.sprite_mode` gives it, as
lib/cells.py finds a driver or a reader. A cell of another eye brings its
eye as a new file beside the disc's.

Every eye module keeps the disc's interface (reference/disc_eye.py):

    Eye.of(vision, antialias)            the eye's parameters from the configuration
    lines(pos, vel, eye, dtype)          (shade, depth) [B, N, W], differentiable
    heading_of(vel)                      the agents' unit headings
    winners(pos, dirs, eye, stats=)      each pixel's winner; with `stats`, adds
                                         the pixel counts that the eye's work
                                         modules (work/<sprite_mode>_eye*.py) take
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
MODE = re.compile(r"^[A-Za-z0-9_]{1,64}$")


def name(vision: dict) -> str:
    """The eye's name, `<sprite_mode>_eye`, of the configuration's `vision`
    (a configuration that names no sprite_mode has the disc): the name of
    its reference eye, of its work modules (work/<name>.py and
    work/<name>_bwd.py) and, with `_kernel`, of its kernels in the trace
    (lib/trace.py's KERNELS)."""
    mode = vision.get("sprite_mode", "disc")
    if not MODE.match(mode):
        raise ValueError(f"sprite_mode {mode!r} is not a name")
    return f"{mode}_eye"


def of(vision: dict) -> ModuleType:
    """The reference eye of the configuration's `vision`."""
    eye = name(vision)
    path = HERE / f"{eye}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference eye for {vision.get('sprite_mode', 'disc')!r} "
                                f"at {path}")
    return importlib.import_module(f"{__package__}.{eye}")
