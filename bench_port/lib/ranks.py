"""The one launcher of a cell's ranks 1.. across processes, one a card.
It imports no torch, so that run.py can start the ranks before it imports
torch itself and their start overlaps its own."""

from __future__ import annotations

import socket
import subprocess


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(command: list, processes: int) -> tuple:
    """Ranks 1..processes-1 of `command` (an argv), each given
    `--rank R --world processes --port P` after its arguments, P a free
    localhost port for the rendezvous: (their processes, P)."""
    port = free_port()
    return [subprocess.Popen([*command, "--rank", str(r), "--world", str(processes),
                              "--port", str(port)]) for r in range(1, processes)], port
