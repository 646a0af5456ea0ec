"""A rank of a cell across processes at the CPU sizes of tiny.py, with a
fault planted (faults.py), none, or `forbidden_module` (a module named
jax put in sys.modules, which the run has to report):

    python -m bench_port.tests.rank_worker CELL SEED SECONDS TRACE FAULT \
        --rank R --world W --port P

lib/ranks.start adds the last three arguments, as it does to run.py's.
"""

from __future__ import annotations

import sys
import types

from bench_port.lib import harness, ranks
from bench_port.tests import faults, tiny


def start(cell: str, seed: int, seconds: float, trace: bool, fault: str, processes: int):
    """Ranks 1.. of `cell` at the CPU sizes: lib/ranks.start's (processes, port)."""
    return ranks.start([sys.executable, "-m", "bench_port.tests.rank_worker", cell, str(seed),
                        str(seconds), str(int(trace)), fault], processes)


def main(argv) -> int:
    cell, seed, seconds, trace, fault = argv[:5]
    opts = dict(zip(argv[5::2], argv[6::2]))
    ctx = tiny.context(cell, int(seed), float(seconds), bool(int(trace)),
                       rank=int(opts["--rank"]), world=int(opts["--world"]),
                       port=int(opts["--port"]))
    if fault == "forbidden_module":
        sys.modules["jax"] = types.ModuleType("jax")
        fault = "none"
    with faults.planted(fault):
        harness.run_cell(ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
