"""Readings that the limits of `correct` are set from (limits/<cell>.json):
for each seed, the numbers a sound run compares and the same numbers of
the control (the plain reference one precision lower in the program's
place), then of each fault asked for (tests/faults.py, planted in the
program). The benchmark's own runs never do this.

    python3 bench_port/calibrate.py --workload c5-rollout --seeds 1,2,3 \\
        --seconds 2 --faults half_batch --out bench_port/out/cal.json

One process reads every seed (a cell across processes: one process a
card, each reading every seed in one process group, its ranks 1.. begun
by lib/ranks.start as run.py begins a cell's). Each seed's run is the
cell's own run with a window of --seconds.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["NCCL_SHM_DISABLE"] = "1"
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]

import torch  # noqa: E402

from bench_port.lib import harness, ranks  # noqa: E402
from bench_port.lib.cells import Bench  # noqa: E402


def readings(ctx, seeds, faults, run_one):
    from bench_port.tests import faults as fault_lib

    rows = []
    for seed in seeds:
        c = dataclasses.replace(ctx, seed=seed, control=True, tracer=harness.Tracer(ctx.cuda))
        t = time.perf_counter()
        out = run_one(c)
        row = {"seed": seed, "program": out.checks, "control": out.controls,
               "seconds": time.perf_counter() - t, "units": out.attempted, "look": out.extra}
        for f in faults if seed in seeds[:3] else ():
            with fault_lib.planted(f):
                fo = run_one(dataclasses.replace(c, tracer=harness.Tracer(ctx.cuda)))
            row[f] = {"checks": fo.checks, "look": fo.extra}
        rows.append(row)
        if ctx.rank == 0:
            print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    faults = [f for f in a.faults.split(",") if f]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = Bench()
    ctx = harness.context(bench, a.workload, seeds[0], a.seconds, False, "cuda", T0,
                          rank=a.rank, world=a.world, port=a.port)
    if ctx.cell["chips"] == 1:
        rows = readings(ctx, seeds, faults, harness.run_cell)
    else:
        from bench_port.drivers import apg_train, apg_train_procs

        if a.world == 1:
            ctx.ranks = ranks.start([sys.executable, os.path.abspath(__file__),
                                     *(sys.argv[1:] if argv is None else argv)],
                                    ctx.traffic["processes"])
        rows = apg_train_procs.across(ctx, lambda c, mesh, group: readings(
            c, seeds, faults, lambda cc: apg_train.train(cc, mesh, group)))
    if a.rank == 0 and a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"cell": a.workload, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
