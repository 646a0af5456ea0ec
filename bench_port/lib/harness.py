"""One run of one cell: check the machine, hand the cell to its driver,
judge `correct`, and print the result line.

The driver (drivers/<kind>.py, named by the cell's traffic) loads the
program, warms up, measures the window, reads the trace when asked, and
checks what the timed path produced against the plain reference. It
returns an Outcome (below); this module turns it into the contract's last
line of standard output, after the numbers compared and their limits as
the last lines of standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import torch

from .cells import Bench
from .trace import Tracer

# top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "nenbody_tpu")


@dataclasses.dataclass
class Ctx:
    """What a driver is given."""
    bench: Bench
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float  # host clock at the start of the process
    tracer: Tracer = None
    control: bool = False  # also read the control (calibrate.py)
    rank: int = 0
    world: int = 1
    port: int = 0
    marks: dict = dataclasses.field(default_factory=dict)  # set-up's stages: s since t0
    card: list = dataclasses.field(default_factory=list)  # lib/window.py's card readings
    ranks: tuple = None  # (processes of ranks 1.., port) from lib/ranks.start

    def mark(self, stage: str) -> None:
        self.marks[stage] = round(time.perf_counter() - self.t0, 3)

    @property
    def cuda(self) -> bool:
        return self.device.startswith("cuda")


@dataclasses.dataclass
class Outcome:
    """What a driver returns (on the rank that prints)."""
    setup_s: float
    e2e: dict  # end-to-end metric name -> value
    checks: dict  # compared number -> value
    attempted: int
    failed: int
    peak_bytes: int  # on the fullest chip
    summaries: list = dataclasses.field(default_factory=list)  # one trace summary a rank
    controls: dict = dataclasses.field(default_factory=dict)  # control's readings
    extra: dict = dataclasses.field(default_factory=dict)
    loaded: list = dataclasses.field(default_factory=list)  # forbidden modules of ranks 1..


def loaded_forbidden() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def forbidden(out: Outcome) -> list:
    """The forbidden modules loaded once the window has closed: this
    process's, and each other rank's that the driver gathered."""
    return loaded_forbidden() + out.loaded


def context(bench: Bench, name: str, seed: int, seconds: float, trace: bool, device: str,
            t0: float, **kw) -> Ctx:
    cell = bench.cell(name)
    return Ctx(bench, cell, bench.config(cell["config"]), bench.traffic(cell["traffic"]),
               bench.limits(name), seed, seconds, trace, device, t0,
               Tracer(device == "cuda"), **kw)


def run_cell(ctx: Ctx) -> Outcome:
    return ctx.bench.driver(ctx.traffic["driver"]).run(ctx)


def verdict(ctx: Ctx, out: Outcome) -> bool:
    return all(name in out.checks and math.isfinite(out.checks[name])
               and out.checks[name] <= limit for name, limit in ctx.limits.items())


def result_line(ctx: Ctx, out: Outcome) -> dict:
    bench, name = ctx.bench, ctx.cell["name"]
    metrics = {}
    if ctx.trace:
        for m in bench.metrics_of(name, "per_layer"):
            v = bench.reader(m["name"])(out.summaries)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench.metrics_of(name, "end_to_end"):
            metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if ctx.cuda else "cpu",
              "count": ctx.cell["chips"], "memory_peak_bytes": out.peak_bytes}
    line = {"correct": verdict(ctx, out), "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if ctx.trace:
        s = out.summaries
        if not s:
            raise RuntimeError("the window ended before its traced stretch: no trace to read")
        device["busy_s"] = sum(x["busy_s"] for x in s) / len(s)
        device["window_s"] = s[0]["window_s"]
        line["breakdown"] = {"device_ops": [list(kv) for kv in s[0]["device_ops"]],
                             "idle_gaps": [list(kv) for kv in s[0]["idle_gaps"]]}
    line["card"] = [f"{when}: {state}" for when, state in ctx.card]
    line["checks"] = {k: {"value": _number(out.checks.get(k)), "limit": lim}
                      for k, lim in ctx.limits.items()}
    return line


def _number(x):
    """A reading as JSON takes it: null where there is none or it is not finite."""
    return x if x is not None and math.isfinite(x) else None


def card_limit() -> str:
    """`nvidia-smi`'s name and power limit of the first card, or '' where
    it cannot be read."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return ""


def parse(argv):
    ap = argparse.ArgumentParser(prog="bench_port/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell across processes, started by its rank 0
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv, t0: float, ranks=None) -> int:
    args = parse(argv)
    bench = Bench()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench_port: the cell needs {cell['chips']} CUDA device(s); "
              f"available {torch.cuda.is_available()}, "
              f"count {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        for p in (ranks or ((), 0))[0]:
            p.kill()
            p.wait()
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = context(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0,
                  rank=args.rank, world=args.world, port=args.port, ranks=ranks)
    out = run_cell(ctx)
    if ctx.rank != 0:
        return 0
    bad = forbidden(out)
    if bad:
        print(f"bench_port: modules loaded in the measuring process: {bad}", file=sys.stderr)
        return 3
    line = result_line(ctx, out)
    limit = card_limit()
    print(f"bench_port: {args.workload} seed {args.seed} on {limit}; set-up "
          f"{out.setup_s:.3f} s (stages at {json.dumps(ctx.marks)}); "
          f"{time.perf_counter() - t0:.1f} s in all", file=sys.stderr)
    print(f"bench_port: card (clock, power, limit, temperature) {'; '.join(line['card'])}",
          file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
