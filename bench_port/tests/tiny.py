"""Cells at sizes a CPU test holds: the harness's context for a cell on the
CPU, its configuration and mix cut down (the drivers run the port's plain
versions of its kernels there)."""

from __future__ import annotations

import time

from bench_port.lib import harness
from bench_port.lib.cells import Bench

CONFIG = {"num_envs": 4, "n": 16}
VISION_WIDTH = 16
TRAFFIC = {"episode_steps": 4, "warmup_steps": 2, "check_steps": 3, "check_envs": 2,
           "trace_after_s": 0.05, "horizon": 2, "trace_iterations": 1}


def context(cell: str, seed: int = 5, seconds: float = 0.3, trace: bool = False,
            bench: Bench | None = None, **kw) -> harness.Ctx:
    bench = bench or Bench()
    ctx = harness.context(bench, cell, seed, seconds, trace, "cpu", time.perf_counter(), **kw)
    cfg = dict(ctx.config)
    cfg.update(CONFIG, num_envs=CONFIG["num_envs"] * ctx.cell["chips"])
    cfg["vision"] = dict(cfg["vision"], width=VISION_WIDTH)
    ctx.config = cfg
    ctx.traffic = {**ctx.traffic, **{k: v for k, v in TRAFFIC.items() if k in ctx.traffic}}
    return ctx
