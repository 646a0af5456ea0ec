"""The disc cells count the same work as before the eye's work was taken by
the configuration's sprite_mode: each driver's `work` dict, from fixed
inputs at the CPU sizes of tiny.py, equals the numbers recorded from the
drivers that named the disc's modules (PARENT), key for key and number
for number."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from bench_port.drivers import apg_train, rollout
from bench_port.tests import tiny

PARENT = {
    "c5-rollout": {"disc_eye_kernel": {"fp32_ops": 108650, "bytes": 46080},
                   "gravity_kernel": {"fp32_ops": 45056, "bytes": 4096},
                   "op_seconds": 1.3925095362419449e-08},
    "c5-train-apg-dv": {"disc_eye_kernel": {"fp32_ops": 138894, "bytes": 55296},
                        "gravity_kernel": {"fp32_ops": 45056, "bytes": 4096},
                        "disc_eye_bwd_kernel": {"fp32_ops": 127800, "bytes": 59392},
                        "op_seconds": 4.03100920574076e-08},
    "c5x4-train-apg-dv": {"disc_eye_kernel": {"fp32_ops": 139380, "bytes": 55296},
                          "gravity_kernel": {"fp32_ops": 45056, "bytes": 4096},
                          "disc_eye_bwd_kernel": {"fp32_ops": 132600, "bytes": 59392},
                          "op_seconds": 4.0388987579795665e-08},
}


def _states(count: int, b: int, n: int, seed: int) -> list:
    """(pos, vel) of `count` renders, the agents close enough (U(-6, 6))
    that the eye's pixel terms count."""
    g = torch.Generator().manual_seed(seed)
    return [((torch.rand((b, n, 2), generator=g) * 2 - 1) * 6.0,
             torch.rand((b, n, 2), generator=g) * 2 - 1) for _ in range(count)]


def _generator_states(count: int, seed: int) -> list:
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(count):
        out.append(g.get_state())
        torch.rand(1000, generator=g)
    return out


@pytest.mark.parametrize("cell", sorted(PARENT))
def test_disc_cells_count_the_same_work(cell):
    ctx = tiny.context(cell)
    if ctx.traffic["driver"] == "rollout":
        cfg = ctx.config
        states = _states(ctx.traffic["episode_steps"] + 1, cfg["num_envs"], cfg["n"], 1)
        got = rollout._work(states, ctx.traffic, cfg)
    else:
        ctx.config = dict(ctx.config, spawn_pos_range=[-6.0, 6.0])
        if ctx.cell["chips"] > 1:  # rank 0's share, whose summary the line reads
            ctx = dataclasses.replace(ctx, world=ctx.traffic["processes"], rank=0)
        got = apg_train._work(ctx, _generator_states(2, 2), 7)
    assert got == PARENT[cell]
