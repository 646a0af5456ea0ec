"""The gspmd backend: each shard's rows against every agent, on plain
PyTorch (counterpart of nenbody_tpu/parallel/auto.py).

In the JAX package GSPMD partitions the dense force law by sharding
annotations: the i-axis of the [N, N] interaction over the agent mesh axis,
with the j-side all-gathered by the compiler. The port has no partitioning
compiler, so the same program is written out: each shard takes its block of
i-rows and the whole position set, gathered to its device, and evaluates the
dense cross forms of physics.dense there. It materializes [N/D, N] pair
tensors per shard, and is the ring's independent cross-check (the two must
agree; tests/test_torch_ring.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import SimConfig
from ..physics import dense
from ..state import SceneState
from .mesh import AGENT_AXIS, Mesh, data_axis_of, default_mesh, gather_blocks, on_device
from .mesh import split_blocks
from .ring import _check_divisible


def _rows_against_all(arrays, mesh: Mesh, axis: str, data_axis: Optional[str], fn):
    """fn(i-row blocks, whole arrays, row offset) on each shard's device, its
    output gathered back to arrays[0]'s device."""
    _check_divisible(arrays[0], mesh, data_axis)
    home = arrays[0].device
    batch_dim = 0 if data_axis is not None and arrays[0].dim() >= 3 else None
    grid = mesh.grid(data_axis if batch_dim is not None else None, axis)
    rows = [split_blocks(x, grid, batch_dim) for x in arrays]
    whole = [split_blocks(x, grid, batch_dim, agent_dim=None) for x in arrays]
    out = []
    for r, devs in enumerate(grid):
        offset, row = 0, []
        for c, dev in enumerate(devs):
            mine = [b[r][c] for b in rows]
            with on_device(dev):
                row.append(fn(mine, [w[r][c] for w in whole], offset))
            offset += mine[0].shape[-2]
        out.append(row)
    return gather_blocks(out, home, batch_dim)


def auto_gravity_forces(
    pos: torch.Tensor,
    cfg: SimConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
) -> torch.Tensor:
    """Dense force law with the i-rows split over mesh[axis]."""
    return _rows_against_all(
        [pos], mesh or default_mesh(), axis, data_axis,
        lambda mine, whole, offset: dense.gravity_forces_cross(mine[0], whole[0], cfg.gravity))


def auto_boids_velocity(
    pos: torch.Tensor,
    vel: torch.Tensor,
    cfg: SimConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
) -> torch.Tensor:
    def rows(mine, whole, offset):
        parts = dense.boids_partials_cross(mine[0], mine[1], whole[0], whole[1], cfg.boids,
                                           exclude_diagonal=True, i_offset=offset)
        return dense.boids_finalize(parts, cfg.boids)

    return _rows_against_all([pos, vel], mesh or default_mesh(), axis, data_axis, rows)


def gravity_step(state: SceneState, cfg: SimConfig, generator=None,
                 mesh: Optional[Mesh] = None) -> SceneState:
    mesh = mesh or default_mesh()
    g = auto_gravity_forces(state.pos, cfg, mesh=mesh, data_axis=data_axis_of(mesh))
    return dense.gravity_integrate(state, g, cfg)


def boids_step(state: SceneState, cfg: SimConfig, generator=None,
               mesh: Optional[Mesh] = None) -> SceneState:
    mesh = mesh or default_mesh()
    nv = auto_boids_velocity(state.pos, state.vel, cfg, mesh=mesh, data_axis=data_axis_of(mesh))
    return dense.boids_integrate(state, nv, cfg)


STEPPERS = {
    "gravity": gravity_step,
    "boids": boids_step,
    "random": dense.random_step,
}
