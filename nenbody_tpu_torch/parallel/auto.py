"""The gspmd backend: each shard's rows against every agent, on plain
PyTorch (counterpart of nenbody_tpu/parallel/auto.py).

In the JAX package GSPMD partitions the dense force law by sharding
annotations: the i-axis of the [N, N] interaction over the agent mesh axis,
with the j-side all-gathered by the compiler. The port has no partitioning
compiler, so the same program is written out: each shard takes its block of
i-rows and the whole position set, gathered to its device, and evaluates the
dense cross forms of physics.dense there. It materializes [N/D, N] pair
tensors per shard, and is the ring's independent cross-check (the two must
agree; tests/test_torch_ring.py). On a mesh across processes it takes
mesh.GlobalTensors: each process evaluates its own shards' rows against
the whole arrays, all-gathered over the process group (dist.all_gather);
there the eye's rows are rendered so too (auto_render_rows, the dense eye
Scene's gspmd route takes), and the steppers take GlobalTensor states
(parallel/ring.py's mesh_of).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import SimConfig, VisionConfig
from ..physics import dense
from ..state import SceneState
from ..vision import render
from .mesh import AGENT_AXIS, Mesh, default_mesh, gather_blocks, gather_global, on_device
from .mesh import split_blocks
from .ring import _check_divisible, _global_inputs, integrate_blocks, mesh_of, random_step


def _rows_against_all(arrays, mesh: Mesh, axis: str, data_axis: Optional[str], fn):
    """fn(i-row blocks, whole arrays, row offset) on each shard's device, its
    output (a tensor or a tuple of them) gathered back to arrays[0]'s
    device. Global tensors (a mesh
    across processes): this process's shards only, the whole arrays
    all-gathered over the group (mesh.gather_global, what XLA inserts for
    the JAX gspmd backend), and the result global again."""
    _check_divisible(arrays[0], mesh, data_axis)
    glob = arrays[0] if _global_inputs(arrays, mesh) else None
    batch_dim = 0 if data_axis is not None and arrays[0].dim() >= 3 else None
    row_axis = data_axis if batch_dim is not None else None
    grid = mesh.grid(row_axis, axis)
    rows, cols = mesh.own(row_axis, axis)
    sub = [[grid[r][c] for c in cols] for r in rows]
    whole, offset0 = arrays, 0
    if glob is not None:
        whole = [gather_global(x) for x in arrays]
        if batch_dim is not None:  # this process's envs
            b = glob.local.shape[0]
            whole = [x[b // len(rows) * rows.start:][:b] for x in whole]
        arrays = [x.local for x in arrays]
        offset0 = cols.start * (arrays[0].shape[-2] // len(cols))
    home = arrays[0].device
    row_blocks = [split_blocks(x, sub, batch_dim) for x in arrays]
    whole = [split_blocks(x, sub, batch_dim, agent_dim=None) for x in whole]
    out = []
    for r, devs in enumerate(sub):
        offset, row = offset0, []
        for c, dev in enumerate(devs):
            mine = [b[r][c] for b in row_blocks]
            with on_device(dev):
                row.append(fn(mine, [w[r][c] for w in whole], offset))
            offset += mine[0].shape[-2]
        out.append(row)
    single = isinstance(out[0][0], torch.Tensor)
    parts = [out] if single else [[[o[i] for o in row] for row in out]
                                  for i in range(len(out[0][0]))]
    results = [gather_blocks(p, home, batch_dim) for p in parts]
    if glob is not None:
        results = [glob.with_local(x) for x in results]
    return results[0] if single else tuple(results)


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


def auto_render_rows(
    pos: torch.Tensor,
    vel: torch.Tensor,
    vcfg: VisionConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
    texture: Optional[torch.Tensor] = None,
):
    """(shade, depth) [(B,) N, W]: each shard's eyes against every agent on
    the dense eye (vision.render.render_rows' targets), the eye rows split
    over mesh[axis]."""
    return _rows_against_all(
        [pos, vel], mesh or default_mesh(), axis, data_axis,
        lambda mine, whole, offset: render.render_rows(
            mine[0], mine[1], vcfg, targets=whole[0], target_vel=whole[1], texture=texture))


def gravity_step(state: SceneState, cfg: SimConfig, generator=None,
                 mesh: Optional[Mesh] = None) -> SceneState:
    mesh, data_axis = mesh_of(state.pos, mesh, "the gspmd backend's stepper")
    g = auto_gravity_forces(state.pos, cfg, mesh=mesh, data_axis=data_axis)
    return integrate_blocks(dense.gravity_integrate, state, g, cfg)


def boids_step(state: SceneState, cfg: SimConfig, generator=None,
               mesh: Optional[Mesh] = None) -> SceneState:
    mesh, data_axis = mesh_of(state.pos, mesh, "the gspmd backend's stepper")
    nv = auto_boids_velocity(state.pos, state.vel, cfg, mesh=mesh, data_axis=data_axis)
    return integrate_blocks(dense.boids_integrate, state, nv, cfg)


STEPPERS = {
    "gravity": gravity_step,
    "boids": boids_step,
    "random": random_step,
}
