"""Agent-axis ring: O(N^2) interactions across a device mesh (counterpart of
nenbody_tpu/parallel/ring.py).

Each shard of the mesh's agent axis keeps its block of agents, and the
position blocks (with the velocities for boids, with the headings for
wireframe-sprite vision) circulate around the ring: at hop k shard i holds
block (i - k) mod D, the JAX package's ppermute i -> i + 1, here a peer copy
to the next shard's device (mesh.send). Each hop adds the cross-block
partial of the single-device kernels: gravity forces (hop 0, a shard's own
block, on the self form; later hops on the cross form `pos_j`), the boids
rule sums (csrc/boids_partials.cu; the diagonal masked on hop 0 only), or a
depth-merged eye render (`targets=`; vision.render.merge_rows keeps the
earlier hop's fragment on an exact depth tie, so the hop order is part of
the result). Self-pairs need nothing more: gravity's self-pair has a zero
numerator, the eyes cull a coincident target.

All entry points take GLOBAL tensors [(B,) N, 2] on any device and return
global tensors on it; a leading env batch splits over `data_axis` when one
is given. N need not divide the agent axis: far sentinels pad it
(_pad_agents). On CUDA tensors every partial is a kernel launch; on CPU
tensors its plain version.

Gradients come from autograd, not from a second hand-built ring: each hop's
partial goes through its autograd Function (GravityForcesDiff on hop 0,
GravityForcesCrossDiff later, RenderRowsDiff or RenderRowsWireframeDiff for
the eyes, each saving its own hop's winner index); merge_rows is a
torch.where, so each hop's backward gets the cotangents of exactly the
pixels its block won; and the transpose of a peer copy is the copy back, so
block gradients return home as the JAX backward ring's circulating `gblk`
does. `ring_render_rows_diff` runs the eye Functions whatever grad mode
says.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..config import SimConfig, VisionConfig
from ..ops import boids as boids_ops
from ..ops import pairwise, raycast, wireframe
from ..physics import dense
from ..state import SceneState
from ..vision import camera, render
from .mesh import AGENT_AXIS, Mesh, data_axis_of, default_mesh, gather_blocks, on_device, send
from .mesh import split_blocks


def _check_divisible(pos: torch.Tensor, mesh: Mesh, data_axis: Optional[str]) -> None:
    if pos.dim() >= 3 and data_axis is not None:
        b, db = pos.shape[0], mesh.shape[data_axis]
        if b % db:
            raise ValueError(
                f"env batch {b} must divide evenly over mesh axis {data_axis!r} (size {db})"
            )


# Sentinel coordinate for internal agent-axis padding. Far sentinels are
# EXACTLY inert for boids (every rule thresholds distances: |1e17|^2 = 1e34
# fits in fp32 and fails all) and vision (view depth > far culls), and their
# gravity contribution g * 1e17 / 1e34 ~ 1e-20 lies below one fp32 ulp of
# any real force, so any N runs on any mesh. Padded rows are sliced off.
_PAD_SENTINEL = 1e17


def _pad_agents(arrays: Sequence[torch.Tensor], n: int, d: int):
    """Pad the agent axis (-2) of each array up to a multiple of d with the
    far sentinel. Returns (padded arrays, padded n)."""
    n_pad = -(-n // d) * d
    if n_pad == n:
        return list(arrays), n
    return [torch.cat([a, a.new_full(a.shape[:-2] + (n_pad - n, a.shape[-1]), _PAD_SENTINEL)],
                      dim=-2) for a in arrays], n_pad


def _ring(mesh: Mesh, axis: str, data_axis: Optional[str], own: Sequence[torch.Tensor],
          n_circ: int, hop: Callable, finish: Callable = lambda acc: acc):
    """The hop loop. `own` [(B,) N, ...] split into each shard's blocks; the
    first `n_circ` of them circulate. acc = hop(k, own_blocks, circulating,
    acc) on each shard at each hop, on the shard's device; finish(acc) gives
    the shard's outputs (a tuple), gathered back to own[0]'s device."""
    home = own[0].device
    batch_dim = 0 if data_axis is not None and own[0].dim() >= 3 else None
    grid = mesh.grid(data_axis if batch_dim is not None else None, axis)
    d = len(grid[0])
    blocks = [split_blocks(x, grid, batch_dim) for x in own]
    outs = []
    for r, devs in enumerate(grid):
        mine = [tuple(b[r][c] for b in blocks) for c in range(d)]
        circ = [m[:n_circ] for m in mine]
        acc = [None] * d
        for k in range(d):
            for c in range(d):
                with on_device(devs[c]):
                    acc[c] = hop(k, mine[c], circ[c], acc[c])
            if k < d - 1:
                circ = [tuple(send(x, devs[c]) for x in circ[c - 1]) for c in range(d)]
        outs.append([finish(a) for a in acc])
    return tuple(gather_blocks([[o[i] for o in row] for row in outs], home, batch_dim)
                 for i in range(len(outs[0][0])))


# -- gravity ------------------------------------------------------------------


def ring_gravity_forces(
    pos: torch.Tensor,
    cfg: SimConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
) -> torch.Tensor:
    """Forces for pos [(B,) N, 2] with agents over mesh[axis]. Hop 0 takes
    the self form (gravity_forces_tiled(pos_l), whose VJP kernel takes
    u_j - u_k before any product, DESIGN.md section 4b); hops >= 1 the cross
    form. Differentiable when pos requires grad."""
    mesh = mesh or default_mesh()
    _check_divisible(pos, mesh, data_axis)
    n = pos.shape[-2]
    (pos,), _ = _pad_agents([pos], n, mesh.shape[axis])
    gcfg = cfg.gravity

    def hop(k, mine, circ, acc):
        if k == 0:
            return pairwise.gravity_forces_tiled(mine[0], gcfg)
        return acc + pairwise.gravity_forces_tiled(mine[0], gcfg, pos_j=circ[0])

    (g,) = _ring(mesh, axis, data_axis, (pos,), 1, hop, lambda acc: (acc,))
    return g[..., :n, :]


# -- boids --------------------------------------------------------------------


def ring_boids_velocity(
    pos: torch.Tensor,
    vel: torch.Tensor,
    cfg: SimConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
) -> torch.Tensor:
    """Replacement velocity (before the speed clamp) for pos, vel
    [(B,) N, 2]: each hop adds the raw rule sums of the circulating (pos,
    vel) block (csrc/boids_partials.cu, the diagonal masked by index on hop 0
    only), and dense.boids_finalize takes the guarded means once. Rule 3 is
    the full masked fold: global_alignment is the single-device kernel's."""
    mesh = mesh or default_mesh()
    _check_divisible(pos, mesh, data_axis)
    n = pos.shape[-2]
    (pos, vel), _ = _pad_agents([pos, vel], n, mesh.shape[axis])
    bcfg = cfg.boids

    def hop(k, mine, circ, acc):
        part = boids_ops.boids_partials_tiled(mine[0], mine[1], circ[0], circ[1], bcfg,
                                              exclude_diagonal=k == 0)
        return part if acc is None else tuple(a + p for a, p in zip(acc, part))

    (v,) = _ring(mesh, axis, data_axis, (pos, vel), 2, hop,
                 lambda acc: (dense.boids_finalize(acc, bcfg),))
    return v[..., :n, :]


# -- vision -------------------------------------------------------------------


def _render_ring(pos, vel, vcfg: VisionConfig, mesh: Mesh, axis: str, data_axis, diff: bool):
    """The eye ring: each shard's eyes against the circulating target
    block, depth-merged hop by hop. Disc sprites circulate positions;
    wireframe sprites also their unit headings (they turn to them; the same
    values as the JAX ring's circulating velocities give, since the heading
    is elementwise). `diff` applies the eyes' autograd Functions whatever
    grad mode says."""
    _check_divisible(pos, mesh, data_axis)
    n = pos.shape[-2]
    (pos, vel), _ = _pad_agents([pos, vel], n, mesh.shape[axis])
    dirs = camera.unit_heading(vel)
    wf = vcfg.sprite_mode == "wireframe"

    def partial(eye_pos, eye_dir, circ):
        if wf:
            if diff:
                return wireframe.RenderRowsWireframeDiff.apply(eye_pos, eye_dir, *circ, vcfg)
            return wireframe.wireframe_eye(eye_pos, eye_dir, circ[0], circ[1], vcfg)
        if diff:
            return raycast.RenderRowsDiff.apply(eye_pos, eye_dir, circ[0], vcfg)
        return raycast.disc_eye(eye_pos, eye_dir, circ[0], vcfg)

    def hop(k, mine, circ, acc):
        part = partial(mine[0], mine[1], circ)
        return part if acc is None else render.merge_rows(acc, part)

    shade, depth = _ring(mesh, axis, data_axis, (pos, dirs), 2 if wf else 1, hop)
    return shade[..., :n, :], depth[..., :n, :]


def ring_render_rows(
    pos: torch.Tensor,
    vel: torch.Tensor,
    vcfg: VisionConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(shade, depth) [(B,) N, W] with both eyes and targets over
    mesh[axis], either sprite (vcfg.sprite_mode). Any N (far-sentinel
    padding: sentinel targets cull at the far plane, padded eye rows are
    sliced off). Textures are not ported yet (ROADMAP queue 1 item 4).
    Differentiable when pos or vel requires grad."""
    return _render_ring(pos, vel, vcfg, mesh or default_mesh(), axis, data_axis, diff=False)


def ring_render_rows_diff(
    pos: torch.Tensor,
    vel: torch.Tensor,
    vcfg: VisionConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ring_render_rows through the eyes' autograd Functions whatever grad
    mode says: each hop's Function saves its own winner index, and its
    backward (the disc's or the wireframe's backward kernel on CUDA
    tensors) gets the cotangents of the pixels its block won. Needs N
    divisible by the mesh axis, as the JAX ring does. Use
    vcfg.antialias=True for useful gradients."""
    mesh = mesh or default_mesh()
    n, d = pos.shape[-2], mesh.shape[axis]
    if n % d:
        raise ValueError(
            f"ring_render_rows_diff needs agent count {n} divisible by mesh "
            f"axis {axis!r} (size {d})"
        )
    return _render_ring(pos, vel, vcfg, mesh, axis, data_axis, diff=True)


# -- steppers (Scene backend="ring") ------------------------------------------


def gravity_step(state: SceneState, cfg: SimConfig, generator=None,
                 mesh: Optional[Mesh] = None) -> SceneState:
    mesh = mesh or default_mesh()
    g = ring_gravity_forces(state.pos, cfg, mesh=mesh, data_axis=data_axis_of(mesh))
    return dense.gravity_integrate(state, g, cfg)


def boids_step(state: SceneState, cfg: SimConfig, generator=None,
               mesh: Optional[Mesh] = None) -> SceneState:
    mesh = mesh or default_mesh()
    new_vel = ring_boids_velocity(state.pos, state.vel, cfg, mesh=mesh,
                                  data_axis=data_axis_of(mesh))
    return dense.boids_integrate(state, new_vel, cfg)


def render_lines(state: SceneState, cfg: VisionConfig, mesh: Optional[Mesh] = None):
    mesh = mesh or default_mesh()
    return ring_render_rows(state.pos, state.vel, cfg, mesh=mesh, data_axis=data_axis_of(mesh))[0]


STEPPERS = {
    "gravity": gravity_step,
    "boids": boids_step,
    "random": dense.random_step,  # no pairwise interaction to ring
}
