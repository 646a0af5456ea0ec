"""Agent-axis ring: O(N^2) interactions across a device mesh (counterpart of
nenbody_tpu/parallel/ring.py).

Each shard of the mesh's agent axis keeps its block of agents, and the
position blocks (with the velocities for boids, with the headings for
wireframe-sprite vision) circulate around the ring: at hop k shard i holds
block (i - k) mod D, the JAX package's ppermute i -> i + 1, here a peer copy
to the next shard's device (mesh.send). Each hop adds the cross-block
partial of the single-device kernels: gravity forces (hop 0, a shard's own
block, on the self form; later hops on the cross form `pos_j`), the boids
rule sums (csrc/boids.cu's partials; the diagonal masked on hop 0 only), or a
depth-merged eye render (`targets=`; vision.render.merge_rows keeps the
earlier hop's fragment on an exact depth tie, so the hop order is part of
the result). Self-pairs need nothing more: gravity's self-pair has a zero
numerator, the eyes cull a coincident target.

All entry points take GLOBAL tensors [(B,) N, 2] on any device and return
global tensors on it; a leading env batch splits over `data_axis` when one
is given. N need not divide the agent axis: far sentinels pad it
(_pad_agents). On CUDA tensors every partial is a kernel launch; on CPU
tensors its plain version.

On a mesh across processes (mesh.init_distributed) the entry points take
mesh.GlobalTensors (mesh.global_state) and return them: each process runs
the hops of its own shards on its local block, the shift between two of
its shards stays a copy, and the shift from its last shard to the next
process's first is one dist.batch_isend_irecv per hop (mesh.exchange), so
no rank waits on another's order. There N must divide the agent axis, as
the JAX global arrays require. The exchange is an autograd Function (one
node a hop for all rows), so a gradient crosses the boundary too: every
process runs backward at once, and each hop's node sends the cotangents of
the blocks it received back to their sender, in reverse hop order.

Gradients come from autograd, not from a second hand-built ring: each hop's
partial goes through its autograd Function (GravityForcesDiff on hop 0,
GravityForcesCrossDiff later, RenderRowsDiff or RenderRowsWireframeDiff for
the eyes, each saving its own hop's winner index); merge_rows is a
torch.where, so each hop's backward gets the cotangents of exactly the
pixels its block won; and the transpose of a peer copy (or of an exchange
across processes) is the copy back, so block gradients return home as the
JAX backward ring's circulating `gblk` does. `ring_render_rows_diff` runs
the eye Functions whatever grad mode says.

The steppers (Scene's backend="ring") take states of plain tensors on a
one-process mesh, or of GlobalTensors (mesh.global_state) on their own
mesh, which may span processes: the ring runs across it, the integration
on each process's block.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..config import SimConfig, VisionConfig
from ..ops import boids as boids_ops
from ..ops import library, pairwise, raycast, wireframe
from ..physics import dense
from ..state import SceneState
from ..vision import camera, render
from .mesh import AGENT_AXIS, GlobalTensor, Mesh, _block, data_axis_of, default_mesh, exchange
from .mesh import gather_blocks, like_global, local_blocks, local_mesh, on_device, send
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


def _global_inputs(arrays: Sequence, mesh: Mesh) -> bool:
    """True where the inputs are GlobalTensors on `mesh`, False where they
    are plain tensors on a one-process mesh. A mesh across processes takes
    GlobalTensors only: a plain tensor there would be cut into this
    process's shards whole, and each row would add up every block twice."""
    glob = [isinstance(x, GlobalTensor) for x in arrays]
    if mesh.distributed and not all(glob):
        raise ValueError("a mesh across processes takes GlobalTensors (mesh.global_state or "
                         "mesh.lift of this process's block), got a plain tensor")
    if any(glob) and not all(x.mesh is mesh for x in arrays):
        raise ValueError("the ring's global inputs live on another mesh")
    return any(glob)


def _prepare(arrays: Sequence, mesh: Mesh, axis: str, data_axis: Optional[str]):
    """(arrays padded to the agent axis, n): global tensors unpadded, whose
    N must divide the axis."""
    _check_divisible(arrays[0], mesh, data_axis)
    n, d = arrays[0].shape[-2], mesh.shape[axis]
    if _global_inputs(arrays, mesh):
        if n % d:
            raise ValueError(f"agent count {n} must divide evenly over mesh axis {axis!r} "
                             f"(size {d}) across processes")
        return list(arrays), n
    return _pad_agents(arrays, n, d)[0], n


def _trim(x, n: int):
    """A padded result's first n agents (a global tensor has no padding)."""
    return x if isinstance(x, GlobalTensor) else x[..., :n, :]


def _shift(circ, rows, cols, grid, ranks, d: int):
    """Each shard's circulating blocks to the next shard of its row (i ->
    i + 1 mod d): `send` between two shards of this process, and from this
    process's last shard to the next process's first one exchange for all
    rows, so that no rank deadlocks."""
    out, sends, recvs = [], [], []
    for i, r in enumerate(rows):
        if len(cols) == d:  # the whole row is this process's
            out.append([tuple(send(x, grid[r][c]) for x in circ[i][j - 1])
                        for j, c in enumerate(cols)])
            continue
        out.append([None] + [tuple(send(x, grid[r][c]) for x in circ[i][j - 1])
                             for j, c in enumerate(cols) if j > 0])
        nxt, prv = ranks[r][cols.stop % d], ranks[r][(cols.start - 1) % d]
        m = len(circ[i][-1])
        sends += [(x, nxt, r * m + t) for t, x in enumerate(circ[i][-1])]
        recvs += [(x, grid[r][cols.start], prv, r * m + t) for t, x in enumerate(circ[i][0])]
    got = iter(exchange(sends, recvs))
    for i, row in enumerate(out):
        if row[0] is None:
            row[0] = tuple(next(got) for _ in circ[i][0])
    return out


def _ring(mesh: Mesh, axis: str, data_axis: Optional[str], own: Sequence,
          n_circ: int, hop: Callable, finish: Callable = lambda acc: acc):
    """The hop loop. `own` [(B,) N, ...] split into each shard's blocks; the
    first `n_circ` of them circulate. acc = hop(k, own_blocks, circulating,
    acc) on each shard at each hop, on the shard's device; finish(acc) gives
    the shard's outputs (a tuple), gathered back to own[0]'s device. Global
    tensors: this process's shards only, its local blocks in and out."""
    glob = own[0] if _global_inputs(own, mesh) else None
    if glob is not None:
        own = [x.local for x in own]
    home = own[0].device
    batch_dim = 0 if data_axis is not None and own[0].dim() >= 3 else None
    row_axis = data_axis if batch_dim is not None else None
    grid, ranks = mesh.grid(row_axis, axis), mesh.rank_grid(row_axis, axis)
    rows, cols = mesh.own(row_axis, axis)
    d = len(grid[0])
    blocks = [split_blocks(x, [[grid[r][c] for c in cols] for r in rows], batch_dim)
              for x in own]
    mine = [[tuple(b[i][j] for b in blocks) for j in range(len(cols))] for i in range(len(rows))]
    circ = [[m[:n_circ] for m in row] for row in mine]
    acc = [[None] * len(cols) for _ in rows]
    for k in range(d):
        for i, r in enumerate(rows):
            for j, c in enumerate(cols):
                with on_device(grid[r][c]):
                    acc[i][j] = hop(k, mine[i][j], circ[i][j], acc[i][j])
        if k < d - 1:
            circ = _shift(circ, rows, cols, grid, ranks, d)
    outs = [[finish(a) for a in row] for row in acc]
    result = tuple(gather_blocks([[o[i] for o in row] for row in outs], home, batch_dim)
                   for i in range(len(outs[0][0])))
    return result if glob is None else tuple(glob.with_local(x) for x in result)


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
    form. Differentiable when pos requires grad. Under torch.export the
    hops go through ops/library.py's custom ops (the same kernels, so the
    same bits; utils/export.py's fleet step)."""
    mesh = mesh or default_mesh()
    (pos,), n = _prepare([pos], mesh, axis, data_axis)
    gcfg = cfg.gravity
    if torch.compiler.is_exporting():
        self_form, cross_form = library.gravity_forces, library.gravity_forces_cross
    else:
        self_form = pairwise.gravity_forces_tiled

        def cross_form(p, pj, c):
            return pairwise.gravity_forces_tiled(p, c, pos_j=pj)

    def hop(k, mine, circ, acc):
        if k == 0:
            return self_form(mine[0], gcfg)
        return acc + cross_form(mine[0], circ[0], gcfg)

    (g,) = _ring(mesh, axis, data_axis, (pos,), 1, hop, lambda acc: (acc,))
    return _trim(g, n)


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
    vel) block (csrc/boids.cu's partials, the diagonal masked by index on hop 0
    only), and dense.boids_finalize takes the guarded means once. Rule 3 is
    the full masked fold: global_alignment is the single-device kernel's."""
    mesh = mesh or default_mesh()
    (pos, vel), n = _prepare([pos, vel], mesh, axis, data_axis)
    bcfg = cfg.boids

    def hop(k, mine, circ, acc):
        part = boids_ops.boids_partials_tiled(mine[0], mine[1], circ[0], circ[1], bcfg,
                                              exclude_diagonal=k == 0)
        return part if acc is None else tuple(a + p for a, p in zip(acc, part))

    (v,) = _ring(mesh, axis, data_axis, (pos, vel), 2, hop,
                 lambda acc: (dense.boids_finalize(acc, bcfg),))
    return _trim(v, n)


# -- vision -------------------------------------------------------------------


def _render_ring(pos, vel, vcfg: VisionConfig, mesh: Mesh, axis: str, data_axis, diff: bool,
                 texture: Optional[torch.Tensor] = None):
    """The eye ring: each shard's eyes against the circulating target
    block, depth-merged hop by hop. Disc sprites circulate positions;
    wireframe sprites also their unit headings (they turn to them; the same
    values as the JAX ring's circulating velocities give, since the heading
    is elementwise). `diff` applies the eyes' autograd Functions whatever
    grad mode says. A texture is replicated: each hop samples its copy on
    the shard's device, and a pixel's merged shade is the one hop's that
    won it. Under torch.export the hops go through the eyes' custom ops,
    the forward without a texture."""
    exporting = torch.compiler.is_exporting()
    if exporting and (diff or texture is not None):
        raise ValueError("the exported eye ring is the forward without a texture")
    (pos, vel), n = _prepare([pos, vel], mesh, axis, data_axis)
    if isinstance(vel, GlobalTensor):
        dirs = vel.with_local(camera.unit_heading(vel.local))
    else:
        dirs = camera.unit_heading(vel)
    wf = vcfg.sprite_mode == "wireframe"

    copies = {}  # the replicated texture, one copy per device

    def partial(eye_pos, eye_dir, circ):
        if exporting:
            return library.eye_against(eye_pos, eye_dir, circ[0], circ[-1], vcfg)
        tex = None
        if texture is not None:
            tex = copies.setdefault(eye_pos.device, texture.to(eye_pos.device))
        if wf:
            if diff:
                return wireframe.RenderRowsWireframeDiff.apply(eye_pos, eye_dir, *circ, vcfg, None,
                                                               tex)
            return wireframe.wireframe_eye(eye_pos, eye_dir, circ[0], circ[1], vcfg, texture=tex)
        if diff:
            if tex is not None:
                raise NotImplementedError("the disc eye has no gradient with a texture")
            return raycast.RenderRowsDiff.apply(eye_pos, eye_dir, circ[0], vcfg)
        return raycast.disc_eye(eye_pos, eye_dir, circ[0], vcfg, texture=tex)

    def hop(k, mine, circ, acc):
        part = partial(mine[0], mine[1], circ)
        return part if acc is None else render.merge_rows(acc, part)

    shade, depth = _ring(mesh, axis, data_axis, (pos, dirs), 2 if wf else 1, hop)
    return _trim(shade, n), _trim(depth, n)


def ring_render_rows(
    pos: torch.Tensor,
    vel: torch.Tensor,
    vcfg: VisionConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
    texture: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(shade, depth) [(B,) N, W] with both eyes and targets over
    mesh[axis], either sprite (vcfg.sprite_mode). Any N (far-sentinel
    padding: sentinel targets cull at the far plane, padded eye rows are
    sliced off). `texture` [Ht, Wt] is the skin every hop samples (the JAX
    ring's replicated texture; it takes no per-agent albedo, nor does this
    one). Differentiable when pos or vel requires grad (the wireframe with
    a texture too). Under torch.export as ring_gravity_forces' (no
    texture)."""
    return _render_ring(pos, vel, vcfg, mesh or default_mesh(), axis, data_axis, diff=False,
                        texture=texture)


def ring_render_rows_diff(
    pos: torch.Tensor,
    vel: torch.Tensor,
    vcfg: VisionConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
    data_axis: Optional[str] = None,
    texture: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ring_render_rows through the eyes' autograd Functions whatever grad
    mode says: each hop's Function saves its own winner index, and its
    backward (the disc's or the wireframe's backward kernel on CUDA
    tensors) gets the cotangents of the pixels its block won. Needs N
    divisible by the mesh axis, as the JAX ring does. Use
    vcfg.antialias=True for useful gradients. With a `texture` (wireframe
    sprites only: the disc has no textured gradient) its gradient adds over
    the hops."""
    mesh = mesh or default_mesh()
    n, d = pos.shape[-2], mesh.shape[axis]
    if n % d:
        raise ValueError(
            f"ring_render_rows_diff needs agent count {n} divisible by mesh "
            f"axis {axis!r} (size {d})"
        )
    return _render_ring(pos, vel, vcfg, mesh, axis, data_axis, diff=True, texture=texture)


# -- steppers (Scene backend="ring") ------------------------------------------


def mesh_of(x, mesh: Optional[Mesh], what: str) -> Tuple[Mesh, Optional[str]]:
    """(mesh, data axis) for a stepper or render of `what` on `x`: a
    GlobalTensor's own mesh (`mesh`, if given, must be it) with its env
    axis split as its spec says; for a plain tensor local_mesh(mesh) and its
    data axis."""
    if isinstance(x, GlobalTensor):
        if mesh is not None and mesh is not x.mesh:
            raise ValueError(f"{what}: the state lives on another mesh than {mesh}")
        return x.mesh, (x.spec[0] if x.dim() >= 3 else None)
    mesh = local_mesh(mesh, what)
    return mesh, data_axis_of(mesh)


def integrate_blocks(integrate: Callable, state: SceneState, update, cfg: SimConfig) -> SceneState:
    """integrate(state, update, cfg), elementwise, on each process's block
    of a GlobalTensor state (the state itself where it is plain)."""
    out = integrate(local_blocks(state), getattr(update, "local", update), cfg)
    return like_global(out, state)


def gravity_step(state: SceneState, cfg: SimConfig, generator=None,
                 mesh: Optional[Mesh] = None) -> SceneState:
    mesh, data_axis = mesh_of(state.pos, mesh, "the ring backend's stepper")
    g = ring_gravity_forces(state.pos, cfg, mesh=mesh, data_axis=data_axis)
    return integrate_blocks(dense.gravity_integrate, state, g, cfg)


def boids_step(state: SceneState, cfg: SimConfig, generator=None,
               mesh: Optional[Mesh] = None) -> SceneState:
    mesh, data_axis = mesh_of(state.pos, mesh, "the ring backend's stepper")
    new_vel = ring_boids_velocity(state.pos, state.vel, cfg, mesh=mesh, data_axis=data_axis)
    return integrate_blocks(dense.boids_integrate, state, new_vel, cfg)


def random_step(state: SceneState, cfg: SimConfig, generator=None,
                mesh: Optional[Mesh] = None) -> SceneState:
    """dense.random_step (no pairwise interaction to ring). On a
    GlobalTensor state the walk's noise is drawn whole from `generator`
    (every process's alike) and this process's block kept: the draws of
    one process's run."""
    vel = state.vel
    if not isinstance(vel, GlobalTensor):
        return dense.random_step(state, cfg, generator)
    a = cfg.random_walk.accel
    u = torch.rand(vel.shape, generator=generator, device=vel.local.device,
                   dtype=vel.local.dtype)[_block(vel.mesh, vel.spec, vel.shape)]
    local = local_blocks(state)
    new_vel = local.vel + (u * (2.0 * a) - a)
    return like_global(local.replace(pos=local.pos + new_vel, vel=new_vel, t=local.t + 1), state)


def render_lines(state: SceneState, cfg: VisionConfig, mesh: Optional[Mesh] = None):
    mesh, data_axis = mesh_of(state.pos, mesh, "the ring backend's render")
    return ring_render_rows(state.pos, state.vel, cfg, mesh=mesh, data_axis=data_axis)[0]


STEPPERS = {
    "gravity": gravity_step,
    "boids": boids_step,
    "random": random_step,
}
