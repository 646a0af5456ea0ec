"""Dense O(N^2) PyTorch physics — the port's reference-semantics oracle
(counterpart of nenbody_tpu/physics/dense.py).

Plain functions `state -> state` implementing exactly the update rules of
the reference controllers (src/main.rs:381-526), vectorized over the agent
axis. Every update reads only the input state, so the reference's
`old_positions`/`old_velocities` double buffer is unnecessary. These are
also the plain versions the CUDA kernels in nenbody_tpu_torch/ops are held
against, and they stay differentiable by autograd. All math is float32.

The full [..., N, N] interaction tensors are materialized; the ops modules
chunk them over i for large N.
"""

from __future__ import annotations

import torch

from ..config import BoidsConfig, GravityConfig, SimConfig
from ..state import SceneState


def gravity_forces_cross(
    pos_i: torch.Tensor, pos_j: torch.Tensor, cfg: GravityConfig
) -> torch.Tensor:
    """Gravity exerted BY the set pos_j ON the set pos_i (pre-summed).

    pos_i: [..., N, 2], pos_j: [..., M, 2] -> [..., N, 2]. Coincident pairs
    (including i == j when the blocks alias) contribute zero numerator with
    a bias-softened denominator, exactly the reference self-pair behavior.
    """
    diff = pos_j[..., None, :, :] - pos_i[..., :, None, :]  # [..., i, j, 2]
    dx, dy = diff[..., 0], diff[..., 1]
    d2 = dx * dx + dy * dy + cfg.bias  # [..., i, j]
    return cfg.g * (diff / d2[..., None]).sum(dim=-2)


def gravity_forces(pos: torch.Tensor, cfg: GravityConfig) -> torch.Tensor:
    """Per-agent accumulated gravity, reference force law (src/main.rs:425-432).

    g_i = sum_j (x_j - x_i) * g / (|x_j - x_i|^2 + bias), self-pair included
    (zero numerator; `bias` keeps the denominator finite) — a 1/r law.

    pos: [..., N, 2] -> [..., N, 2]
    """
    return gravity_forces_cross(pos, pos, cfg)


def gravity_integrate(state: SceneState, g: torch.Tensor, cfg: SimConfig) -> SceneState:
    """Shared semi-implicit Euler tail. Reference mode (default): dt applies
    to the velocity update only, the position integrates one full velocity
    per step (src/main.rs:434-436); `dt_on_position=True` is the corrected
    standard integrator."""
    vel = state.vel + g * cfg.gravity.dt
    pos = state.pos + vel * (cfg.gravity.dt if cfg.gravity.dt_on_position else 1.0)
    return state.replace(pos=pos, vel=vel, t=state.t + 1)


def gravity_step(state: SceneState, cfg: SimConfig, generator=None) -> SceneState:
    return gravity_integrate(state, gravity_forces(state.pos, cfg.gravity), cfg)


def boids_partials_cross(
    pos_i: torch.Tensor,
    vel_i: torch.Tensor,
    pos_j: torch.Tensor,
    vel_j: torch.Tensor,
    cfg: BoidsConfig,
    exclude_diagonal: bool = True,
    i_offset: int = 0,
    skip_alignment: bool = False,
):
    """Raw flocking-rule accumulators of the j-set against the i-set.

    Returns (sum1 [...,N,2], cnt1 [...,N], repel [...,N,2], sum3 [...,N,2],
    cnt3 [...,N]), additive across j-blocks. `exclude_diagonal` masks the
    pairs with global index i + i_offset == j (only meaningful when pos_j
    holds the whole set and pos_i its rows from i_offset on).
    `skip_alignment` leaves the alignment partials at zero (the kernel's
    global_alignment mode).
    """
    diff = pos_j[..., None, :, :] - pos_i[..., :, None, :]  # [..., i, j, 2]
    dx, dy = diff[..., 0], diff[..., 1]
    d2 = dx * dx + dy * dy  # [..., i, j]

    n = pos_i.shape[-2]
    m = pos_j.shape[-2]
    if exclude_diagonal:
        ii = torch.arange(n, device=pos_i.device)[:, None] + i_offset
        not_self = ii != torch.arange(m, device=pos_i.device)[None, :]
    else:
        not_self = torch.ones((n, m), dtype=torch.bool, device=pos_i.device)
    zero = torch.zeros((), dtype=pos_i.dtype, device=pos_i.device)

    # Rule 1 — cohesion: neighbor positions with d^2 < threshold
    # (squared-distance threshold, src/main.rs:474).
    m1 = (d2 < cfg.cohesion_dist_sq) & not_self
    cnt1 = m1.sum(dim=-1).to(pos_i.dtype)
    sum1 = torch.where(m1[..., None], pos_j[..., None, :, :], zero).sum(dim=-2)

    # Rule 2 — separation: -sum (x_j - x_i) for d < threshold (UNsquared
    # threshold, src/main.rs:485 — compared as d^2 < thr^2).
    m2 = (d2 < cfg.separation_dist * cfg.separation_dist) & not_self
    repel = -torch.where(m2[..., None], diff, zero).sum(dim=-2)

    if skip_alignment:
        return sum1, cnt1, repel, torch.zeros_like(sum1), torch.zeros_like(cnt1)
    # Rule 3 — alignment: v_j for |v_j - v_i| < threshold, measured in
    # VELOCITY space (src/main.rs:497).
    vdiff = vel_j[..., None, :, :] - vel_i[..., :, None, :]
    vdx, vdy = vdiff[..., 0], vdiff[..., 1]
    vd2 = vdx * vdx + vdy * vdy
    m3 = (vd2 < cfg.alignment_dist * cfg.alignment_dist) & not_self
    cnt3 = m3.sum(dim=-1).to(vel_i.dtype)
    sum3 = torch.where(m3[..., None], vel_j[..., None, :, :], zero).sum(dim=-2)
    return sum1, cnt1, repel, sum3, cnt3


def boids_finalize(partials, cfg: BoidsConfig) -> torch.Tensor:
    """Combine accumulated rule partials into the replacement velocity
    (guarded count divisions src/main.rs:506-512, weighted sum main.rs:514),
    before the speed clamp."""
    sum1, cnt1, repel, sum3, cnt3 = partials
    center = torch.where(
        cnt1[..., None] > 0, sum1 / cnt1.clamp(min=1.0)[..., None], sum1
    )
    vmatch = torch.where(
        cnt3[..., None] > 0, sum3 / cnt3.clamp(min=1.0)[..., None], sum3
    )
    return (
        center * cfg.cohesion_scale
        + repel * cfg.separation_scale
        + vmatch * cfg.alignment_scale
    )


def boids_accels(pos: torch.Tensor, vel: torch.Tensor, cfg: BoidsConfig) -> torch.Tensor:
    """The three flocking rules, reference semantics (src/main.rs:465-514).

    Returns the REPLACEMENT velocity (the reference overwrites v rather than
    accumulating, src/main.rs:514), before the speed clamp.

    pos, vel: [..., N, 2] -> new_vel [..., N, 2]
    """
    return boids_finalize(
        boids_partials_cross(pos, vel, pos, vel, cfg, exclude_diagonal=True), cfg
    )


def clamp_speed(vel: torch.Tensor, max_speed: float) -> torch.Tensor:
    """`normalize_to(max_speed)` when |v| exceeds it (src/main.rs:516-518)."""
    mag = torch.sqrt((vel * vel).sum(dim=-1, keepdim=True))
    scale = torch.where(
        mag > max_speed, max_speed / mag.clamp(min=1e-30), torch.ones_like(mag)
    )
    return vel * scale


def boids_integrate(state: SceneState, new_vel: torch.Tensor, cfg: SimConfig) -> SceneState:
    """Clamp the replacement velocity and move, x += v * dt
    (src/main.rs:514-523 — boids DOES apply dt to position, unlike gravity)."""
    new_vel = clamp_speed(new_vel, cfg.boids.max_speed)
    pos = state.pos + new_vel * cfg.boids.dt
    return state.replace(pos=pos, vel=new_vel, t=state.t + 1)


def boids_step(state: SceneState, cfg: SimConfig, generator=None) -> SceneState:
    """Flocking step: replace velocity, clamp speed, x += v * dt."""
    return boids_integrate(state, boids_accels(state.pos, state.vel, cfg.boids), cfg)


def random_step(
    state: SceneState, cfg: SimConfig, generator: torch.Generator | None = None
) -> SceneState:
    """Random walk: v += U(-accel, accel) per axis; x += v
    (src/main.rs:381-402). Draws from the caller's `generator` (which must
    live on the state's device) rather than the reference's unseeded
    thread_rng."""
    a = cfg.random_walk.accel
    u = torch.rand(
        state.vel.shape, generator=generator, device=state.vel.device,
        dtype=state.vel.dtype,
    )
    vel = state.vel + (u * (2.0 * a) - a)
    pos = state.pos + vel
    return state.replace(pos=pos, vel=vel, t=state.t + 1)


STEPPERS = {
    "gravity": gravity_step,
    "boids": boids_step,
    "random": random_step,
}
