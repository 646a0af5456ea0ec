"""Steppers on the hand-written kernels (counterpart of
nenbody_tpu/ops/tiled.py) — same semantics as physics.dense, with the O(N^2)
interaction computed by ops.pairwise / ops.boids and the O(N) integration in
plain torch. On CPU tensors the wrappers run their plain versions."""

from __future__ import annotations

from ..config import SimConfig
from ..physics import dense
from ..state import SceneState
from .boids import boids_velocity_tiled
from .pairwise import gravity_forces_tiled


def gravity_step(state: SceneState, cfg: SimConfig, generator=None) -> SceneState:
    """Reference integration (src/main.rs:434-436): v += g*dt; x += v
    (or x += v*dt in corrected mode — dense.gravity_integrate). When
    autograd needs the forces they go through the VJP kernel's autograd
    Function (gravity_forces_tiled routes), so rollouts differentiate."""
    g = gravity_forces_tiled(state.pos, cfg.gravity)
    return dense.gravity_integrate(state, g, cfg)


def boids_step(state: SceneState, cfg: SimConfig, generator=None) -> SceneState:
    """Reference integration (src/main.rs:514-523): replace v, clamp, x += v*dt."""
    return dense.boids_integrate(
        state, boids_velocity_tiled(state.pos, state.vel, cfg.boids), cfg
    )


STEPPERS = {
    "gravity": gravity_step,
    "boids": boids_step,
    "random": dense.random_step,  # no pairwise interaction to tile
}
