"""Physics controllers: the dense PyTorch oracle (counterpart of
nenbody_tpu/physics)."""

from .dense import (
    STEPPERS,
    boids_accels,
    boids_finalize,
    boids_partials_cross,
    boids_step,
    clamp_speed,
    gravity_forces,
    gravity_forces_cross,
    gravity_step,
    random_step,
)

__all__ = [
    "STEPPERS",
    "boids_accels",
    "boids_finalize",
    "boids_partials_cross",
    "boids_step",
    "clamp_speed",
    "gravity_forces",
    "gravity_forces_cross",
    "gravity_step",
    "random_step",
]
