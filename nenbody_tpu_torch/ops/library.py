"""The serving paths' forward kernels as torch.library custom ops, so that
torch.export can trace a step that launches them (utils/export.py): it
cannot trace through the ctypes launches of the kernels' wrappers.

    nenbody::gravity_forces   pairwise.gravity_forces_tiled
    nenbody::boids_velocity   boids.boids_velocity_tiled
    nenbody::disc_rows        raycast.render_rows_tiled
    nenbody::wireframe_rows   wireframe.render_rows_wireframe_tiled

Each op calls the public forward wrapper, so on a CUDA tensor it launches
the kernel (and counts the launch) and on a CPU tensor it runs the plain
version. A config dataclass is not an op argument, so its fields go in as
scalars; the helpers below take the config and unpack it. No wrapper
computes a data-dependent shape, so each fake implementation only
allocates its outputs. Importing nenbody_tpu_torch registers the ops: that
is all a site that loads an exported step needs.

Only the export modules call these ops; the live paths (Scene, VisionEnv,
the trainers) keep calling the wrappers directly, without the op
dispatch's host cost.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from ..config import BoidsConfig, GravityConfig, VisionConfig
from . import boids, pairwise, raycast, wireframe


@torch.library.custom_op("nenbody::gravity_forces", mutates_args=())
def _gravity_forces(pos: Tensor, g: float, bias: float, approx_reciprocal: bool) -> Tensor:
    cfg = GravityConfig(g=g, bias=bias, approx_reciprocal=approx_reciprocal)
    return pairwise.gravity_forces_tiled(pos.contiguous(), cfg)


@_gravity_forces.register_fake
def _(pos, g, bias, approx_reciprocal):
    return torch.empty_like(pos)


@torch.library.custom_op("nenbody::boids_velocity", mutates_args=())
def _boids_velocity(pos: Tensor, vel: Tensor, cohesion_dist_sq: float, separation_dist: float,
                    alignment_dist: float, cohesion_scale: float, separation_scale: float,
                    alignment_scale: float, global_alignment: bool) -> Tensor:
    cfg = BoidsConfig(cohesion_dist_sq=cohesion_dist_sq, separation_dist=separation_dist,
                      alignment_dist=alignment_dist, cohesion_scale=cohesion_scale,
                      separation_scale=separation_scale, alignment_scale=alignment_scale,
                      global_alignment=global_alignment)
    return boids.boids_velocity_tiled(pos.contiguous(), vel.contiguous(), cfg)


@_boids_velocity.register_fake
def _(pos, vel, *scalars):
    return torch.empty_like(pos)


def _eye_op(name: str, sprite_mode: str, render):
    @torch.library.custom_op(f"nenbody::{name}", mutates_args=())
    def op(pos: Tensor, vel: Tensor, width: int, hfov_deg: float, near: float, far: float,
           sprite_radius: float, background: float, sprite_albedo: float,
           antialias: bool) -> Tuple[Tensor, Tensor]:
        cfg = VisionConfig(width=width, hfov_deg=hfov_deg, near=near, far=far,
                           sprite_radius=sprite_radius, background=background,
                           sprite_albedo=sprite_albedo, antialias=antialias,
                           sprite_mode=sprite_mode)
        return render(pos.contiguous(), vel.contiguous(), cfg)

    @op.register_fake
    def _(pos, vel, width, *scalars):
        shape = (*pos.shape[:-1], width)
        return pos.new_empty(shape), pos.new_empty(shape)

    return op


_disc_rows = _eye_op("disc_rows", "disc", raycast.render_rows_tiled)
_wireframe_rows = _eye_op("wireframe_rows", "wireframe", wireframe.render_rows_wireframe_tiled)


def gravity_forces(pos: Tensor, cfg: GravityConfig) -> Tensor:
    """nenbody::gravity_forces: forces on pos [..., N, 2]."""
    return torch.ops.nenbody.gravity_forces(pos, cfg.g, cfg.bias, cfg.approx_reciprocal)


def boids_velocity(pos: Tensor, vel: Tensor, cfg: BoidsConfig) -> Tensor:
    """nenbody::boids_velocity: the replacement velocity before the clamp."""
    return torch.ops.nenbody.boids_velocity(
        pos, vel, cfg.cohesion_dist_sq, cfg.separation_dist, cfg.alignment_dist,
        cfg.cohesion_scale, cfg.separation_scale, cfg.alignment_scale, cfg.global_alignment)


def render_rows(pos: Tensor, vel: Tensor, cfg: VisionConfig) -> Tuple[Tensor, Tensor]:
    """nenbody::disc_rows or nenbody::wireframe_rows by cfg.sprite_mode:
    (shade, depth) [..., N, W]."""
    op = (torch.ops.nenbody.wireframe_rows if cfg.sprite_mode == "wireframe"
          else torch.ops.nenbody.disc_rows)
    return op(pos, vel, cfg.width, cfg.hfov_deg, cfg.near, cfg.far, cfg.sprite_radius,
              cfg.background, cfg.sprite_albedo, cfg.antialias)
