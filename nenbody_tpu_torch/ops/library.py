"""The serving paths' forward kernels as torch.library custom ops, so that
torch.export can trace a step that launches them (utils/export.py): it
cannot trace through the ctypes launches of the kernels' wrappers.

    nenbody::gravity_forces        pairwise.gravity_forces_tiled
    nenbody::gravity_forces_cross  pairwise.gravity_forces_tiled(pos_j=)
    nenbody::boids_velocity        boids.boids_velocity_tiled
    nenbody::disc_rows             raycast.render_rows_tiled
    nenbody::wireframe_rows        wireframe.render_rows_wireframe_tiled
    nenbody::disc_eye              raycast.disc_eye (eyes against targets)
    nenbody::wireframe_eye         wireframe.wireframe_eye (the same)
    nenbody::to_device             parallel.mesh.send's peer copy

The cross form, the two eyes against `targets` and the copy are the ring's
hops under torch.export (parallel/ring.py, parallel/mesh.py's send), so
that the fleet step over a mesh traces into one program; a hop's depth
merge (render.merge_rows) is a torch.where and needs no op. Each op runs on its inputs' device (the copy
on its source's stream, ordered as send orders it).

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

import contextlib
from typing import Tuple

import torch
from torch import Tensor

from ..config import BoidsConfig, GravityConfig, VisionConfig
from . import boids, pairwise, raycast, wireframe


def _on(x: Tensor):
    """The kernels launch on the current device: make it x's."""
    return torch.cuda.device(x.device) if x.is_cuda else contextlib.nullcontext()


@torch.library.custom_op("nenbody::gravity_forces", mutates_args=())
def _gravity_forces(pos: Tensor, g: float, bias: float, approx_reciprocal: bool) -> Tensor:
    cfg = GravityConfig(g=g, bias=bias, approx_reciprocal=approx_reciprocal)
    with _on(pos):
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


@torch.library.custom_op("nenbody::gravity_forces_cross", mutates_args=())
def _gravity_forces_cross(pos: Tensor, pos_j: Tensor, g: float, bias: float,
                          approx_reciprocal: bool) -> Tensor:
    cfg = GravityConfig(g=g, bias=bias, approx_reciprocal=approx_reciprocal)
    with _on(pos):
        return pairwise.gravity_forces_tiled(pos.contiguous(), cfg, pos_j=pos_j.contiguous())


@_gravity_forces_cross.register_fake
def _(pos, pos_j, g, bias, approx_reciprocal):
    return torch.empty_like(pos)


@torch.library.custom_op("nenbody::to_device", mutates_args=())
def _to_device(x: Tensor, *, device: torch.device) -> Tensor:
    if x.device == device:
        return x.clone()
    if x.is_cuda and device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(x.device))
        torch.cuda.current_stream(device).wait_event(ready)
    return x.to(device, non_blocking=True)


@_to_device.register_fake
def _(x, *, device):
    return torch.empty_like(x, device=device)


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


def _eye_against_op(name: str, sprite_mode: str, render):
    """The eyes at eye_pos, eye_dir against a target set: `hdg` (the
    targets' unit headings) is read by the wireframe sprite only."""
    @torch.library.custom_op(f"nenbody::{name}", mutates_args=())
    def op(eye_pos: Tensor, eye_dir: Tensor, tgt: Tensor, hdg: Tensor, width: int,
           hfov_deg: float, near: float, far: float, sprite_radius: float, background: float,
           sprite_albedo: float, antialias: bool) -> Tuple[Tensor, Tensor]:
        cfg = VisionConfig(width=width, hfov_deg=hfov_deg, near=near, far=far,
                           sprite_radius=sprite_radius, background=background,
                           sprite_albedo=sprite_albedo, antialias=antialias,
                           sprite_mode=sprite_mode)
        with _on(eye_pos):
            return render(eye_pos.contiguous(), eye_dir.contiguous(), tgt.contiguous(),
                          hdg.contiguous(), cfg)

    @op.register_fake
    def _(eye_pos, eye_dir, tgt, hdg, width, *scalars):
        shape = (*eye_pos.shape[:-1], width)
        return eye_pos.new_empty(shape), eye_pos.new_empty(shape)

    return op


_disc_rows = _eye_op("disc_rows", "disc", raycast.render_rows_tiled)
_disc_eye = _eye_against_op("disc_eye", "disc",
                            lambda p, d, t, h, cfg: raycast.disc_eye(p, d, t, cfg))
_wireframe_eye = _eye_against_op("wireframe_eye", "wireframe", wireframe.wireframe_eye)
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


def gravity_forces_cross(pos: Tensor, pos_j: Tensor, cfg: GravityConfig) -> Tensor:
    """nenbody::gravity_forces_cross: forces on pos [..., N, 2] from pos_j
    [..., M, 2]."""
    return torch.ops.nenbody.gravity_forces_cross(pos, pos_j, cfg.g, cfg.bias,
                                                  cfg.approx_reciprocal)


def eye_against(eye_pos: Tensor, eye_dir: Tensor, tgt: Tensor, tgt_hdg: Tensor,
                cfg: VisionConfig) -> Tuple[Tensor, Tensor]:
    """nenbody::disc_eye or nenbody::wireframe_eye by cfg.sprite_mode:
    (shade, depth) [..., N_e, W] of the eyes against targets tgt [...,
    N_t, 2] (turned to tgt_hdg, which the disc ignores)."""
    op = (torch.ops.nenbody.wireframe_eye if cfg.sprite_mode == "wireframe"
          else torch.ops.nenbody.disc_eye)
    return op(eye_pos, eye_dir, tgt, tgt_hdg, cfg.width, cfg.hfov_deg, cfg.near, cfg.far,
              cfg.sprite_radius, cfg.background, cfg.sprite_albedo, cfg.antialias)


def to_device(x: Tensor, device: torch.device) -> Tensor:
    """nenbody::to_device: `x` on `device`, `x` itself where it is there
    already (decided while tracing: the mesh's devices are fixed)."""
    if x.device == device:
        return x
    return torch.ops.nenbody.to_device(x, device=device)
