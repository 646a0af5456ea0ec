"""1D pinhole camera math for agent eyes (counterpart of
nenbody_tpu/vision/camera.py).

For a 1-pixel-tall image the reference's 4x4 view-projection
(gfx.rs:358-369) collapses to 2D scalar geometry:

    forward  f = (x_j - x_i) . dir_i          (view-space depth)
    lateral  l = (x_j - x_i) . right_i
    u        = l / (f * tan(hfov/2))          (NDC in [-1, 1] across the line)

with dir_i the unit heading and right_i = (dir_y, -dir_x). An agent is
visible when near < f < far and its splat interval [u - du, u + du]
intersects [-1, 1], where du = sprite_radius / (f * tan(hfov/2)).

The products are written out component by component (rather than as a sum
over the last axis) so that the CUDA eye kernel, which computes the same
expressions, rounds the same way.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import VisionConfig


def unit_heading(vel: torch.Tensor) -> torch.Tensor:
    """Unit look direction from velocity, [..., 2].

    Uses atan2 like the reference's `rotation_of` (src/main.rs:141-143), so
    a zero velocity deterministically faces +x (atan2(0,0) = 0).
    """
    th = torch.atan2(vel[..., 1], vel[..., 0])
    return torch.stack([torch.cos(th), torch.sin(th)], dim=-1)


def tan_half_fov(cfg: VisionConfig) -> float:
    return math.tan(math.radians(cfg.hfov_deg) * 0.5)


def pixel_centers_for_width(w: int, device=None) -> torch.Tensor:
    """NDC u-coordinate of each pixel center for a w-pixel line, [w] in
    (-1, 1) — the one pixel convention shared by renderer and kernel."""
    return 2.0 * (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w - 1.0


def pixel_centers(cfg: VisionConfig, device=None) -> torch.Tensor:
    """NDC u-coordinate of each pixel center, [W] in (-1, 1)."""
    return pixel_centers_for_width(cfg.width, device)


def project(
    rel: torch.Tensor, direction: torch.Tensor, cfg: VisionConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project relative offsets into one agent's 1D camera.

    rel:       [..., M, 2] target positions relative to the eye
    direction: [..., 2] unit heading of the eye

    Returns (u_center, half_width, depth, visible), each [..., M]:
      u_center:   splat center in NDC
      half_width: projected sprite half-width in NDC
      depth:      view-space forward distance f
      visible:    near < f < far and splat overlaps the [-1, 1] frustum
    """
    dx = direction[..., None, 0]
    dy = direction[..., None, 1]
    rx, ry = rel[..., 0], rel[..., 1]
    f = rx * dx + ry * dy  # [..., M]
    l = rx * dy - ry * dx  # rel . right, right = (dy, -dx)
    t = tan_half_fov(cfg)
    in_depth = (f > cfg.near) & (f < cfg.far)
    # guard the division; masked-out lanes never contribute
    ft = torch.where(in_depth, f, torch.ones_like(f)) * t
    u = l / ft
    du = cfg.sprite_radius / ft
    visible = in_depth & (u.abs() <= 1.0 + du)
    return u, du, f, visible
