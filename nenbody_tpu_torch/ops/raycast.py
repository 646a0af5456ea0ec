"""The disc eye on the hand-written CUDA kernel (counterpart of the disc
forward of nenbody_tpu/ops/raycast.py).

The JAX package carries the disc eye on two Pallas kernels, `_raster_kernel`
(over XLA-precomputed [N_e, N_t] projections) and `_raycast_kernel`
(projecting target chunks in-kernel), and picks one by a TPU routing rule
(lane packing and a VMEM budget). One CUDA kernel,
nenbody_tpu_torch/csrc/disc_eye.cu, replaces both: it projects in-kernel,
takes any width and any N, and follows the plain renderer's arithmetic
(vision.render.eye_rows), including its tie rule (lowest target index wins
an exact depth tie — stricter than the Pallas kernels, raycast.py:12-14).

Per-agent albedo, the texture's raw winner mode and the backward kernel are
not ported yet (ROADMAP queue 1 item 8, queue 2 kernel 10).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import VisionConfig
from ..vision import camera, render
from .common import (
    KERNELS, check_batch, check_kernel_args, flat_batch, stream_handle, use_kernel,
)

# The plain version: the dense renderer, chunked over eyes.
disc_eye_plain = render.render_eyes


def _disc_eye_cuda(eye_pos, eye_dir, tgt, cfg: VisionConfig):
    check_kernel_args("disc_eye", eye_pos, eye_dir, tgt)
    if eye_pos.shape != eye_dir.shape or tgt.shape[:-2] != eye_pos.shape[:-2]:
        raise ValueError(
            f"disc_eye: eyes {tuple(eye_pos.shape)}/{tuple(eye_dir.shape)} and "
            f"targets {tuple(tgt.shape)} must share batch dims"
        )
    ep, ed, tp = flat_batch(eye_pos), flat_batch(eye_dir), flat_batch(tgt)
    batch, ne, nt, w = ep.shape[0], ep.shape[1], tp.shape[1], cfg.width
    check_batch("disc_eye", batch)
    shape = eye_pos.shape[:-1] + (w,)
    shade = torch.empty(shape, dtype=torch.float32, device=eye_pos.device)
    depth = torch.empty(shape, dtype=torch.float32, device=eye_pos.device)
    KERNELS["disc_eye"].launch(
        ep.data_ptr(), ed.data_ptr(), tp.data_ptr(), shade.data_ptr(),
        depth.data_ptr(), batch, ne, nt, w,
        camera.tan_half_fov(cfg), cfg.near, cfg.far, cfg.sprite_radius,
        1.0 / w, 0.5 * w, cfg.background, cfg.sprite_albedo,
        int(cfg.antialias), stream_handle(),
    )
    return shade, depth


def disc_eye(
    eye_pos: torch.Tensor,
    eye_dir: torch.Tensor,
    tgt: torch.Tensor,
    cfg: VisionConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(shade, depth) [..., N_e, W] of eyes at eye_pos with unit headings
    eye_dir [..., N_e, 2] against targets [..., N_t, 2]: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if use_kernel(eye_pos, eye_dir, tgt):
        return _disc_eye_cuda(eye_pos, eye_dir, tgt, cfg)
    return disc_eye_plain(eye_pos, eye_dir, tgt, cfg)


def render_rows_tiled(
    pos: torch.Tensor,
    vel: torch.Tensor,
    cfg: VisionConfig,
    targets: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel counterpart of vision.render.render_rows.

    pos, vel: [..., N, 2] -> (shade [..., N, W], depth [..., N, W]).
    `targets` [..., M, 2] renders the eyes against another position set;
    partial rows depth-merge with vision.render.merge_rows.
    """
    render.check_disc(cfg)
    tgt = pos if targets is None else targets
    return disc_eye(pos, camera.unit_heading(vel), tgt, cfg)
