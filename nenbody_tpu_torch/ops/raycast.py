"""The disc eye and its pullback on hand-written CUDA kernels (counterpart
of the disc forward and the disc custom VJP of nenbody_tpu/ops/raycast.py).

The JAX package carries the disc eye on two Pallas kernels, `_raster_kernel`
(over XLA-precomputed [N_e, N_t] projections) and `_raycast_kernel`
(projecting target chunks in-kernel), and picks one by a TPU routing rule
(lane packing and a VMEM budget). One CUDA kernel,
nenbody_tpu_torch/csrc/disc_eye.cu, replaces both: it projects in-kernel,
takes any width and any N, and follows the plain renderer's arithmetic
(vision.render.eye_rows), including its tie rule (lowest target index wins
an exact depth tie — stricter than the Pallas kernels, raycast.py:12-14).

The pullback (the Pallas `_raycast_bwd_kernel`) is
nenbody_tpu_torch/csrc/disc_eye_bwd.cu, the backward of the autograd
Function `RenderRowsDiff`: when autograd needs the render, the forward
kernel also writes each pixel's winning target index, and the backward
kernel pulls the cotangents back through that one winner (the design is in
the kernel's header). `disc_eye` and `render_rows_tiled` route through the
Function when an input requires grad; the plain backward is autograd
through the plain renderer, chunk by chunk over eyes.

The kernel projects only the (eye, target) pairs that may be visible
(`disc_maybe_visible`, a frustum test without a divide), runs the exact
per-pixel test of each only on the pixels its widened footprint can reach
(`disc_pixel_ranges`), and keeps each pixel's least (depth, index) key.
Those two functions are the culls in plain PyTorch with the kernel's
float32 expressions (they must agree); the CPU tests prove them
conservative against the exact test.

Appearance: `albedo` (one per target) and `texture` ([Ht, Wt], shared by
every env) cover the Pallas kernels' `has_alb` and `raw` forms. The JAX
package's raw form writes the winner's signed offset, 1/du and albedo for
an XLA epilogue to sample the texture (raycast.py:382); disc_eye.cu reads
the winner's albedo and samples the texture in its own epilogue, so no raw
stream exists here. The JAX package has no gradient of a disc with albedo
or texture, and neither has the port: such a render raises when an input
requires grad.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import VisionConfig
from ..vision import camera, render
from .common import (
    KERNELS, appearance_args, check_batch, check_kernel_args, check_pullback_args, flat_batch,
    needs_grad, stream_handle, use_kernel,
)


# csrc/pair_math.cuh's pixel spans (both disc eyes' ranges) widen a
# footprint by an eighth of a pixel and by RANGE_SLACK of |u_c| + reach + 1:
# far above the roundings of the exact test, of the pixel centres and of the
# span's own arithmetic; its frustum test without a divide widens the
# frustum by FRUSTUM_SLACK of f t + r
RANGE_SLACK, FRUSTUM_SLACK = 2.0 ** -16, 2.0 ** -20


def disc_maybe_visible(eye_pos, eye_dir, tgt, cfg: VisionConfig) -> torch.Tensor:
    """[..., E, M] bool: csrc/pair_math.cuh's disc_may_be_visible (both disc
    eyes' frustum test), with the same float32 expressions (which must
    agree): near < f < far and |l| <= (f t + r)(1 + FRUSTUM_SLACK), with f
    and l as camera.project makes them. Every target camera.project calls
    visible passes it."""
    rel = tgt[..., None, :, :] - eye_pos[..., :, None, :]
    dx, dy = eye_dir[..., None, 0], eye_dir[..., None, 1]
    rx, ry = rel[..., 0], rel[..., 1]
    f = rx * dx + ry * dy
    l = rx * dy - ry * dx
    bound = (f * camera.tan_half_fov(cfg) + cfg.sprite_radius) * (1.0 + FRUSTUM_SLACK)
    return (f > cfg.near) & (f < cfg.far) & (l.abs() <= bound)


def pixel_span(u_c: torch.Tensor, reach: torch.Tensor, width: int):
    """(lo, hi, reach_plus): the pixels [lo, hi] (int64) of a `width`-pixel
    line whose centres may lie within `reach` of u_c, and the distance
    reach_plus from u_c within which such a centre lies: csrc/pair_math.cuh's
    pixel_span with the same float32 expressions, which must agree.
    reach_plus is reach plus RANGE_SLACK of |u_c| + reach + 1, and the span
    holds the centres within reach_plus + 0.25/W (an eighth of a pixel
    more)."""
    w = width
    inv_w = torch.tensor(1.0 / w, dtype=torch.float32, device=u_c.device)
    reach_plus = reach + (u_c.abs() + reach + 1.0) * RANGE_SLACK
    r = reach_plus + 0.25 * inv_w
    half_w = 0.5 * w
    lo = ((u_c - r + 1.0) * half_w - 0.5).clamp(min=-1.0).ceil().long().clamp(min=0)
    hi = ((u_c + r + 1.0) * half_w - 0.5).clamp(max=float(w)).floor().long().clamp(max=w - 1)
    return lo, hi, reach_plus


def disc_pixel_ranges(eye_pos, eye_dir, tgt, cfg: VisionConfig):
    """(lo, hi, reach_plus) [..., E, M]: the pixels [lo, hi] (int64) of eye
    e's line that csrc/disc_eye.cu tests target m on (lo > hi: none, an
    invisible target), and the distance from the footprint centre u_c
    within which it runs the exact test on a pixel centre: its
    disc_pixel_range, the pixel_span of a reach of thr du, with the same
    float32 expressions, which must agree. So that no pixel the exact test
    covers is left out, reach_plus exceeds thr du by RANGE_SLACK of |u_c| +
    thr du + 1, and the range holds the centres within reach_plus + 0.25/W."""
    rel = tgt[..., None, :, :] - eye_pos[..., :, None, :]
    u_c, du, _, visible = camera.project(rel, eye_dir, cfg)
    du = du.clamp(min=1e-30)
    inv_w = torch.tensor(1.0 / cfg.width, dtype=torch.float32, device=du.device)
    thr = 1.0 + inv_w / du if cfg.antialias else torch.ones_like(du)
    lo, hi, reach_plus = pixel_span(u_c, thr * du, cfg.width)
    return torch.where(visible, lo, 1), torch.where(visible, hi, 0), reach_plus


def disc_eye_plain(eye_pos, eye_dir, tgt, cfg: VisionConfig, albedo=None, texture=None):
    """The kernel's plain version: the dense renderer, chunked over eyes."""
    return render.render_eyes(eye_pos, eye_dir, tgt, cfg, albedo=albedo, texture=texture)


def _check_disc(cfg: VisionConfig) -> None:
    if cfg.sprite_mode != "disc":
        raise ValueError("the disc eye needs sprite_mode='disc'; wireframe sprites render "
                         "through ops.wireframe")


def _eye_args(cfg: VisionConfig):
    """The float and flag arguments both eye kernels take, in C order."""
    w = cfg.width
    return (camera.tan_half_fov(cfg), cfg.near, cfg.far, cfg.sprite_radius,
            1.0 / w, 0.5 * w, cfg.background, cfg.sprite_albedo, int(cfg.antialias))


def _check_eye_shapes(name, eye_pos, eye_dir, tgt):
    check_kernel_args(name, eye_pos, eye_dir, tgt)
    if eye_pos.shape != eye_dir.shape or tgt.shape[:-2] != eye_pos.shape[:-2]:
        raise ValueError(
            f"{name}: eyes {tuple(eye_pos.shape)}/{tuple(eye_dir.shape)} and "
            f"targets {tuple(tgt.shape)} must share batch dims"
        )


def _disc_eye_cuda(eye_pos, eye_dir, tgt, cfg: VisionConfig, with_winner: bool = False,
                   albedo=None, texture=None):
    """(shade, depth, winner) from the kernel; winner [..., N_e, W] int32 is
    None unless asked for."""
    _check_eye_shapes("disc_eye", eye_pos, eye_dir, tgt)
    skin = appearance_args("disc_eye", tgt, albedo, texture)
    ep, ed, tp = flat_batch(eye_pos), flat_batch(eye_dir), flat_batch(tgt)
    batch, ne, nt, w = ep.shape[0], ep.shape[1], tp.shape[1], cfg.width
    check_batch("disc_eye", batch)
    shape = eye_pos.shape[:-1] + (w,)
    shade = torch.empty(shape, dtype=torch.float32, device=eye_pos.device)
    depth = torch.empty(shape, dtype=torch.float32, device=eye_pos.device)
    winner = (torch.empty(shape, dtype=torch.int32, device=eye_pos.device)
              if with_winner else None)
    KERNELS["disc_eye"].launch(
        ep.data_ptr(), ed.data_ptr(), tp.data_ptr(), *skin[:2], shade.data_ptr(),
        depth.data_ptr(), None if winner is None else winner.data_ptr(),
        batch, ne, nt, w, *skin[2:], *_eye_args(cfg), stream_handle(),
    )
    return shade, depth, winner


def disc_eye_with_winner(eye_pos, eye_dir, tgt, cfg: VisionConfig):
    """(shade, depth, winner [..., N_e, W] int32) from the kernel, CUDA
    tensors only: the forward as RenderRowsDiff runs it, with the backward
    kernel's residual."""
    if not use_kernel(eye_pos, eye_dir, tgt):
        raise ValueError("disc_eye_with_winner: the winner index comes from the CUDA kernel")
    return _disc_eye_cuda(eye_pos, eye_dir, tgt, cfg, with_winner=True)


def disc_eye(
    eye_pos: torch.Tensor,
    eye_dir: torch.Tensor,
    tgt: torch.Tensor,
    cfg: VisionConfig,
    albedo: torch.Tensor | None = None,
    texture: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(shade, depth) [..., N_e, W] of eyes at eye_pos with unit headings
    eye_dir [..., N_e, 2] against targets [..., N_t, 2], with a per-target
    `albedo` [..., N_t] and a `texture` [Ht, Wt] if given: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors; through
    RenderRowsDiff when autograd needs the render (which raises with albedo
    or texture: the disc has no textured gradient, as in the JAX
    package)."""
    if needs_grad(eye_pos, eye_dir, tgt, albedo, texture):
        if albedo is not None or texture is not None:
            raise NotImplementedError(
                "the disc eye has no gradient with albedo or texture (nor has the JAX "
                "package); use sprite_mode='wireframe' for a textured gradient")
        return RenderRowsDiff.apply(eye_pos, eye_dir, tgt, cfg)
    if use_kernel(eye_pos, eye_dir, tgt, albedo, texture):
        return _disc_eye_cuda(eye_pos, eye_dir, tgt, cfg, albedo=albedo, texture=texture)[:2]
    return disc_eye_plain(eye_pos, eye_dir, tgt, cfg, albedo, texture)


def render_rows_tiled(
    pos: torch.Tensor,
    vel: torch.Tensor,
    cfg: VisionConfig,
    targets: torch.Tensor | None = None,
    albedo: torch.Tensor | None = None,
    texture: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel counterpart of vision.render.render_rows.

    pos, vel: [..., N, 2] -> (shade [..., N, W], depth [..., N, W]).
    `targets` [..., M, 2] renders the eyes against another position set;
    partial rows depth-merge with vision.render.merge_rows. `albedo`
    [..., M] and `texture` [Ht, Wt] as in disc_eye. Differentiable
    (through RenderRowsDiff) when an input requires grad, without albedo
    and texture.
    """
    _check_disc(cfg)
    tgt = pos if targets is None else targets
    return disc_eye(pos, camera.unit_heading(vel), tgt, cfg, albedo, texture)


def render_lines(state, cfg: VisionConfig) -> torch.Tensor:
    """`observe()` through the kernel route: [..., N, W] shade rows."""
    return render_rows_tiled(state.pos, state.vel, cfg)[0]


def render_lines_with_depth(state, cfg: VisionConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(shade, depth) [..., N, W] through the kernel route."""
    return render_rows_tiled(state.pos, state.vel, cfg)


def render_rows_vjp_cross_plain(
    pos: torch.Tensor,
    dirs: torch.Tensor,
    us: torch.Tensor,
    ud: torch.Tensor,
    cfg: VisionConfig,
    targets: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's plain PyTorch version: autograd through the
    plain renderer (vision.render.eye_rows), chunk by chunk over eyes so
    that each chunk's [..., chunk, M, W] tensors stay within
    PLAIN_PIXEL_BUDGET elements. Returns (d pos, d dirs, d targets)."""
    tgt = pos if targets is None else targets
    e, m = pos.shape[-2], tgt.shape[-2]
    batch = pos[..., 0, 0].numel()
    chunk = max(1, render.PLAIN_PIXEL_BUDGET // max(1, batch * m * cfg.width))
    deye, ddirs = [], []
    dtgt = torch.zeros_like(tgt)
    with torch.enable_grad():
        t = tgt.detach().requires_grad_()
        for i in range(0, e, chunk):
            p = pos[..., i:i + chunk, :].detach().requires_grad_()
            d = dirs[..., i:i + chunk, :].detach().requires_grad_()
            shade, depth = render.eye_rows(p, d, t, cfg)
            loss = ((shade * us[..., i:i + chunk, :]).sum()
                    + (depth * ud[..., i:i + chunk, :]).sum())
            gp, gd, gt = torch.autograd.grad(loss, (p, d, t), materialize_grads=True)
            deye.append(gp)
            ddirs.append(gd)
            dtgt += gt
    return torch.cat(deye, dim=-2), torch.cat(ddirs, dim=-2), dtgt


def _render_rows_vjp_cuda(pos, dirs, tgt, winner, us, ud, cfg: VisionConfig):
    _check_eye_shapes("disc_eye_bwd", pos, dirs, tgt)
    check_pullback_args("disc_eye_bwd", pos.shape[:-1] + (cfg.width,), pos.device, winner, us, ud)
    ep, ed, tp = flat_batch(pos), flat_batch(dirs), flat_batch(tgt)
    batch, ne, nt = ep.shape[0], ep.shape[1], tp.shape[1]
    check_batch("disc_eye_bwd", batch)
    g_eye, g_dir, g_tgt = torch.zeros_like(pos), torch.zeros_like(dirs), torch.zeros_like(tgt)
    KERNELS["disc_eye_bwd"].launch(
        ep.data_ptr(), ed.data_ptr(), tp.data_ptr(), winner.data_ptr(), us.data_ptr(),
        ud.data_ptr(), g_eye.data_ptr(), g_dir.data_ptr(), g_tgt.data_ptr(),
        batch, ne, nt, cfg.width, *_eye_args(cfg), stream_handle(),
    )
    return g_eye, g_dir, g_tgt


def render_rows_vjp_cross(
    pos: torch.Tensor,
    dirs: torch.Tensor,
    winner: torch.Tensor | None,
    us: torch.Tensor,
    ud: torch.Tensor,
    cfg: VisionConfig,
    targets: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pullback of the eye render: cotangents (us, ud) [..., N, W] on
    (shade, depth) -> (d eye-pos [..., N, 2], d dirs [..., N, 2],
    d targets [..., M, 2]). The CUDA kernel for CUDA tensors, which needs
    the winner index its forward wrote; the plain version (which ignores
    `winner`) for CPU tensors."""
    tgt = pos if targets is None else targets
    if use_kernel(pos, dirs, tgt, us, ud):
        return _render_rows_vjp_cuda(pos, dirs, tgt, winner, us, ud, cfg)
    return render_rows_vjp_cross_plain(pos, dirs, us, ud, cfg, tgt)


class RenderRowsDiff(torch.autograd.Function):
    """(eye_pos, dirs, targets) -> (shade, depth) with the backward kernel
    as its backward (raycast.py:840-863 of the JAX package). The heading
    `dirs` is an input, so autograd pulls d dirs back through
    camera.unit_heading to the velocity; when the targets are the eyes'
    own positions, the same tensor is passed twice and autograd adds the
    eye and target shares."""

    @staticmethod
    def forward(ctx, eye_pos, dirs, tgt, cfg: VisionConfig):
        ctx.cfg = cfg
        winner = None
        if use_kernel(eye_pos, dirs, tgt):
            shade, depth, winner = _disc_eye_cuda(
                eye_pos, dirs, tgt, cfg, with_winner=any(ctx.needs_input_grad))
        else:
            shade, depth = disc_eye_plain(eye_pos, dirs, tgt, cfg)
        ctx.save_for_backward(eye_pos, dirs, tgt, winner)
        return shade, depth

    @staticmethod
    def backward(ctx, us, ud):
        eye_pos, dirs, tgt, winner = ctx.saved_tensors
        deye, ddirs, dtgt = render_rows_vjp_cross(
            eye_pos, dirs, winner, us.contiguous(), ud.contiguous(), ctx.cfg, targets=tgt)
        return deye, ddirs, dtgt, None


def render_rows_diff(
    pos: torch.Tensor, vel: torch.Tensor, cfg: VisionConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """render_rows_tiled through RenderRowsDiff, whatever grad mode says:
    rollouts that look at the world differentiate through perception. Use
    cfg.antialias=True for useful gradients: binary coverage is piecewise
    constant in positions, the antialiased observation piecewise linear."""
    _check_disc(cfg)
    return RenderRowsDiff.apply(pos, camera.unit_heading(vel), pos, cfg)
