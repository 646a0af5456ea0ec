"""The exact wireframe eye on one hand-written CUDA kernel, and its
winner-index pullback (counterpart of nenbody_tpu/ops/wireframe.py).

The JAX package renders the reference's LineStrip-triangle sprite on four
Pallas kernels chosen by TPU routing rules: the division-route raster
kernel (`_wireframe_raster_kernel`) and its inverse-depth twin
(`_wireframe_rasterq_kernel`) over XLA-precomputed [N_e, N_t] vert tensors,
the streaming kernel that projects target chunks in-kernel
(`_wireframe_stream_kernel`, also the env-indexed batched grid), and the
compacted-candidate kernel for wide rows (`_wireframe_compact_kernel`). One
CUDA kernel, nenbody_tpu_torch/csrc/wireframe_eye.cu, replaces all four: it
projects in-kernel, takes any N, any width and a batch of envs, and follows
the plain renderer's division route (vision.render.eye_rows_wireframe) op
for op, its edge-major tie rule included. The routing predicates, the
precomputed layouts, the compact prologue and the TPU knobs have no
counterpart here.

Gradients (`RenderRowsWireframeDiff`) take the JAX package's default winner
route (WF_WINNER_BWD, wireframe.py:2734): the forward also returns each
pixel's winning target, and the backward re-evaluates only that sprite's
3 edges per pixel with the renderer's own expressions (so hit and coverage
decisions agree). On CUDA tensors that pullback is the hand-written kernel
nenbody_tpu_torch/csrc/wireframe_eye_bwd.cu, which replaces the Pallas
`_wf_bwd_kernel` (the ring's per-hop backward) and `_compact_bwd_kernel`
(its wide-row edition) and runs on one device as on every ring hop. Its
plain version, `winner_pullback`, pulls the cotangents back with autograd
and routes the target and heading shares by `index_add_`.

Per-agent albedo, textures and the raw winner mode are not ported yet
(ROADMAP queue 1 item 4).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import VisionConfig
from ..vision import camera, render
from .common import (
    KERNELS, check_batch, check_kernel_args, check_pullback_args, flat_batch, needs_grad,
    stream_handle, use_kernel,
)

# Pixels one chunk of the pullback re-evaluates: its autograd graph keeps
# about 200 float32 tensors of that size, about 6.4 GiB at 1 << 23 (the
# 4,096 x 256 x 64 trainers' batch runs in 8 chunks of 512 envs).
WF_PULL_PIXELS = 1 << 23


def wireframe_eye_plain(eye_pos, eye_dir, tgt, tgt_hdg, cfg: VisionConfig):
    """The kernel's plain version: the dense renderer, chunked over eyes.
    Returns (shade, depth, winner)."""
    return render.render_eyes_wireframe(eye_pos, eye_dir, tgt, tgt_hdg, cfg)


def _check_wireframe(cfg: VisionConfig) -> None:
    if cfg.sprite_mode != "wireframe":
        raise ValueError("the wireframe eye needs sprite_mode='wireframe'")


def _eye_args(cfg: VisionConfig):
    """The float and flag arguments of the kernel, in C order."""
    w = cfg.width
    return (camera.tan_half_fov(cfg), cfg.near, cfg.far, cfg.sprite_radius,
            1.0 / w, 2.0 / w, cfg.background, cfg.sprite_albedo, int(cfg.antialias))


def _check_eye_shapes(name, eye_pos, eye_dir, tgt, tgt_hdg):
    check_kernel_args(name, eye_pos, eye_dir, tgt, tgt_hdg)
    if (eye_pos.shape != eye_dir.shape or tgt.shape != tgt_hdg.shape
            or tgt.shape[:-2] != eye_pos.shape[:-2]):
        raise ValueError(
            f"{name}: eyes {tuple(eye_pos.shape)}/{tuple(eye_dir.shape)} and targets "
            f"{tuple(tgt.shape)}/{tuple(tgt_hdg.shape)} must share batch dims"
        )


def _wireframe_eye_cuda(eye_pos, eye_dir, tgt, tgt_hdg, cfg: VisionConfig,
                        with_winner: bool = False):
    """(shade, depth, winner) from the kernel; winner [..., N_e, W] int32 is
    None unless asked for."""
    _check_wireframe(cfg)
    _check_eye_shapes("wireframe_eye", eye_pos, eye_dir, tgt, tgt_hdg)
    ep, ed = flat_batch(eye_pos), flat_batch(eye_dir)
    tp, th = flat_batch(tgt), flat_batch(tgt_hdg)
    batch, ne, nt, w = ep.shape[0], ep.shape[1], tp.shape[1], cfg.width
    check_batch("wireframe_eye", batch)
    shape = eye_pos.shape[:-1] + (w,)
    shade = torch.empty(shape, dtype=torch.float32, device=eye_pos.device)
    depth = torch.empty(shape, dtype=torch.float32, device=eye_pos.device)
    winner = (torch.empty(shape, dtype=torch.int32, device=eye_pos.device)
              if with_winner else None)
    KERNELS["wireframe_eye"].launch(
        ep.data_ptr(), ed.data_ptr(), tp.data_ptr(), th.data_ptr(), shade.data_ptr(),
        depth.data_ptr(), None if winner is None else winner.data_ptr(),
        batch, ne, nt, w, *_eye_args(cfg), stream_handle(),
    )
    return shade, depth, winner


def wireframe_eye_with_winner(eye_pos, eye_dir, tgt, tgt_hdg, cfg: VisionConfig):
    """(shade, depth, winner [..., N_e, W] int32) from the kernel, CUDA
    tensors only: the forward as RenderRowsWireframeDiff runs it."""
    if not use_kernel(eye_pos, eye_dir, tgt, tgt_hdg):
        raise ValueError("wireframe_eye_with_winner: the winner index comes from the CUDA kernel")
    return _wireframe_eye_cuda(eye_pos, eye_dir, tgt, tgt_hdg, cfg, with_winner=True)


def wireframe_eye(
    eye_pos: torch.Tensor,
    eye_dir: torch.Tensor,
    tgt: torch.Tensor,
    tgt_hdg: torch.Tensor,
    cfg: VisionConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(shade, depth) [..., N_e, W] of eyes at eye_pos with unit headings
    eye_dir [..., N_e, 2] against sprites at tgt turned to tgt_hdg
    [..., N_t, 2]: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; through RenderRowsWireframeDiff when autograd needs it."""
    _check_wireframe(cfg)
    if needs_grad(eye_pos, eye_dir, tgt, tgt_hdg):
        return RenderRowsWireframeDiff.apply(eye_pos, eye_dir, tgt, tgt_hdg, cfg)
    if use_kernel(eye_pos, eye_dir, tgt, tgt_hdg):
        return _wireframe_eye_cuda(eye_pos, eye_dir, tgt, tgt_hdg, cfg)[:2]
    return wireframe_eye_plain(eye_pos, eye_dir, tgt, tgt_hdg, cfg)[:2]


def render_rows_wireframe_tiled(
    pos: torch.Tensor,
    vel: torch.Tensor,
    cfg: VisionConfig,
    targets: torch.Tensor | None = None,
    target_vel: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel counterpart of vision.render.render_rows with
    sprite_mode='wireframe', for one env or a batch: pos, vel [..., N, 2] ->
    (shade [..., N, W], depth [..., N, W]). The kernel takes the batch, so
    this one wrapper stands for both JAX launchers
    (render_rows_wireframe_tiled and render_rows_wireframe_batched).
    `targets`/`target_vel` [..., M, 2] render the eyes against another
    sprite set; partial rows depth-merge with vision.render.merge_rows.
    Differentiable (through RenderRowsWireframeDiff) when an input requires
    grad."""
    _check_wireframe(cfg)
    dirs = camera.unit_heading(vel)
    if targets is None:
        return wireframe_eye(pos, dirs, pos, dirs, cfg)
    if target_vel is None:
        raise ValueError("wireframe sprites need target_vel with targets")
    return wireframe_eye(pos, dirs, targets, camera.unit_heading(target_vel), cfg)


def render_rows_wireframe_diff(
    pos: torch.Tensor, vel: torch.Tensor, cfg: VisionConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """render_rows_wireframe_tiled through RenderRowsWireframeDiff, whatever
    grad mode says (counterpart of render_rows_wireframe_diff and
    render_rows_wireframe_batched_diff: pos, vel [..., N, 2]). Use
    cfg.antialias=True for useful gradients, as with the disc."""
    _check_wireframe(cfg)
    dirs = camera.unit_heading(vel)
    return RenderRowsWireframeDiff.apply(pos, dirs, pos, dirs, cfg)


def _winner_fragments(eye_pos, eye_dir, tgt, hdg, u_p, cfg: VisionConfig):
    """Each pixel's winning sprite re-evaluated (counterpart of
    _winner_fragment_rows, wireframe.py:2760): eye_pos, eye_dir [..., E, 2]
    against per-pixel targets tgt, hdg [..., E, W, 2]. The 3 edges merge by
    depth, a tie to the lower edge (_merge_edges, l.149), with the
    renderer's expressions. Returns (shade, depth) [..., E, W]."""
    f, l, live = render.sprite_view(eye_pos[..., None, :], eye_dir[..., None, :], tgt, hdg, cfg)
    d_m = s_m = sp_lo = sp_hi = None
    for (a, b), uv in zip(render.SPRITE_EDGES, render.EDGE_UV):
        d_e, tau, lo, hi = render.edge_fragment(f[a], l[a], f[b], l[b], live, u_p, cfg)
        s_e = render.fragment_shade(tau, uv, cfg)
        if d_m is None:
            d_m, s_m, sp_lo, sp_hi = d_e, s_e, lo, hi
            continue
        take = d_e < d_m
        d_m, s_m = torch.where(take, d_e, d_m), torch.where(take, s_e, s_m)
        if cfg.antialias:
            sp_lo, sp_hi = torch.minimum(sp_lo, lo), torch.maximum(sp_hi, hi)
    if cfg.antialias:
        s_m = cfg.background + render.coverage(sp_lo, sp_hi, u_p, cfg) * (s_m - cfg.background)
    hit = torch.isfinite(d_m)
    shade = torch.where(hit, s_m, cfg.background)
    depth = torch.where(hit, d_m, cfg.far)
    return shade, depth


def winner_pullback(
    eye_pos: torch.Tensor,
    eye_dir: torch.Tensor,
    tgt: torch.Tensor,
    tgt_hdg: torch.Tensor,
    winner: torch.Tensor,
    us: torch.Tensor,
    ud: torch.Tensor,
    cfg: VisionConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pullback of the wireframe eye through the forward's winner index
    (counterpart of _winner_pullback, wireframe.py:2816): cotangents
    (us, ud) [..., E, W] on (shade, depth) -> (d eye_pos, d eye_dir [..., E, 2],
    d tgt, d tgt_hdg [..., M, 2]).

    winner [..., E, W] is the forward's winning target (-1 at background
    pixels, whose cotangents are zeroed: shade and depth are constants
    there). Each pixel gathers its winner's position and heading,
    re-evaluates that one sprite with autograd, and the target and heading
    shares go back by index_add_. The batch runs in chunks of envs of at
    most WF_PULL_PIXELS pixels."""
    ep, ed = flat_batch(eye_pos), flat_batch(eye_dir)
    tp, th = flat_batch(tgt), flat_batch(tgt_hdg)
    batch, e, m, w = ep.shape[0], ep.shape[1], tp.shape[1], cfg.width
    win = winner.reshape(batch, e, w)
    us, ud = us.reshape(batch, e, w), ud.reshape(batch, e, w)
    u_p = camera.pixel_centers(cfg, device=ep.device)
    outs = [torch.zeros_like(x) for x in (ep, ed, tp, th)]
    chunk = max(1, WF_PULL_PIXELS // max(1, e * w))
    with torch.enable_grad():
        for b0 in range(0, batch, chunk):
            b1 = min(batch, b0 + chunk)
            valid = win[b0:b1] >= 0
            j = torch.where(valid, win[b0:b1], 0).long()  # [c, E, W]
            idx = j.reshape(b1 - b0, e * w, 1).expand(-1, -1, 2)
            leaves = [x[b0:b1].detach().requires_grad_() for x in (ep, ed)] + [
                torch.gather(x[b0:b1], 1, idx).reshape(b1 - b0, e, w, 2).requires_grad_()
                for x in (tp, th)]
            shade, depth = _winner_fragments(*leaves, u_p, cfg)
            loss = ((shade * torch.where(valid, us[b0:b1], 0.0)).sum()
                    + (depth * torch.where(valid, ud[b0:b1], 0.0)).sum())
            g_ep, g_ed, g_tp, g_th = torch.autograd.grad(loss, leaves)
            outs[0][b0:b1] = g_ep
            outs[1][b0:b1] = g_ed
            # target shares by winner index, envs offset into one flat axis
            flat = (j + m * torch.arange(b1 - b0, device=j.device)[:, None, None]).reshape(-1)
            for out, g in ((outs[2], g_tp), (outs[3], g_th)):
                out[b0:b1].view(-1, 2).index_add_(0, flat, g.reshape(-1, 2))
    return (outs[0].reshape(eye_pos.shape), outs[1].reshape(eye_dir.shape),
            outs[2].reshape(tgt.shape), outs[3].reshape(tgt_hdg.shape))


def _winner_pullback_cuda(eye_pos, eye_dir, tgt, tgt_hdg, winner, us, ud, cfg: VisionConfig):
    _check_eye_shapes("wireframe_eye_bwd", eye_pos, eye_dir, tgt, tgt_hdg)
    check_pullback_args("wireframe_eye_bwd", eye_pos.shape[:-1] + (cfg.width,), eye_pos.device,
                        winner, us, ud)
    ep, ed = flat_batch(eye_pos), flat_batch(eye_dir)
    tp, th = flat_batch(tgt), flat_batch(tgt_hdg)
    batch, ne, nt = ep.shape[0], ep.shape[1], tp.shape[1]
    check_batch("wireframe_eye_bwd", batch)
    grads = [torch.zeros_like(x) for x in (eye_pos, eye_dir, tgt, tgt_hdg)]
    KERNELS["wireframe_eye_bwd"].launch(
        ep.data_ptr(), ed.data_ptr(), tp.data_ptr(), th.data_ptr(), winner.data_ptr(),
        us.data_ptr(), ud.data_ptr(), *(g.data_ptr() for g in grads),
        batch, ne, nt, cfg.width, *_eye_args(cfg), stream_handle(),
    )
    return tuple(grads)


def wireframe_eye_vjp(eye_pos, eye_dir, tgt, tgt_hdg, winner, us, ud, cfg: VisionConfig):
    """Pullback of the wireframe eye through the forward's winner index:
    cotangents (us, ud) [..., E, W] -> (d eye_pos, d eye_dir [..., E, 2],
    d tgt, d tgt_hdg [..., M, 2]). The backward kernel for CUDA tensors,
    its plain version `winner_pullback` for CPU tensors."""
    if use_kernel(eye_pos, eye_dir, tgt, tgt_hdg, us, ud):
        return _winner_pullback_cuda(eye_pos, eye_dir, tgt, tgt_hdg, winner, us, ud, cfg)
    return winner_pullback(eye_pos, eye_dir, tgt, tgt_hdg, winner, us, ud, cfg)


class RenderRowsWireframeDiff(torch.autograd.Function):
    """(eye_pos, eye_dir, targets, target headings) -> (shade, depth) with
    the winner pullback as its backward (the winner route of
    render_rows_wireframe_diff and its batched form). On CUDA tensors the
    forward is the kernel with the winner index and the backward the
    backward kernel; on CPU tensors the plain renderer (which returns its
    winner) and `winner_pullback`. The headings are inputs, so autograd
    pulls them back through camera.unit_heading to the velocity; for a
    self-render the same tensors come in as eyes and targets, and autograd
    adds the two shares (the eyes look along, and the sprites turn to, the
    same heading)."""

    @staticmethod
    def forward(ctx, eye_pos, eye_dir, tgt, tgt_hdg, cfg: VisionConfig):
        ctx.cfg = cfg
        if use_kernel(eye_pos, eye_dir, tgt, tgt_hdg):
            shade, depth, winner = _wireframe_eye_cuda(
                eye_pos, eye_dir, tgt, tgt_hdg, cfg, with_winner=True)
        else:
            shade, depth, winner = wireframe_eye_plain(eye_pos, eye_dir, tgt, tgt_hdg, cfg)
        ctx.save_for_backward(eye_pos, eye_dir, tgt, tgt_hdg, winner)
        return shade, depth

    @staticmethod
    def backward(ctx, us, ud):
        eye_pos, eye_dir, tgt, tgt_hdg, winner = ctx.saved_tensors
        grads = wireframe_eye_vjp(eye_pos, eye_dir, tgt, tgt_hdg, winner, us.contiguous(),
                                  ud.contiguous(), ctx.cfg)
        return (*grads, None)
