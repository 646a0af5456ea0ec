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
counterpart here. The kernel draws only the sprites that may be visible
(`wireframe_maybe_visible`, a frustum test of the sprite's bounding circle
without a divide), runs the exact per-pixel test of each edge only on the
pixels of its slab-clipped, widened u-interval (`wireframe_pixel_ranges`),
and keeps each pixel's least (depth, edge, target) key. Those two functions
are the culls in plain PyTorch with the kernel's float32 expressions (they
must agree); the CPU tests prove them conservative against the exact test.

Gradients (`RenderRowsWireframeDiff`) take the JAX package's default winner
route (WF_WINNER_BWD, wireframe.py:2734): the forward also returns each
pixel's winning target, and the backward re-evaluates only that sprite's
3 edges per pixel with the renderer's own expressions (so hit and coverage
decisions agree). On CUDA tensors that pullback is the hand-written kernel
nenbody_tpu_torch/csrc/wireframe_eye_bwd.cu, which replaces the Pallas
`_wf_bwd_kernel` (the ring's per-hop backward) and `_compact_bwd_kernel`
(its wide-row edition) and runs on one device as on every ring hop: a
written-out reverse sweep to the winning sprite's view-space verts per
pixel (`wireframe_view_cotangents` is its CPU model, line for line),
summed per run of pixels with one winner and pulled back through the
sprite's projection once per run (`sprite_view_vjp`). Its plain version,
`winner_pullback`, pulls the cotangents back with autograd and routes the
target and heading shares by `index_add_`.

Appearance: `albedo` (one per target) and `texture` ([Ht, Wt], shared by
every env) cover the Pallas kernels' `has_alb` and `raw` forms. The JAX raw
form writes the winner's edge uv (with its albedo and coverage) for an XLA
epilogue to sample (`_decode_textured_wf`, wireframe.py:260); the kernel
samples in its own epilogue instead. The gradient takes both as inputs
(`render_rows_wireframe_textured_diff`, `render_rows_wireframe_diff(albedo=,
texture=)`): the backward kernel and `winner_pullback` return d albedo,
routed to each pixel's winner, and d texture, summed over pixels and envs
(the JAX `_winner_pullback` with albedo and texture, and the albedo and
texture cotangents of `_compact_bwd_kernel`).
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

# csrc/wireframe_eye.cu's culls: the sprite's bounding circle (its verts lie
# within sqrt(2) r of its centre) widened by FRUSTUM_SLACK of the positions
# and of t (f + m); each edge's slab-clipped u-interval widened (beyond half
# a pixel with antialias) by RANGE_SLACK of (1 + |e_lo| + |e_hi|)(1 + (|df|
# + |dl|) / (t near)): far above every rounding of the exact test, of the
# slab clip and of the pixel centres
SPRITE_REACH = 1.4142137
FRUSTUM_SLACK, RANGE_SLACK = 2.0 ** -16, 2.0 ** -18

# Pixels one chunk of the pullback re-evaluates: its autograd graph keeps
# about 200 float32 tensors of that size, about 6.4 GiB at 1 << 23 (the
# 4,096 x 256 x 64 trainers' batch runs in 8 chunks of 512 envs).
WF_PULL_PIXELS = 1 << 23


def wireframe_eye_plain(eye_pos, eye_dir, tgt, tgt_hdg, cfg: VisionConfig, albedo=None,
                        texture=None):
    """The kernel's plain version: the dense renderer, chunked over eyes.
    Returns (shade, depth, winner)."""
    return render.render_eyes_wireframe(eye_pos, eye_dir, tgt, tgt_hdg, cfg, albedo=albedo,
                                        texture=texture)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def wireframe_maybe_visible(eye_pos, eye_dir, tgt, cfg: VisionConfig) -> torch.Tensor:
    """[..., E, M] bool: csrc/wireframe_eye.cu's wireframe_maybe_visible,
    with the same float32 expressions (which must agree). The sprite's
    bounding circle, radius m = r SPRITE_REACH widened by FRUSTUM_SLACK of
    the positions, meets the [near, far] slab (f + m > near, f - m < far)
    and the frustum, |l| <= t (f + m)(1 + FRUSTUM_SLACK) + m, with f and l
    the centre's as camera.project makes them; a target coincident with the
    eye never is. Every target eye_rows_wireframe lets win a pixel passes
    it."""
    xj, pe = tgt[..., None, :, :], eye_pos[..., :, None, :]
    rx, ry = xj[..., 0] - pe[..., 0], xj[..., 1] - pe[..., 1]
    dx, dy = eye_dir[..., :, None, 0], eye_dir[..., :, None, 1]
    f = rx * dx + ry * dy
    l = rx * dy - ry * dx
    r = _f32(cfg.sprite_radius, tgt)
    m = r * SPRITE_REACH + FRUSTUM_SLACK * (
        ((xj[..., 0].abs() + xj[..., 1].abs()) + (pe[..., 0].abs() + pe[..., 1].abs())) + r)
    live = (xj[..., 0] != pe[..., 0]) | (xj[..., 1] != pe[..., 1])
    bound = (f + m) * camera.tan_half_fov(cfg) * (1.0 + FRUSTUM_SLACK) + m
    return live & (f + m > cfg.near) & (f - m < cfg.far) & (l.abs() <= bound)


def _slab(fa, la, df, dl, live, near, far, t):
    """csrc/wireframe_common.cuh's slab_interval (render.edge_fragment's
    antialias prologue): (valid, e_lo, e_hi). csrc/wireframe_eye.cu's
    edge_slab gives the same bits with two divides where both ends of the
    edge lie strictly inside (near, far)."""
    big = df.abs() > 1e-30
    safe_df = torch.where(big, df, 1e-30)
    t_near = (near - fa) / safe_df
    t_far = (far - fa) / safe_df
    tau_lo = torch.where(big, torch.maximum(t_near.minimum(t_far), torch.zeros_like(df)), 0.0)
    tau_hi = torch.where(big, torch.minimum(t_near.maximum(t_far), torch.ones_like(df)), 1.0)
    valid = live & torch.where(big, tau_lo < tau_hi, (fa > near) & (fa < far))
    f_lo = torch.where(valid, fa + tau_lo * df, 1.0)
    f_hi = torch.where(valid, fa + tau_hi * df, 1.0)
    u_a = (la + tau_lo * dl) / (t * f_lo.clamp(min=1e-30))
    u_b = (la + tau_hi * dl) / (t * f_hi.clamp(min=1e-30))
    return valid, torch.minimum(u_a, u_b), torch.maximum(u_a, u_b)


def wireframe_pixel_ranges(eye_pos, eye_dir, tgt, tgt_hdg, cfg: VisionConfig):
    """(lo, hi) [..., E, M, 3] int64: the pixels [lo, hi] of eye e's line on
    which csrc/wireframe_eye.cu runs the exact test of edge k of target m
    (lo > hi: none), its edge_pixel_range with the same float32 expressions
    (which must agree). The edge's slab-clipped u-interval [e_lo, e_hi]
    widened by half a pixel with antialias (the coverage test's reach) and
    by RANGE_SLACK of (1 + |e_lo| + |e_hi|)(1 + (|df| + |dl|) / (t near)),
    so that no pixel the exact test hits is left out: a hit lies on the
    clipped segment up to the test's roundings (near and far are floats, so
    a depth that rounds inside the slab lies inside it up to the rounding
    of tau df), and the segment's projection is monotone in tau."""
    w = cfg.width
    f, l, live = render.sprite_view(eye_pos[..., :, None, :], eye_dir[..., :, None, :],
                                    tgt[..., None, :, :], tgt_hdg[..., None, :, :], cfg)
    t = camera.tan_half_fov(cfg)
    hp = _f32(1.0 / w, tgt)
    base = hp if cfg.antialias else _f32(0.0, tgt)
    inv_tnear = 1.0 / (_f32(t, tgt) * _f32(cfg.near, tgt))
    lows, highs = [], []
    for a, b in render.SPRITE_EDGES:
        fa, la = f[a], l[a]
        df, dl = f[b] - fa, l[b] - la
        valid, e_lo, e_hi = _slab(fa, la, df, dl, live, cfg.near, cfg.far, t)
        pad = base + RANGE_SLACK * ((1.0 + e_lo.abs()) + e_hi.abs()) * (
            1.0 + (df.abs() + dl.abs()) * inv_tnear)
        lo_f = (e_lo - pad + 1.0) * (0.5 * w) - 0.5
        hi_f = (e_hi + pad + 1.0) * (0.5 * w) - 0.5
        lo = lo_f.clamp(min=-1.0, max=float(w)).ceil().long().clamp(min=0)
        hi = hi_f.clamp(max=float(w)).clamp(min=-1.0).floor().long().clamp(max=w - 1)
        lows.append(torch.where(valid, lo, 1))
        highs.append(torch.where(valid, hi, 0))
    return torch.stack(lows, dim=-1), torch.stack(highs, dim=-1)


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
                        with_winner: bool = False, albedo=None, texture=None):
    """(shade, depth, winner) from the kernel; winner [..., N_e, W] int32 is
    None unless asked for."""
    _check_wireframe(cfg)
    _check_eye_shapes("wireframe_eye", eye_pos, eye_dir, tgt, tgt_hdg)
    skin = appearance_args("wireframe_eye", tgt, albedo, texture)
    ep, ed = flat_batch(eye_pos), flat_batch(eye_dir)
    tp, th = flat_batch(tgt), flat_batch(tgt_hdg)
    batch, ne, nt, w = ep.shape[0], ep.shape[1], tp.shape[1], cfg.width
    check_batch("wireframe_eye", batch)
    if 3 * nt >= 1 << 32:  # the kernel's keys hold k N_t + j (edge k, target j) in 32 bits
        raise ValueError(f"wireframe_eye: 3 N_t must be below 2^32, got N_t={nt}")
    shape = eye_pos.shape[:-1] + (w,)
    shade = torch.empty(shape, dtype=torch.float32, device=eye_pos.device)
    depth = torch.empty(shape, dtype=torch.float32, device=eye_pos.device)
    winner = (torch.empty(shape, dtype=torch.int32, device=eye_pos.device)
              if with_winner else None)
    KERNELS["wireframe_eye"].launch(
        ep.data_ptr(), ed.data_ptr(), tp.data_ptr(), th.data_ptr(), *skin[:2], shade.data_ptr(),
        depth.data_ptr(), None if winner is None else winner.data_ptr(),
        batch, ne, nt, w, *skin[2:], *_eye_args(cfg), stream_handle(),
    )
    return shade, depth, winner


def wireframe_eye_with_winner(eye_pos, eye_dir, tgt, tgt_hdg, cfg: VisionConfig, albedo=None,
                              texture=None):
    """(shade, depth, winner [..., N_e, W] int32) from the kernel, CUDA
    tensors only: the forward as RenderRowsWireframeDiff runs it."""
    if not use_kernel(eye_pos, eye_dir, tgt, tgt_hdg, albedo, texture):
        raise ValueError("wireframe_eye_with_winner: the winner index comes from the CUDA kernel")
    return _wireframe_eye_cuda(eye_pos, eye_dir, tgt, tgt_hdg, cfg, with_winner=True,
                               albedo=albedo, texture=texture)


def wireframe_eye(
    eye_pos: torch.Tensor,
    eye_dir: torch.Tensor,
    tgt: torch.Tensor,
    tgt_hdg: torch.Tensor,
    cfg: VisionConfig,
    albedo: torch.Tensor | None = None,
    texture: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(shade, depth) [..., N_e, W] of eyes at eye_pos with unit headings
    eye_dir [..., N_e, 2] against sprites at tgt turned to tgt_hdg
    [..., N_t, 2], with a per-target `albedo` [..., N_t] and a `texture`
    [Ht, Wt] if given: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors; through RenderRowsWireframeDiff when autograd needs
    it."""
    _check_wireframe(cfg)
    if needs_grad(eye_pos, eye_dir, tgt, tgt_hdg, albedo, texture):
        return RenderRowsWireframeDiff.apply(eye_pos, eye_dir, tgt, tgt_hdg, cfg, albedo,
                                             texture)
    if use_kernel(eye_pos, eye_dir, tgt, tgt_hdg, albedo, texture):
        return _wireframe_eye_cuda(eye_pos, eye_dir, tgt, tgt_hdg, cfg, albedo=albedo,
                                   texture=texture)[:2]
    return wireframe_eye_plain(eye_pos, eye_dir, tgt, tgt_hdg, cfg, albedo, texture)[:2]


def render_rows_wireframe_tiled(
    pos: torch.Tensor,
    vel: torch.Tensor,
    cfg: VisionConfig,
    targets: torch.Tensor | None = None,
    target_vel: torch.Tensor | None = None,
    albedo: torch.Tensor | None = None,
    texture: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel counterpart of vision.render.render_rows with
    sprite_mode='wireframe', for one env or a batch: pos, vel [..., N, 2] ->
    (shade [..., N, W], depth [..., N, W]). The kernel takes the batch, so
    this one wrapper stands for both JAX launchers
    (render_rows_wireframe_tiled and render_rows_wireframe_batched).
    `targets`/`target_vel` [..., M, 2] render the eyes against another
    sprite set; partial rows depth-merge with vision.render.merge_rows.
    `albedo` [..., M] and `texture` [Ht, Wt] as in wireframe_eye.
    Differentiable (through RenderRowsWireframeDiff) when an input requires
    grad."""
    _check_wireframe(cfg)
    dirs = camera.unit_heading(vel)
    if targets is None:
        return wireframe_eye(pos, dirs, pos, dirs, cfg, albedo, texture)
    if target_vel is None:
        raise ValueError("wireframe sprites need target_vel with targets")
    return wireframe_eye(pos, dirs, targets, camera.unit_heading(target_vel), cfg, albedo,
                         texture)


def render_lines(state, cfg: VisionConfig) -> torch.Tensor:
    """`observe()` through the wireframe kernel route: [..., N, W] shade rows."""
    return render_rows_wireframe_tiled(state.pos, state.vel, cfg)[0]


def render_lines_with_depth(state, cfg: VisionConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(shade, depth) [..., N, W] through the wireframe kernel route."""
    return render_rows_wireframe_tiled(state.pos, state.vel, cfg)


def render_rows_wireframe_diff(
    pos: torch.Tensor,
    vel: torch.Tensor,
    cfg: VisionConfig,
    albedo: torch.Tensor | None = None,
    texture: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """render_rows_wireframe_tiled through RenderRowsWireframeDiff, whatever
    grad mode says (counterpart of render_rows_wireframe_diff and
    render_rows_wireframe_batched_diff: pos, vel [..., N, 2], albedo
    [..., N], texture [Ht, Wt], whose gradient sums over the envs). Use
    cfg.antialias=True for useful gradients, as with the disc."""
    _check_wireframe(cfg)
    dirs = camera.unit_heading(vel)
    return RenderRowsWireframeDiff.apply(pos, dirs, pos, dirs, cfg, albedo, texture)


def render_rows_wireframe_textured_diff(
    pos: torch.Tensor,
    vel: torch.Tensor,
    cfg: VisionConfig,
    texture: torch.Tensor,
    albedo: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable texture-sampled sprite rows (counterpart of
    render_rows_wireframe_textured_diff, wireframe.py:2370): gradients flow
    to pos, vel, albedo and the texture itself."""
    return render_rows_wireframe_diff(pos, vel, cfg, albedo, texture)


def _winner_fragments(eye_pos, eye_dir, tgt, hdg, u_p, cfg: VisionConfig, alb=None,
                      texture=None):
    """Each pixel's winning sprite re-evaluated (counterpart of
    _winner_fragment_rows, wireframe.py:2760): eye_pos, eye_dir [..., E, 2]
    against per-pixel targets tgt, hdg [..., E, W, 2], with the winner's
    albedo alb [..., E, W] and the texture if given. The 3 edges merge by
    depth, a tie to the lower edge (_merge_edges, l.149), with the
    renderer's expressions; the winning edge's uv shades. Returns (shade,
    depth, uv) [..., E, W] (uv [..., E, W, 2], where the texture is
    sampled)."""
    f, l, live = render.sprite_view(eye_pos[..., None, :], eye_dir[..., None, :], tgt, hdg, cfg)
    return _view_fragments(f, l, live, u_p, cfg, alb, texture)


def _view_fragments(f, l, live, u_p, cfg: VisionConfig, alb=None, texture=None):
    """_winner_fragments from the sprite's view-space verts (f, l: lists of
    3 tensors [..., E, W]) on: the function whose reverse sweep
    wireframe_view_cotangents writes out."""
    d_m = tau_m = e_m = sp_lo = sp_hi = None
    for k, (a, b) in enumerate(render.SPRITE_EDGES):
        d_e, tau, lo, hi = render.edge_fragment(f[a], l[a], f[b], l[b], live, u_p, cfg)
        if d_m is None:
            d_m, tau_m, e_m, sp_lo, sp_hi = d_e, tau, torch.zeros_like(tau, dtype=torch.long), lo, hi
            continue
        take = d_e < d_m
        d_m, tau_m = torch.where(take, d_e, d_m), torch.where(take, tau, tau_m)
        e_m = torch.where(take, k, e_m)
        if cfg.antialias:
            sp_lo, sp_hi = torch.minimum(sp_lo, lo), torch.maximum(sp_hi, hi)
    hit = torch.isfinite(d_m)
    tau_m = torch.where(hit, tau_m, 0.0)  # a miss's tau may be huge; keep its uv tame
    uv_m = torch.tensor(render.EDGE_UV, dtype=tau_m.dtype, device=tau_m.device)[e_m].unbind(-1)
    s_m = render.fragment_shade(tau_m, uv_m, cfg, alb, texture)
    if cfg.antialias:
        s_m = cfg.background + render.coverage(sp_lo, sp_hi, u_p, cfg) * (s_m - cfg.background)
    shade = torch.where(hit, s_m, cfg.background)
    depth = torch.where(hit, d_m, cfg.far)
    uv_w = torch.stack([uv_m[0] + tau_m * uv_m[2], uv_m[1] + tau_m * uv_m[3]], dim=-1)
    return shade, depth, uv_w


# -- the reverse sweep of csrc/wireframe_eye_bwd.cu, in plain PyTorch ---------
# The kernel's adjoint is a transcription of the functions below, line for
# line; they run on no card path (the tests hold them against autograd
# through _view_fragments and against winner_pullback).

def _min_w(a, b):
    """autograd's share of d min(a, b) that goes to a: all of it where a is
    the smaller, half on a tie."""
    return torch.where(a < b, 1.0, torch.where(b < a, 0.0, 0.5)).to(a.dtype)


def _max_w(a, b):
    """autograd's share of d max(a, b) that goes to a (half on a tie)."""
    return torch.where(a > b, 1.0, torch.where(b > a, 0.0, 0.5)).to(a.dtype)


def _edge_primal(fa, la, fb, lb, live, u_p, cfg: VisionConfig):
    """render.edge_fragment's values with the intermediates its adjoint
    reads (a dict): the same expressions, so the same branches."""
    t = camera.tan_half_fov(cfg)
    df, dl = fb - fa, lb - la
    p = dict(fa=fa, la=la, df=df, dl=dl)
    if cfg.antialias:
        hp = 1.0 / cfg.width
        big = df.abs() > 1e-30
        safe = torch.where(big, df, 1e-30)
        t_near = (cfg.near - fa) / safe
        t_far = (cfg.far - fa) / safe
        mn, mx = t_near.minimum(t_far), t_near.maximum(t_far)
        tau_lo = torch.where(big, torch.maximum(mn, torch.zeros_like(df)), 0.0)
        tau_hi = torch.where(big, torch.minimum(mx, torch.ones_like(df)), 1.0)
        in_slab = (fa > cfg.near) & (fa < cfg.far)
        valid = live & torch.where(big, tau_lo < tau_hi, in_slab)
        f_lo = torch.where(valid, fa + tau_lo * df, 1.0)
        f_hi = torch.where(valid, fa + tau_hi * df, 1.0)
        d_a, d_b = t * f_lo.clamp(min=1e-30), t * f_hi.clamp(min=1e-30)
        u_a = (la + tau_lo * dl) / d_a
        u_b = (la + tau_hi * dl) / d_b
        e_lo, e_hi = torch.minimum(u_a, u_b), torch.maximum(u_a, u_b)
        c1 = torch.maximum(u_p, e_lo)
        utc = torch.minimum(c1, e_hi) * t
        num = utc * fa - la
        den = dl - utc * df
        ok = den.abs() > 1e-12
        tau0 = num / torch.where(ok, den, 1.0)
        c3 = torch.maximum(tau0, tau_lo)
        tau = torch.minimum(c3, tau_hi)
        fk = fa + tau * df
        cover = (e_hi > u_p - hp) & (e_lo < u_p + hp)
        hit = ok & valid & cover & (fk < cfg.far)
        p.update(big=big, safe=safe, t_near=t_near, t_far=t_far, mn=mn, mx=mx, tau_lo=tau_lo,
                 tau_hi=tau_hi, valid=valid, f_lo=f_lo, f_hi=f_hi, d_a=d_a, d_b=d_b, u_a=u_a,
                 u_b=u_b, e_lo=e_lo, e_hi=e_hi, c1=c1, utc=utc, den=den, ok=ok, tau0=tau0,
                 c3=c3, lo=torch.where(valid, e_lo, render.OFF_SCREEN),
                 hi=torch.where(valid, e_hi, -render.OFF_SCREEN))
    else:
        utc = u_p * t
        num = utc * fa - la
        den = dl - utc * df
        ok = den.abs() > 1e-12
        tau = num / torch.where(ok, den, 1.0)
        fk = fa + tau * df
        hit = ok & live & (tau >= 0.0) & (tau <= 1.0) & (fk > cfg.near) & (fk < cfg.far)
        p.update(utc=utc, den=den, ok=ok, tau0=tau)
    p.update(tau=tau, depth=torch.where(hit, fk, float("inf")))
    return p


def _edge_grad(g_fa, g_la, g_df, g_dl):
    """(d f_a, d l_a, d f_b, d l_b) from the cotangents of f_a, l_a and of
    the edge's differences df = f_b - f_a, dl = l_b - l_a."""
    return g_fa - g_df, g_la - g_dl, g_df, g_dl


def _winner_adjoint(p, g_tau, g_fk, u_p, cfg: VisionConfig):
    """The reverse sweep of the winning edge's fragment (_edge_primal's
    record `p`): the cotangents of its clamped tau and of its depth ->
    (its vert cotangents through the ray's hit, and with antialias `span`:
    what reaches its u-interval's ends and its clipped tau range, as a
    dict of e_lo, e_hi, tau_lo, tau_hi). Quotients are the primal's, times
    a reciprocal; ties and clamps follow autograd (half to each side of a
    tied min or max, a clamp passes at its bounds, a torch.where passes to
    the side it took)."""
    t = camera.tan_half_fov(cfg)
    fa, df, tau = p["fa"], p["df"], p["tau"]
    g_fa = g_fk
    g_df = g_fk * tau
    g_tau = g_tau + g_fk * df
    zero = torch.zeros_like(g_tau)
    span = dict(e_lo=zero, e_hi=zero, tau_lo=zero, tau_hi=zero)
    g_tau0 = g_tau
    if cfg.antialias:
        w = _min_w(p["c3"], p["tau_hi"])
        g_c3, span["tau_hi"] = g_tau * w, g_tau * (1.0 - w)
        w = _max_w(p["tau0"], p["tau_lo"])
        g_tau0, span["tau_lo"] = g_c3 * w, g_c3 * (1.0 - w)
    r = 1.0 / torch.where(p["ok"], p["den"], 1.0)
    g_num = g_tau0 * r
    g_den = torch.where(p["ok"], -(g_tau0 * p["tau0"]) * r, 0.0)
    if cfg.antialias:
        g_c2 = (g_num * fa - g_den * df) * t
        w = _min_w(p["c1"], p["e_hi"])
        span["e_hi"] = g_c2 * (1.0 - w)
        span["e_lo"] = g_c2 * w * _max_w(p["e_lo"], u_p)
    g_fa = g_fa + g_num * p["utc"]
    g_df = g_df - g_den * p["utc"]
    return _edge_grad(g_fa, -g_num, g_df, g_den), span


def _span_adjoint(p, span, cfg: VisionConfig):
    """The reverse sweep of an edge's u-interval and slab clip (with
    antialias): `span` (the cotangents of its u-interval's ends and of its
    clipped tau range) -> its vert cotangents. An invalid edge's interval is
    the off-screen sentinels: no cotangent."""
    t = camera.tan_half_fov(cfg)
    df, dl, valid = p["df"], p["dl"], p["valid"]
    g_fa = g_la = g_df = g_dl = torch.zeros_like(df)
    g_e_lo = torch.where(valid, span["e_lo"], 0.0)
    g_e_hi = torch.where(valid, span["e_hi"], 0.0)
    g_tau_lo = torch.where(valid, span["tau_lo"], 0.0)
    g_tau_hi = torch.where(valid, span["tau_hi"], 0.0)
    w_lo, w_hi = _min_w(p["u_a"], p["u_b"]), _max_w(p["u_a"], p["u_b"])
    g_u_a = g_e_lo * w_lo + g_e_hi * w_hi
    g_u_b = g_e_lo * (1.0 - w_lo) + g_e_hi * (1.0 - w_hi)
    for g_u, u, d, f_end, tau_end, side in ((g_u_a, p["u_a"], p["d_a"], p["f_lo"],
                                             p["tau_lo"], "lo"),
                                            (g_u_b, p["u_b"], p["d_b"], p["f_hi"],
                                             p["tau_hi"], "hi")):
        r = 1.0 / d
        g_n = g_u * r
        g_f = torch.where(valid & (f_end >= 1e-30), -(g_u * u) * r * t, 0.0)
        g_fa = g_fa + g_f
        g_df = g_df + g_f * tau_end
        g_la = g_la + g_n
        g_dl = g_dl + g_n * tau_end
        g_end = g_f * df + g_n * dl
        if side == "lo":
            g_tau_lo = g_tau_lo + g_end
        else:
            g_tau_hi = g_tau_hi + g_end
    big = p["big"]
    g_mn = torch.where(big, g_tau_lo * _max_w(p["mn"], torch.zeros_like(df)), 0.0)
    g_mx = torch.where(big, g_tau_hi * _min_w(p["mx"], torch.ones_like(df)), 0.0)
    w_n, w_x = _min_w(p["t_near"], p["t_far"]), _max_w(p["t_near"], p["t_far"])
    g_tn = g_mn * w_n + g_mx * w_x
    g_tf = g_mn * (1.0 - w_n) + g_mx * (1.0 - w_x)
    rs = 1.0 / p["safe"]
    g_fa = g_fa - (g_tn + g_tf) * rs
    g_df = g_df + torch.where(big, -(g_tn * p["t_near"] + g_tf * p["t_far"]) * rs, 0.0)
    return _edge_grad(g_fa, g_la, g_df, g_dl)


def wireframe_view_cotangents(f, l, live, u_p, us, ud, cfg: VisionConfig, alb=None,
                              texture=None):
    """The written-out reverse sweep of _view_fragments: cotangents (us, ud)
    [..., E, W] on each pixel's (shade, depth) -> (gf, gl, g_alb, g_tex):
    the cotangents of the winning sprite's view-space verts (lists of 3
    tensors [..., E, W]), each pixel's share of d albedo (of the scalar's
    when `alb` is None) and, with a texture, d texture [Ht, Wt] summed over
    pixels. The CPU model of csrc/wireframe_eye_bwd.cu's per-pixel adjoint;
    the caller masks the cotangents of background pixels. Only the winning
    edge reaches (shade, depth) through its tau and depth, and with
    antialias the edges that give the union span's ends through the
    coverage."""
    edges = [_edge_primal(f[a], l[a], f[b], l[b], live, u_p, cfg) for a, b in render.SPRITE_EDGES]
    d_m, tau_m = edges[0]["depth"], edges[0]["tau"]
    e_m = torch.zeros_like(d_m, dtype=torch.long)
    for k in (1, 2):
        take = edges[k]["depth"] < d_m
        d_m, tau_m = torch.where(take, edges[k]["depth"], d_m), torch.where(take, edges[k]["tau"],
                                                                             tau_m)
        e_m = torch.where(take, k, e_m)
    hit = torch.isfinite(d_m)
    cs, cd = torch.where(hit, us, 0.0), torch.where(hit, ud, 0.0)
    tau_m = torch.where(hit, tau_m, 0.0)
    uv = torch.tensor(render.EDGE_UV, dtype=tau_m.dtype, device=tau_m.device)[e_m].unbind(-1)
    uvx, uvy = uv[0] + tau_m * uv[2], uv[1] + tau_m * uv[3]
    base0 = cfg.sprite_albedo if alb is None else alb
    sample = 1.0
    if texture is not None:
        sample = render.sample_texture(texture, torch.stack([uvx, uvy], dim=-1))
    base = base0 * sample
    ux, uy = uvx - 0.5, uvy - 0.5
    vig = 1.0 - (ux * ux + uy * uy)
    if cfg.antialias:
        hp = 1.0 / cfg.width
        lo = [e["lo"] for e in edges]
        hi = [e["hi"] for e in edges]
        s_lo, s_hi = torch.minimum(lo[0], lo[1]), torch.maximum(hi[0], hi[1])
        a_lo, b_lo = _min_w(lo[0], lo[1]), _min_w(s_lo, lo[2])
        a_hi, b_hi = _max_w(hi[0], hi[1]), _max_w(s_hi, hi[2])
        sp_lo, sp_hi = torch.minimum(s_lo, lo[2]), torch.maximum(s_hi, hi[2])
        raw = (torch.minimum(sp_hi, u_p + hp) - torch.maximum(sp_lo, u_p - hp)) / (2.0 * hp)
        cov = raw.clamp(0.0, 1.0)
        g_s = cs * cov
        g_raw = torch.where((raw >= 0.0) & (raw <= 1.0), cs * (base * vig - cfg.background),
                            0.0) / (2.0 * hp)
        g_sp_hi = g_raw * _min_w(sp_hi, u_p + hp)
        g_sp_lo = -g_raw * _max_w(sp_lo, u_p - hp)
        g_lo = [g_sp_lo * b_lo * a_lo, g_sp_lo * b_lo * (1.0 - a_lo), g_sp_lo * (1.0 - b_lo)]
        g_hi = [g_sp_hi * b_hi * a_hi, g_sp_hi * b_hi * (1.0 - a_hi), g_sp_hi * (1.0 - b_hi)]
    else:
        g_s = cs
    g_vig = g_s * base
    g_base = g_s * vig
    g_uvx = -(g_vig * ux + g_vig * ux)
    g_uvy = -(g_vig * uy + g_vig * uy)
    g_alb = g_base * sample
    g_tex = None
    if texture is not None:
        ht, wt = texture.shape
        g_smp = g_base * base0
        x = uvx.clamp(0.0, 1.0) * (wt - 1)
        y = uvy.clamp(0.0, 1.0) * (ht - 1)
        x0, y0 = x.floor().long(), y.floor().long()
        x1, y1 = (x0 + 1).clamp(max=wt - 1), (y0 + 1).clamp(max=ht - 1)
        fx, fy = x - x0, y - y0
        flat = texture.reshape(-1)
        texel = lambda iy, ix: flat[iy * wt + ix]
        t00, t01, t10, t11 = texel(y0, x0), texel(y0, x1), texel(y1, x0), texel(y1, x1)
        g_fx = g_smp * ((t01 - t00) * (1.0 - fy) + (t11 - t10) * fy)
        g_fy = g_smp * ((t10 - t00) * (1.0 - fx) + (t11 - t01) * fx)
        g_uvx = g_uvx + torch.where((uvx >= 0.0) & (uvx <= 1.0), g_fx * (wt - 1), 0.0)
        g_uvy = g_uvy + torch.where((uvy >= 0.0) & (uvy <= 1.0), g_fy * (ht - 1), 0.0)
        g_tex = torch.zeros_like(flat)
        for iy, ix, wgt in ((y0, x0, (1.0 - fx) * (1.0 - fy)), (y0, x1, fx * (1.0 - fy)),
                            (y1, x0, (1.0 - fx) * fy), (y1, x1, fx * fy)):
            g_tex.index_add_(0, (iy * wt + ix).reshape(-1), (g_smp * wgt).reshape(-1))
        g_tex = g_tex.reshape(ht, wt)
    g_tau = g_uvx * uv[2] + g_uvy * uv[3]
    gf = [torch.zeros_like(cs) for _ in range(3)]
    gl = [torch.zeros_like(cs) for _ in range(3)]

    def add(k, g):
        a, b = render.SPRITE_EDGES[k]
        gf[a], gl[a] = gf[a] + g[0], gl[a] + g[1]
        gf[b], gl[b] = gf[b] + g[2], gl[b] + g[3]

    # the winning edge, by its tau and depth (the kernel picks it per pixel)
    spans = []
    for k in range(3):
        mine = e_m == k
        g, span = _winner_adjoint(edges[k], torch.where(mine, g_tau, 0.0),
                                  torch.where(mine, cd, 0.0), u_p, cfg)
        add(k, g)
        spans.append({key: torch.where(mine, v, 0.0) for key, v in span.items()})
    if cfg.antialias:
        # each edge's u-interval and slab clip: the winner's through its
        # clamps, those that give the union span's ends through the coverage
        for k in range(3):
            span = dict(spans[k], e_lo=spans[k]["e_lo"] + g_lo[k],
                        e_hi=spans[k]["e_hi"] + g_hi[k])
            add(k, _span_adjoint(edges[k], span, cfg))
    return gf, gl, g_alb, g_tex


def sprite_view_vjp(eye_pos, eye_dir, tgt, hdg, gf, gl, cfg: VisionConfig):
    """The transpose of render.sprite_view at (eye_pos, eye_dir, tgt, hdg)
    (broadcasting as there): the cotangents gf, gl (lists of 3) of the
    verts' (f, l) -> (d eye_pos, d eye_dir, d tgt, d hdg) of the broadcast
    shape [..., 2] (the caller sums over broadcast axes). The kernel applies
    it once per (eye, winner) group to the group's summed cotangents."""
    r = cfg.sprite_radius
    cth, sth = hdg[..., 0], hdg[..., 1]
    px, py = tgt[..., 0], tgt[..., 1]
    ex, ey = eye_pos[..., 0], eye_pos[..., 1]
    dx, dy = eye_dir[..., 0], eye_dir[..., 1]
    g_px = g_py = g_dx = g_dy = g_c = g_s = 0.0
    for (vx, vy), g_f, g_l in zip(render.SPRITE_VERTS, gf, gl):
        vxr, vyr = vx * r, vy * r
        relx = (px + (vxr * cth - vyr * sth)) - ex
        rely = (py + (vxr * sth + vyr * cth)) - ey
        g_rx = g_f * dx + g_l * dy
        g_ry = g_f * dy - g_l * dx
        g_dx = g_dx + (g_f * relx - g_l * rely)
        g_dy = g_dy + (g_f * rely + g_l * relx)
        g_px, g_py = g_px + g_rx, g_py + g_ry
        g_c = g_c + (g_rx * vxr + g_ry * vyr)
        g_s = g_s + (g_ry * vxr - g_rx * vyr)
    return (torch.stack([-g_px, -g_py], dim=-1), torch.stack([g_dx, g_dy], dim=-1),
            torch.stack([g_px, g_py], dim=-1), torch.stack([g_c, g_s], dim=-1))


def winner_pullback(
    eye_pos: torch.Tensor,
    eye_dir: torch.Tensor,
    tgt: torch.Tensor,
    tgt_hdg: torch.Tensor,
    winner: torch.Tensor,
    us: torch.Tensor,
    ud: torch.Tensor,
    cfg: VisionConfig,
    albedo: torch.Tensor | None = None,
    texture: torch.Tensor | None = None,
    appearance_grads: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """Pullback of the wireframe eye through the forward's winner index
    (counterpart of _winner_pullback, wireframe.py:2816): cotangents
    (us, ud) [..., E, W] on (shade, depth) -> (d eye_pos, d eye_dir [..., E, 2],
    d tgt, d tgt_hdg [..., M, 2][, d albedo [..., M]][, d texture [Ht, Wt]]),
    the last two for the forward's albedo and texture, when given (and
    `appearance_grads`).

    winner [..., E, W] is the forward's winning target (-1 at background
    pixels, whose cotangents are zeroed: shade and depth are constants
    there). Each pixel gathers its winner's position, heading and albedo,
    re-evaluates that one sprite with autograd, and the target, heading and
    albedo shares go back by index_add_; the texture's share sums over
    every pixel of every env. The batch runs in chunks of envs of at most
    WF_PULL_PIXELS pixels."""
    ep, ed = flat_batch(eye_pos), flat_batch(eye_dir)
    tp, th = flat_batch(tgt), flat_batch(tgt_hdg)
    batch, e, m, w = ep.shape[0], ep.shape[1], tp.shape[1], cfg.width
    ab = None if albedo is None else albedo.reshape(batch, m)
    win = winner.reshape(batch, e, w)
    us, ud = us.reshape(batch, e, w), ud.reshape(batch, e, w)
    u_p = camera.pixel_centers(cfg, device=ep.device)
    outs = [torch.zeros_like(x) for x in (ep, ed, tp, th)]
    d_alb = None if ab is None or not appearance_grads else torch.zeros_like(ab)
    d_tex = None if texture is None or not appearance_grads else torch.zeros_like(texture)
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
            alb = None if ab is None else torch.gather(
                ab[b0:b1].detach(), 1, j.reshape(b1 - b0, e * w)).reshape(b1 - b0, e, w)
            tex = None if texture is None else texture.detach()
            extra = [x.requires_grad_() for x, d in ((alb, d_alb), (tex, d_tex)) if d is not None]
            shade, depth, _ = _winner_fragments(*leaves, u_p, cfg, alb, tex)
            loss = ((shade * torch.where(valid, us[b0:b1], 0.0)).sum()
                    + (depth * torch.where(valid, ud[b0:b1], 0.0)).sum())
            g_ep, g_ed, g_tp, g_th, *g_extra = torch.autograd.grad(loss, leaves + extra)
            outs[0][b0:b1] = g_ep
            outs[1][b0:b1] = g_ed
            # target shares by winner index, envs offset into one flat axis
            flat = (j + m * torch.arange(b1 - b0, device=j.device)[:, None, None]).reshape(-1)
            for out, g in ((outs[2], g_tp), (outs[3], g_th)):
                out[b0:b1].view(-1, 2).index_add_(0, flat, g.reshape(-1, 2))
            if d_alb is not None:
                d_alb[b0:b1].view(-1).index_add_(0, flat, g_extra.pop(0).reshape(-1))
            if d_tex is not None:
                d_tex += g_extra.pop(0)
    grads = (outs[0].reshape(eye_pos.shape), outs[1].reshape(eye_dir.shape),
             outs[2].reshape(tgt.shape), outs[3].reshape(tgt_hdg.shape))
    if d_alb is not None:
        grads += (d_alb.reshape(albedo.shape),)
    return grads if d_tex is None else grads + (d_tex,)


def _winner_pullback_cuda(eye_pos, eye_dir, tgt, tgt_hdg, winner, us, ud, cfg: VisionConfig,
                          albedo=None, texture=None, appearance_grads: bool = True):
    _check_eye_shapes("wireframe_eye_bwd", eye_pos, eye_dir, tgt, tgt_hdg)
    check_pullback_args("wireframe_eye_bwd", eye_pos.shape[:-1] + (cfg.width,), eye_pos.device,
                        winner, us, ud)
    skin = appearance_args("wireframe_eye_bwd", tgt, albedo, texture)
    ep, ed = flat_batch(eye_pos), flat_batch(eye_dir)
    tp, th = flat_batch(tgt), flat_batch(tgt_hdg)
    batch, ne, nt = ep.shape[0], ep.shape[1], tp.shape[1]
    check_batch("wireframe_eye_bwd", batch)
    grads = [torch.zeros_like(x) for x in (eye_pos, eye_dir, tgt, tgt_hdg)]
    extra = [torch.zeros_like(x) for x in (albedo, texture)
             if x is not None and appearance_grads]
    g_alb = extra[0] if albedo is not None and appearance_grads else None
    g_tex = extra[-1] if texture is not None and appearance_grads else None
    KERNELS["wireframe_eye_bwd"].launch(
        ep.data_ptr(), ed.data_ptr(), tp.data_ptr(), th.data_ptr(), *skin[:2], winner.data_ptr(),
        us.data_ptr(), ud.data_ptr(), *(g.data_ptr() for g in grads),
        None if g_alb is None else g_alb.data_ptr(), None if g_tex is None else g_tex.data_ptr(),
        batch, ne, nt, cfg.width, *skin[2:], *_eye_args(cfg), stream_handle(),
    )
    return tuple(grads + extra)


def wireframe_eye_vjp(eye_pos, eye_dir, tgt, tgt_hdg, winner, us, ud, cfg: VisionConfig,
                      albedo=None, texture=None, appearance_grads: bool = True):
    """Pullback of the wireframe eye through the forward's winner index:
    cotangents (us, ud) [..., E, W] -> (d eye_pos, d eye_dir [..., E, 2],
    d tgt, d tgt_hdg [..., M, 2][, d albedo [..., M]][, d texture]) as
    winner_pullback returns them. The backward kernel for CUDA tensors (a
    float primal and the reverse sweep of wireframe_view_cotangents per
    pixel, sprite_view_vjp once per run of pixels with one winner), its
    plain version `winner_pullback` for CPU tensors."""
    args = (eye_pos, eye_dir, tgt, tgt_hdg, winner, us, ud, cfg, albedo, texture,
            appearance_grads)
    if use_kernel(eye_pos, eye_dir, tgt, tgt_hdg, us, ud, albedo, texture):
        return _winner_pullback_cuda(*args)
    return winner_pullback(*args)


class RenderRowsWireframeDiff(torch.autograd.Function):
    """(eye_pos, eye_dir, targets, target headings, cfg[, albedo][, texture])
    -> (shade, depth) with the winner pullback as its backward (the winner
    route of render_rows_wireframe_diff, its batched form and the textured
    diff). On CUDA tensors the forward is the kernel with the winner index
    and the backward the backward kernel (the written-out reverse sweep,
    wireframe_eye_vjp); on CPU tensors the plain renderer (which returns
    its winner) and `winner_pullback`. The headings are
    inputs, so autograd pulls them back through camera.unit_heading to the
    velocity; for a self-render the same tensors come in as eyes and
    targets, and autograd adds the two shares (the eyes look along, and the
    sprites turn to, the same heading). The albedo [..., M] and the texture
    [Ht, Wt] get their gradients too."""

    @staticmethod
    def forward(ctx, eye_pos, eye_dir, tgt, tgt_hdg, cfg: VisionConfig, albedo=None,
                texture=None):
        ctx.cfg = cfg
        if use_kernel(eye_pos, eye_dir, tgt, tgt_hdg, albedo, texture):
            shade, depth, winner = _wireframe_eye_cuda(
                eye_pos, eye_dir, tgt, tgt_hdg, cfg, with_winner=True, albedo=albedo,
                texture=texture)
        else:
            shade, depth, winner = wireframe_eye_plain(eye_pos, eye_dir, tgt, tgt_hdg, cfg,
                                                       albedo, texture)
        ctx.save_for_backward(eye_pos, eye_dir, tgt, tgt_hdg, winner, albedo, texture)
        return shade, depth

    @staticmethod
    def backward(ctx, us, ud):
        eye_pos, eye_dir, tgt, tgt_hdg, winner, albedo, texture = ctx.saved_tensors
        want = (tuple(ctx.needs_input_grad[5:]) + (False, False))[:2]
        grads = list(wireframe_eye_vjp(eye_pos, eye_dir, tgt, tgt_hdg, winner, us.contiguous(),
                                       ud.contiguous(), ctx.cfg, albedo, texture,
                                       appearance_grads=any(want)))
        d_alb = grads.pop(4) if albedo is not None and any(want) else None
        d_tex = grads.pop(4) if texture is not None and any(want) else None
        return (*grads, None, d_alb if want[0] else None, d_tex if want[1] else None)
