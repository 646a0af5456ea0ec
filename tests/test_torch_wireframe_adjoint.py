"""The written-out reverse sweep of the wireframe pullback (the CPU model of
nenbody_tpu_torch/csrc/wireframe_eye_bwd.cu, ops/wireframe.py:
wireframe_view_cotangents and sprite_view_vjp) against autograd.

1. The view-space vert cotangents against torch.autograd.grad through
   _view_fragments with the verts (f, l) as leaves: float64 to rtol 1e-9
   (atol 1e-9 of the largest; the same function differentiated two ways,
   apart only by rounding), float32 at the backward kernels' rtol 2e-4,
   atol 2e-4 of the largest component.
2. The per-(env, eye, winner) sums pushed through sprite_view_vjp (the
   kernel's per-group transpose) against winner_pullback, same tolerances;
   in float64 plus 2^-20 of the float32 winner_pullback's distance from
   float64, which measures how ill-conditioned the inputs are: with an
   edge along a pixel's ray the two sides sum cancelling terms of up to
   1e5 times the result in another order, and float32 rounding alone moves
   the gradients by more than their size, so that case is held in float64
   only.
3. At one small shape, d pos and d vel against the JAX package's winner
   route (render_rows_wireframe_diff, its Pallas forward in interpret
   mode), as tests/test_torch_wireframe_grad.py holds the port's pullback:
   rtol 2e-4, atol 2e-4 of the largest component.

Cases: a spread swarm, a ring hop's block against another's (-1 pixels),
sprites straddling the near plane, sprites with an edge along a pixel's ray,
per-target albedo and a texture; and a sprite built in its eye's frame whose
two edges tie in depth at a shared vert, whose clamps tie at their bounds and
whose union span's ends tie between edges and with a pixel's footprint, so
that every rule the kernel mirrors is exercised: a tied min or max sends half
to each side, a clamp passes at its bounds, the edge merge keeps the lower
edge on a tie, tau is zeroed on a miss.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu.ops import wireframe as jwireframe

from nenbody_tpu_torch import VisionConfig
from nenbody_tpu_torch.ops import wireframe
from nenbody_tpu_torch.vision import camera, render

torch.set_num_threads(1)

W = 32
CASES = ["spread", "ring_hop", "near_plane", "edge_on", "albedo", "texture"]
TOL = {torch.float64: 1e-9, torch.float32: 2e-4}


def _cfg(aa, w=W, **kw):
    return VisionConfig(width=w, antialias=aa, sprite_mode="wireframe", far=200.0, **kw)


def _scene(case, seed=0):
    """(eye_pos, eye_dir [B, E, 2], tgt, hdg [B, M, 2], albedo [B, M] or
    None, texture or None) as numpy float32."""
    rng = np.random.RandomState(seed)
    albedo = texture = None
    if case in ("spread", "albedo", "texture", "ring_hop"):
        pos = rng.uniform(-20, 20, (3, 32, 2)).astype(np.float32)
        th = rng.uniform(-math.pi, math.pi, (3, 32))
        hdg = np.stack([np.cos(th), np.sin(th)], -1).astype(np.float32)
        if case == "ring_hop":  # eyes of one block against another's targets
            return pos[:, :16], hdg[:, :16], pos[:, 16:], hdg[:, 16:], None, None
        if case == "albedo":
            albedo = rng.uniform(0.3, 1.0, (3, 32)).astype(np.float32)
        if case == "texture":
            texture = (np.asarray(render.checker_texture(8, 2))
                       * rng.uniform(0.8, 1.0, (8, 8))).astype(np.float32)
            albedo = rng.uniform(0.3, 1.0, (3, 32)).astype(np.float32)
        return pos, hdg, pos, hdg, albedo, texture
    # sprites in each env's eye frame (t = tan 45 deg): straddling the near
    # plane, or with edge 0 ((2, 1) r in the sprite frame) along the ray of a
    # pixel centre, turned by less than 1e-6 rad
    b, m = 4, 24
    eye = rng.uniform(-50, 50, (b, 1, 2))
    phi0 = rng.uniform(-math.pi, math.pi, (b, 1))
    d = np.stack([np.cos(phi0), np.sin(phi0)], -1)
    right = np.stack([d[..., 1], -d[..., 0]], -1)
    if case == "near_plane":
        f = 1.0 + rng.uniform(-1.5, 1.5, (b, m))
        lat = rng.uniform(-1.5, 1.5, (b, m)) * np.maximum(f, 0.5)
        tgt = eye + f[..., None] * d + lat[..., None] * right
        th = rng.uniform(-math.pi, math.pi, (b, m))
        hdg = np.stack([np.cos(th), np.sin(th)], -1)
    else:
        f = rng.uniform(3, 40, (b, m))
        u = 2.0 * (rng.randint(0, W, (b, m)) + 0.5) / W - 1.0
        flip = (rng.uniform(size=(b, m)) < 0.5) * math.pi
        phi = np.arctan2(u, 1.0) + rng.uniform(-1e-6, 1e-6, (b, m)) + flip
        world = np.cos(phi)[..., None] * d + np.sin(phi)[..., None] * right
        theta = np.arctan2(world[..., 1], world[..., 0]) - math.atan2(1.0, 2.0)
        c, s = np.cos(theta), np.sin(theta)
        vert0 = eye + f[..., None] * d + (u * f)[..., None] * right
        tgt = vert0 - np.stack([-c + s, -s - c], -1)
        hdg = np.stack([c, s], -1)
    f32 = lambda x: np.ascontiguousarray(x, dtype=np.float32)
    return f32(eye), f32(d), f32(tgt), f32(hdg), None, None


def _winner(eye, d, tgt, hdg, cfg, albedo, texture):
    t = lambda x: None if x is None else torch.tensor(x)
    return wireframe.wireframe_eye_plain(t(eye), t(d), t(tgt), t(hdg), cfg, t(albedo),
                                         t(texture))[2].to(torch.int32)


def _pixel_views(eye, d, tgt, hdg, winner, albedo, dtype):
    """Each pixel's winner's verts in its eye's frame, as winner_pullback
    gathers them: (f, l, live, alb or None)."""
    e, w = winner.shape[-2:]
    j = torch.where(winner >= 0, winner, 0).long()
    g = lambda x: torch.gather(torch.tensor(x, dtype=dtype), 1,
                               j.reshape(len(x), -1, 1).expand(-1, -1, 2)).reshape(-1, e, w, 2)
    f, l, live = render.sprite_view(torch.tensor(eye, dtype=dtype)[..., None, :],
                                    torch.tensor(d, dtype=dtype)[..., None, :], g(tgt), g(hdg),
                                    _cfg(False))
    alb = None
    if albedo is not None:
        alb = torch.gather(torch.tensor(albedo, dtype=dtype), 1, j.reshape(len(albedo), -1))
        alb = alb.reshape(-1, e, w)
    return f, l, live, alb


def _cotangents(shape, seed, dtype):
    rng = np.random.RandomState(seed)
    return (torch.tensor(rng.randn(*shape), dtype=dtype),
            torch.tensor(1e-2 * rng.randn(*shape), dtype=dtype))


def _close(got, want, dtype, name):
    tol = TOL[dtype]
    assert torch.isfinite(got).all(), name
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale, msg=name)


def _hold_view_cotangents(f, l, live, u_p, us, ud, cfg, alb, texture, dtype):
    leaves = [x.detach().clone().requires_grad_() for x in f + l]
    extra = [x.detach().clone().requires_grad_() for x in (alb, texture) if x is not None]
    a = extra[0] if alb is not None else None
    tex = extra[-1] if texture is not None else None
    shade, depth, _ = wireframe._view_fragments(leaves[:3], leaves[3:], live, u_p, cfg, a, tex)
    want = torch.autograd.grad((shade * us).sum() + (depth * ud).sum(), leaves + extra,
                               allow_unused=True)
    gf, gl, g_alb, g_tex = wireframe.wireframe_view_cotangents(
        [x.detach() for x in f], [x.detach() for x in l], live, u_p, us, ud, cfg,
        None if alb is None else alb.detach(), None if texture is None else texture.detach())
    got = gf + gl + ([g_alb] if alb is not None else []) + ([g_tex] if texture is not None else [])
    names = ["f0", "f1", "f2", "l0", "l1", "l2", "albedo", "texture"]
    names = names[:6] + [n for n, x in zip(names[6:], (alb, texture)) if x is not None]
    assert sum(x.abs().max().item() for x in want[:6]) > 0
    for g, x, name in zip(got, want, names):
        _close(g, torch.zeros_like(g) if x is None else x, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_view_cotangents_match_autograd(case, aa, dtype):
    cfg = _cfg(aa)
    eye, d, tgt, hdg, albedo, texture = _scene(case)
    winner = _winner(eye, d, tgt, hdg, cfg, albedo, texture)
    assert (winner >= 0).any()
    if case == "ring_hop":
        assert (winner < 0).any()
    f, l, live, alb = _pixel_views(eye, d, tgt, hdg, winner, albedo, dtype)
    us, ud = _cotangents(winner.shape, 1, dtype)
    valid = winner >= 0
    us, ud = torch.where(valid, us, 0.0), torch.where(valid, ud, 0.0)
    tex = None if texture is None else torch.tensor(texture, dtype=dtype)
    u_p = camera.pixel_centers(cfg).to(dtype)
    _hold_view_cotangents(f, l, live, u_p, us, ud, cfg, alb, tex, dtype)


def _tied_sprite(dtype, cfg):
    """One sprite in its eye's frame over a 16-pixel row, verts (f, l) =
    (4, 0), (2, 2 u5 t), (4, -3 t) (u5 the centre of pixel 5): edges 0 and 1
    meet at vert 1 on pixel 5's ray at the same depth (the merge keeps edge
    0; their clamped taus sit at the bounds), the union span's ends tie
    between edges (u = -0.75 from edges 1 and 2, u = 0 from edges 2 and 0)
    and u = -0.75 is the edge of pixel 2's footprint."""
    t = camera.tan_half_fov(cfg)
    u_p = camera.pixel_centers(cfg).to(dtype)
    w = cfg.width
    f = [torch.full((w,), v, dtype=dtype) for v in (4.0, 2.0, 4.0)]
    l = [torch.zeros(w, dtype=dtype), (2 * (u_p[5] * t)).expand(w).clone(),
         (4 * (torch.tensor(-0.75, dtype=dtype) * t)).expand(w).clone()]
    return f, l, u_p


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("aa", [False, True])
def test_view_cotangents_at_ties(aa, dtype):
    cfg = _cfg(aa, w=16)
    f, l, u_p = _tied_sprite(dtype, cfg)
    live = torch.ones(16, dtype=torch.bool)
    edges = [wireframe._edge_primal(f[a], l[a], f[b], l[b], live, u_p, cfg)
             for a, b in render.SPRITE_EDGES]
    assert edges[0]["depth"][5] == edges[1]["depth"][5] < edges[2]["depth"][5]
    if aa:  # the ties the adjoint must split
        assert edges[0]["c3"][5] == edges[0]["tau_hi"][5]
        assert edges[1]["tau0"][5] == edges[1]["tau_lo"][5]
        assert edges[1]["hi"][0] < edges[0]["hi"][0] == edges[2]["hi"][0]
        assert edges[1]["lo"][0] == edges[2]["lo"][0] < edges[0]["lo"][0]
        assert edges[1]["lo"][0] == u_p[2] - 1.0 / 16
    us, ud = _cotangents((16,), 3, dtype)
    _hold_view_cotangents(f, l, live, u_p, us, ud, cfg, None, None, dtype)
    # the lower edge takes the tied pixel's depth: edge 0 is (vert 0, vert 1)
    gf, _, _, _ = wireframe.wireframe_view_cotangents(f, l, live, u_p, torch.zeros(16, dtype=dtype),
                                                      torch.eye(16, dtype=dtype)[5], cfg)
    assert gf[2][5] == 0.0 and gf[1][5] != 0.0


def test_view_cotangents_miss_gives_zero():
    """A pixel whose given winner misses it (a stale winner) has constant
    shade and depth: zero cotangents, finite (tau is zeroed on a miss)."""
    cfg = _cfg(True, w=16)
    f, l, u_p = _tied_sprite(torch.float32, cfg)
    live = torch.ones(16, dtype=torch.bool)
    off = u_p > 0.1  # the sprite spans u in [-0.75, 0]
    depth = wireframe._view_fragments(f, l, live, u_p, cfg)[1]
    assert off.any() and (depth[off] == cfg.far).all()  # misses: the far plane
    gf, gl, g_alb, _ = wireframe.wireframe_view_cotangents(
        f, l, live, u_p, torch.ones(16), torch.ones(16), cfg)
    for g in gf + gl + [g_alb]:
        assert torch.isfinite(g).all() and (g[off] == 0).all()


def test_sprite_view_vjp_is_the_transpose():
    dtype = torch.float64
    rng = np.random.RandomState(4)
    ins = [torch.tensor(rng.uniform(-5, 5, (6, 2)), dtype=dtype, requires_grad=True)
           for _ in range(4)]
    cfg = _cfg(False, sprite_radius=1.3)
    f, l, _ = render.sprite_view(*ins, cfg)
    gf = [torch.tensor(rng.randn(6), dtype=dtype) for _ in range(3)]
    gl = [torch.tensor(rng.randn(6), dtype=dtype) for _ in range(3)]
    want = torch.autograd.grad(sum((a * b).sum() for a, b in zip(f + l, gf + gl)), ins)
    got = wireframe.sprite_view_vjp(*[x.detach() for x in ins], gf, gl, cfg)
    for g, x in zip(got, want):
        _close(g, x, dtype, "sprite_view_vjp")


def _model_pullback(eye, d, tgt, hdg, winner, us, ud, cfg, albedo, texture, dtype):
    """The kernel's structure in plain PyTorch: per pixel the vert
    cotangents, summed per (env, eye, winner), pulled back once per group
    through sprite_view_vjp; the eye's shares summed over its winners, the
    target's over the eyes. Returns winner_pullback's outputs."""
    b, e, w = winner.shape
    m = tgt.shape[1]
    valid = winner >= 0
    us, ud = torch.where(valid, us, 0.0), torch.where(valid, ud, 0.0)
    f, l, live, alb = _pixel_views(eye, d, tgt, hdg, winner, albedo, dtype)
    tex = None if texture is None else torch.tensor(texture, dtype=dtype)
    gf, gl, g_alb, g_tex = wireframe.wireframe_view_cotangents(
        f, l, live, camera.pixel_centers(cfg).to(dtype), us, ud, cfg, alb, tex)
    j = torch.where(valid, winner, 0).long()
    group = (torch.arange(b * e).reshape(b, e, 1) * m + j).reshape(-1)

    def per_group(x):
        return torch.zeros(b * e * m, dtype=dtype).index_add_(0, group, x.reshape(-1)).reshape(
            b, e, m)

    t = lambda x: torch.tensor(x, dtype=dtype)
    g_eye, g_dir, g_tgt, g_hdg = wireframe.sprite_view_vjp(
        t(eye)[:, :, None], t(d)[:, :, None], t(tgt)[:, None], t(hdg)[:, None],
        [per_group(x) for x in gf], [per_group(x) for x in gl], cfg)
    grads = [g_eye.sum(2), g_dir.sum(2), g_tgt.sum(1), g_hdg.sum(1)]
    if albedo is not None:
        grads.append(per_group(g_alb).sum(1))
    if texture is not None:
        grads.append(g_tex)
    return grads


@pytest.mark.parametrize("case,dtype", [(c, dt) for c in CASES
                                        for dt in (torch.float64, torch.float32)
                                        if (c, dt) != ("edge_on", torch.float32)])
@pytest.mark.parametrize("aa", [False, True])
def test_group_sums_through_the_transpose_match_winner_pullback(case, aa, dtype):
    cfg = _cfg(aa)
    eye, d, tgt, hdg, albedo, texture = _scene(case, seed=1)
    winner = _winner(eye, d, tgt, hdg, cfg, albedo, texture)
    us, ud = _cotangents(winner.shape, 2, dtype)
    got = _model_pullback(eye, d, tgt, hdg, winner, us, ud, cfg, albedo, texture, dtype)

    def plain(dt):
        t = lambda x: None if x is None else torch.tensor(x, dtype=dt)
        return wireframe.winner_pullback(t(eye), t(d), t(tgt), t(hdg), winner, us.to(dt),
                                         ud.to(dt), cfg, t(albedo), t(texture))

    want = plain(dtype)
    noise = [0.0] * len(want)
    if dtype == torch.float64:
        noise = [(a.double() - x).abs().max().item() for a, x in zip(plain(torch.float32), want)]
    assert len(got) == len(want)
    for i, (g, x, n) in enumerate(zip(got, want, noise)):
        assert x.abs().max() > 0
        tol = TOL[dtype]
        torch.testing.assert_close(g, x, rtol=tol, atol=tol * x.abs().max().item() + 2 ** -20 * n,
                                   msg=f"output {i}")


@pytest.mark.parametrize("aa", [False, True])
def test_model_pullback_matches_jax_winner_route(aa):
    rng = np.random.RandomState(7)
    n, w = 24, 32
    pos = rng.uniform(-30, 30, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    cu = rng.randn(n, w).astype(np.float32)
    cd = (1e-2 * rng.randn(n, w)).astype(np.float32)
    cfg = _cfg(aa, w=w)
    jcfg = JVisionConfig(width=w, antialias=aa, sprite_mode="wireframe", far=200.0)

    def loss(p, v):
        s, dd = jwireframe.render_rows_wireframe_diff(p, v, jcfg)
        return jnp.sum(s * cu) + jnp.sum(dd * cd)

    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(pos),
                                                                 jnp.asarray(vel))]
    v = torch.tensor(vel, requires_grad=True)
    dirs = camera.unit_heading(v)
    hd = dirs.detach().numpy()[None]
    winner = _winner(pos[None], hd, pos[None], hd, cfg, None, None)
    g_eye, g_dir, g_tgt, g_hdg = _model_pullback(
        pos[None], hd, pos[None], hd, winner, torch.tensor(cu)[None], torch.tensor(cd)[None],
        cfg, None, None, torch.float32)
    # a self-render: the eyes and the sprites are the same agents
    (d_vel,) = torch.autograd.grad(dirs, v, (g_dir + g_hdg)[0])
    for g, x, name in zip((g_eye[0] + g_tgt[0], d_vel), want, ("pos", "vel")):
        assert np.abs(x).max() > 0
        np.testing.assert_allclose(g.numpy(), x, rtol=2e-4, atol=2e-4 * np.abs(x).max(),
                                   err_msg=name)
