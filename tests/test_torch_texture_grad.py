"""Gradients of the port's textured wireframe eye (RenderRowsWireframeDiff
with albedo and texture as inputs: the forward with each pixel's winner, the
winner pullback as its backward) against the JAX package's
render_rows_wireframe_textured_diff and render_rows_wireframe_batched_diff
(albedo=, texture=), their Pallas forwards in interpret mode, and against
autograd through the port's plain renderer.

Tolerances: rtol 2e-4 and atol 2e-4 of the largest component, as
tests/test_torch_wireframe_grad.py holds the untextured gradients. One
allowance: the JAX pullback samples a small texture through
sample_texture_mm, whose derivative in uv is 0 where uv (size - 1) is an
integer, where the port's gather has the texel difference. At pixels whose
winning uv lies within 1e-5 of such a point inside (0, 1) the cotangents
are set to 0 for both sides (a uv of exactly 0 or 1 has zero slope in both:
it is constant along the edge, or a clamped endpoint).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu.ops import wireframe as jwireframe
from nenbody_tpu.vision import render as jrender

from nenbody_tpu_torch import VisionConfig
from nenbody_tpu_torch.ops import common, wireframe
from nenbody_tpu_torch.parallel import make_mesh, ring
from nenbody_tpu_torch.vision import camera, render

torch.set_num_threads(1)

FAR = 200.0
KINK = 1e-5


def _cfgs(w, aa):
    kw = dict(width=w, antialias=aa, sprite_mode="wireframe", far=FAR)
    return VisionConfig(**kw), JVisionConfig(**kw)


def _inputs(n, w, seed, batch=()):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-30, 30, batch + (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, batch + (n, 2)).astype(np.float32)
    albedo = rng.uniform(0.3, 1.0, batch + (n,)).astype(np.float32)
    cu = rng.randn(*batch, n, w).astype(np.float32)
    cd = (1e-2 * rng.randn(*batch, n, w)).astype(np.float32)
    return pos, vel, albedo, cu, cd


def _texture(size=16):
    # a checker times a ramp: neighbouring texels differ, so uv slopes count
    ramp = np.linspace(0.6, 1.0, size, dtype=np.float32)
    return np.asarray(jrender.checker_texture(size, 4)) * ramp[None, :]


def _kink_free(pos, vel, albedo, tex, cu, cd, cfg):
    """The cotangents with the kink pixels (module docstring) set to 0."""
    p, v = torch.tensor(pos), torch.tensor(vel)
    dirs = camera.unit_heading(v)
    _, _, winner = render.render_eyes_wireframe(p, dirs, p, dirs, cfg)
    valid = winner >= 0
    j = torch.where(valid, winner, 0).long()
    per_pixel = lambda x: torch.gather(x[..., None, :, :].expand(j.shape[:-1] + x.shape[-2:]), -2,
                                       j[..., None].expand(j.shape + (2,)))
    u_p = camera.pixel_centers(cfg)
    _, _, uv = wireframe._winner_fragments(p, dirs, per_pixel(p), per_pixel(dirs), u_p, cfg)
    size = torch.tensor([tex.shape[1] - 1, tex.shape[0] - 1], dtype=torch.float32)
    x = uv * size
    kink = ((x - x.round()).abs() < KINK) & (uv > 0) & (uv < 1)
    kink = kink.any(-1) & valid
    keep = (~kink).numpy()
    return cu * keep, cd * keep, int(kink.sum())


def _port_grads(fn, pos, vel, albedo, tex, cu, cd):
    leaves = [torch.tensor(x, requires_grad=True) for x in (pos, vel, albedo, tex)]
    s, d = fn(*leaves)
    ((s * torch.tensor(cu)).sum() + (d * torch.tensor(cd)).sum()).backward()
    return [np.zeros_like(x.detach().numpy()) if x.grad is None else x.grad.numpy()
            for x in leaves]


def _jax_grads(fn, pos, vel, albedo, tex, cu, cd):
    def loss(*a):
        s, d = fn(*a)
        return jnp.sum(s * cu) + jnp.sum(d * cd)

    args = [jnp.asarray(x) for x in (pos, vel, albedo, tex)]
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(*args)]


def _assert_grads(got, want, names=("pos", "vel", "albedo", "texture")):
    for g, x, name in zip(got, want, names):
        assert np.abs(x).max() > 0, f"{name}: the reference gradient is zero"
        np.testing.assert_allclose(g, x, rtol=2e-4, atol=2e-4 * np.abs(x).max(), err_msg=name)


@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("with_albedo", [False, True])
def test_textured_diff_matches_jax_textured_diff(aa, with_albedo):
    """d pos, d vel, d albedo and d texture of render_rows_wireframe_textured_diff
    against JAX's (its winner route: the Pallas forward in interpret mode,
    _winner_pullback with albedo and texture)."""
    pos, vel, albedo, cu, cd = _inputs(32, 32, 3 + aa)
    tex = _texture()
    cfg, jcfg = _cfgs(32, aa)
    cu, cd, kinks = _kink_free(pos, vel, albedo if with_albedo else None, tex, cu, cd, cfg)
    # with antialias, pixels past a sprite's end evaluate at its clamped end,
    # where uv sits within rounding of a vertex's
    assert kinks < 0.1 * cu.size
    got = _port_grads(lambda p, v, a, t: wireframe.render_rows_wireframe_textured_diff(
        p, v, cfg, t, a if with_albedo else None), pos, vel, albedo, tex, cu, cd)
    want = _jax_grads(lambda p, v, a, t: jwireframe.render_rows_wireframe_textured_diff(
        p, v, jcfg, t, a if with_albedo else None), pos, vel, albedo, tex, cu, cd)
    keep = slice(None) if with_albedo else [0, 1, 3]
    _assert_grads(np.array(got, dtype=object)[keep], np.array(want, dtype=object)[keep],
                  np.array(["pos", "vel", "albedo", "texture"])[keep])
    if not with_albedo:
        assert np.abs(got[2]).max() == 0.0  # an albedo the render never read


@pytest.mark.parametrize("aa", [False, True])
def test_batched_textured_diff_matches_jax_batched(aa):
    """albedo [B, N] and one texture for all envs, whose cotangent sums over
    them (render_rows_wireframe_batched_diff, wireframe.py:3026)."""
    pos, vel, albedo, cu, cd = _inputs(16, 32, 11, batch=(3,))
    tex = _texture()
    cfg, jcfg = _cfgs(32, aa)
    cu, cd, _ = _kink_free(pos, vel, albedo, tex, cu, cd, cfg)
    got = _port_grads(lambda p, v, a, t: wireframe.render_rows_wireframe_diff(p, v, cfg, a, t),
                      pos, vel, albedo, tex, cu, cd)
    want = _jax_grads(lambda p, v, a, t: jwireframe.render_rows_wireframe_batched_diff(
        p, v, jcfg, albedo=a, texture=t), pos, vel, albedo, tex, cu, cd)
    _assert_grads(got, want)
    # the forward: the JAX batched render with albedo and texture
    s, d = wireframe.render_rows_wireframe_diff(torch.tensor(pos), torch.tensor(vel), cfg,
                                                torch.tensor(albedo), torch.tensor(tex))
    js, jd = jwireframe.render_rows_wireframe_batched_diff(
        jnp.asarray(pos), jnp.asarray(vel), jcfg, albedo=jnp.asarray(albedo),
        texture=jnp.asarray(tex))
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), rtol=1e-5, atol=3e-4)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), rtol=1e-5, atol=3e-4)


@pytest.mark.parametrize("aa", [False, True])
def test_textured_diff_matches_plain_autograd(aa):
    """The winner pullback against autograd through the whole plain renderer
    (the same gather sampler, so no kink allowance), a batch of envs."""
    pos, vel, albedo, cu, cd = _inputs(20, 48, 13, batch=(2,))
    tex = _texture(12)
    cfg, _ = _cfgs(48, aa)
    got = _port_grads(lambda p, v, a, t: wireframe.render_rows_wireframe_diff(p, v, cfg, a, t),
                      pos, vel, albedo, tex, cu, cd)
    want = _port_grads(lambda p, v, a, t: render.render_rows(p, v, cfg, albedo=a, texture=t),
                       pos, vel, albedo, tex, cu, cd)
    _assert_grads(got, want)


def test_textured_pullback_chunks_over_envs(monkeypatch):
    """The pullback's env chunks (WF_PULL_PIXELS) change no gradient: the
    texture's sums across chunks round apart only."""
    pos, vel, albedo, cu, cd = _inputs(12, 16, 17, batch=(4,))
    tex = _texture()
    cfg, _ = _cfgs(16, True)

    def grads():
        return _port_grads(lambda p, v, a, t: wireframe.render_rows_wireframe_diff(p, v, cfg, a, t),
                           pos, vel, albedo, tex, cu, cd)

    whole = grads()
    monkeypatch.setattr(wireframe, "WF_PULL_PIXELS", 12 * 16)  # one env a chunk
    for g, x in zip(grads(), whole):
        assert np.abs(x).max() > 0
        np.testing.assert_allclose(g, x, rtol=1e-6, atol=1e-6 * np.abs(x).max())


def test_appearance_gradients_only_where_asked():
    """An albedo or texture that needs no grad gets none, and the positions'
    gradients do not change for it; the Function runs only when autograd
    needs it; CPU tensors launch nothing."""
    pos, vel, albedo, cu, _ = _inputs(16, 16, 19)
    cfg, _ = _cfgs(16, True)
    tex = torch.tensor(_texture())
    common.reset_launch_counts()
    p, v, a = torch.tensor(pos), torch.tensor(vel), torch.tensor(albedo)
    s, _ = wireframe.render_rows_wireframe_tiled(p, v, cfg, albedo=a, texture=tex)
    assert s.grad_fn is None
    p.requires_grad_()
    s, _ = wireframe.render_rows_wireframe_tiled(p, v, cfg, albedo=a, texture=tex)
    assert type(s.grad_fn).__name__ == "RenderRowsWireframeDiffBackward"
    (s * torch.tensor(cu)).sum().backward()
    assert a.grad is None and tex.grad is None
    q = torch.tensor(pos, requires_grad=True)
    a2, t2 = a.clone().requires_grad_(), tex.clone().requires_grad_()
    s2, _ = wireframe.render_rows_wireframe_tiled(q, v, cfg, albedo=a2, texture=t2)
    (s2 * torch.tensor(cu)).sum().backward()
    torch.testing.assert_close(q.grad, p.grad, rtol=0, atol=0)
    assert a2.grad.abs().max() > 0 and t2.grad.abs().max() > 0
    assert all(c == 0 for c in common.launch_counts().values())


def test_ring_textured_diff_matches_one_device():
    """The ring with a texture, differentiable: each hop's Function samples
    the replicated texture and its d texture adds across hops and shards."""
    pos, vel, _, cu, _ = _inputs(32, 32, 23)
    tex = _texture()
    cfg, _ = _cfgs(32, True)
    mesh = make_mesh({"agents": 4}, devices=["cpu"] * 4)
    grads = []
    for fn in (lambda p, v, t: ring.ring_render_rows_diff(p, v, cfg, mesh=mesh, texture=t),
               lambda p, v, t: wireframe.render_rows_wireframe_diff(p, v, cfg, texture=t)):
        leaves = [torch.tensor(x, requires_grad=True) for x in (pos, vel, tex)]
        s, _ = fn(*leaves)
        (s * torch.tensor(cu)).sum().backward()
        grads.append([x.grad.numpy() for x in leaves])
    _assert_grads(*grads, names=("pos", "vel", "texture"))
