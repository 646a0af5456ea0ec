"""Appearance in the port (per-target albedo, skin textures, RGB rows)
against the JAX package, on shared numpy inputs: the plain versions against
JAX's dense renderer and its Pallas forms in interpret mode (`has_alb`,
`raw`), the texture and color helpers, render_single_row, and Scene's
observe_textured and observe_rgb on the dense, kernel (plain versions on the
CPU) and ring routes.

Tolerances: tests/test_texture_kernel.py's (shade and depth rtol 1e-5, atol
3e-4, the hit masks equal): the JAX renderer samples small textures by a
contraction (sample_texture_mm) and the port by a gather, equal up to
rounding; tests/test_albedo.py's rtol/atol 2e-5 where no texture is
sampled. Textures have an even size (a disc's sample row 0.5 (Ht - 1) is
then no texel centre), as in the JAX tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu.ops import raycast as jraycast
from nenbody_tpu.ops import wireframe as jwireframe
from nenbody_tpu.parallel import ring as jring
from nenbody_tpu.parallel.mesh import make_mesh as jmake_mesh
from nenbody_tpu.scene import Scene as JScene
from nenbody_tpu.state import SceneState as JSceneState
from nenbody_tpu.vision import render as jrender

from nenbody_tpu_torch import Scene, SceneState, SimConfig, VisionConfig
from nenbody_tpu_torch.ops import common, raycast, wireframe
from nenbody_tpu_torch.parallel import make_mesh, ring
from nenbody_tpu_torch.vision import render

torch.set_num_threads(1)

FAR = 200.0
TEX_TOL = dict(rtol=1e-5, atol=3e-4)


def _cfgs(w, aa=False, sprite="disc", **kw):
    kw = dict(width=w, antialias=aa, sprite_mode=sprite, far=FAR, **kw)
    return VisionConfig(**kw), JVisionConfig(**kw)


def _scene(n, seed, batch=(), spread=40.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-spread, spread, batch + (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, batch + (n, 2)).astype(np.float32)
    return pos, vel


def _albedo(shape, seed):
    return np.random.RandomState(seed).uniform(0.3, 1.0, shape).astype(np.float32)


def _texture(size=16, cells=4):
    return np.asarray(jrender.checker_texture(size, cells))


def _form(form, n, seed, batch=()):
    albedo = _albedo(batch + (n,), seed) if "albedo" in form else None
    texture = _texture() if "texture" in form else None
    return albedo, texture


def _t(x):
    return None if x is None else torch.tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _assert_rows(got, want, tol=TEX_TOL):
    gs, gd = (np.asarray(x) for x in got)
    ws, wd = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gd < FAR, wd < FAR)
    assert (wd < FAR).mean() > 0.05  # sprites in view
    np.testing.assert_allclose(gd, wd, **tol)
    np.testing.assert_allclose(gs, ws, **tol)


def test_sample_texture_matches_jax():
    """Bilinear, clamp-to-edge, at random uv in and outside [0, 1], at texel
    corners and centres, on a texture of distinct texels."""
    rng = np.random.RandomState(0)
    tex = rng.uniform(0, 1, (6, 10)).astype(np.float32)
    uv = np.concatenate([rng.uniform(-0.2, 1.2, (500, 2)),
                         [[0, 0], [1, 0], [0, 1], [1, 1], [0.5, 0.5], [2, -1]]]).astype(np.float32)
    want = np.asarray(jrender.sample_texture(jnp.asarray(tex), jnp.asarray(uv)))
    got = render.sample_texture(torch.tensor(tex), torch.tensor(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[-6:-1], tex[[0, 0, -1, -1, 2], [0, -1, 0, -1, 4]] * [1, 1, 1, 1, 0]
                               + [0, 0, 0, 0, want[-2]], atol=1e-6)
    assert got[-1] == tex[0, -1]  # clamped to the edge


def test_checker_texture_and_default_colors_match_jax():
    for size, cells, lo, hi in ((32, 4, 0.35, 1.0), (16, 4, 0.0, 1.0), (12, 3, 0.2, 0.9)):
        np.testing.assert_array_equal(render.checker_texture(size, cells, lo, hi).numpy(),
                                      np.asarray(jrender.checker_texture(size, cells, lo, hi)))
    colors = render.default_agent_colors(1024)
    assert colors.shape == (1024, 3) and colors.dtype == torch.float32
    np.testing.assert_allclose(colors.numpy(), np.asarray(jrender.default_agent_colors(1024)),
                               rtol=1e-6, atol=1e-6)
    assert render.BACKGROUND_RGB == jrender.BACKGROUND_RGB
    assert render.SPRITE_RGB == jrender.SPRITE_RGB


def test_to_rgb_matches_jax():
    pos, vel = _scene(40, 1)
    cfg, jcfg = _cfgs(32)
    shade, depth = render.render_rows(_t(pos), _t(vel), cfg)
    want = np.asarray(jrender.to_rgb(jnp.asarray(shade.numpy()), jnp.asarray(depth.numpy()), jcfg))
    got = render.to_rgb(shade, depth, cfg)
    assert got.shape == (40, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("form", ["albedo", "texture", "albedo+texture"])
@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_plain_appearance_matches_jax_dense(sprite, aa, form):
    """The plain renderer (which the kernels' wrappers run on CPU tensors)
    against JAX's dense render_rows, for one env and a batch of envs."""
    pos, vel = _scene(48, 3)
    albedo, texture = _form(form, 48, 4)
    cfg, jcfg = _cfgs(64, aa, sprite)
    want = jrender.render_rows(jnp.asarray(pos), jnp.asarray(vel), jcfg, albedo=_j(albedo),
                               texture=_j(texture))
    got = render.render_rows(_t(pos), _t(vel), cfg, albedo=_t(albedo), texture=_t(texture))
    _assert_rows(got, want, TEX_TOL if texture is not None else dict(rtol=2e-5, atol=2e-5))
    # the kernels' wrappers, batched: each env as the JAX renderer has it
    pb, vb = _scene(24, 5, batch=(2,))
    ab, tex = _form(form, 24, 6, batch=(2,))
    fn = (wireframe.render_rows_wireframe_tiled if sprite == "wireframe"
          else raycast.render_rows_tiled)
    got = fn(_t(pb), _t(vb), cfg, albedo=_t(ab), texture=_t(tex))
    for i in range(2):
        want = jrender.render_rows(jnp.asarray(pb[i]), jnp.asarray(vb[i]), jcfg,
                                   albedo=None if ab is None else jnp.asarray(ab[i]),
                                   texture=_j(tex))
        _assert_rows((got[0][i], got[1][i]), want)


@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_plain_appearance_matches_jax_pallas_forms(sprite, aa):
    """Against the JAX Pallas kernels' has_alb and raw forms (interpret
    mode), as test_texture_kernel.py and test_albedo.py run them: albedo and
    texture together, then albedo alone."""
    pos, vel = _scene(40, 7 + aa)
    albedo, texture = _form("albedo+texture", 40, 8)
    cfg, jcfg = _cfgs(64, aa, sprite)
    if sprite == "wireframe":
        jfn, fn = jwireframe.render_rows_wireframe_tiled, wireframe.render_rows_wireframe_tiled
    else:
        jfn, fn = jraycast.render_rows_tiled, raycast.render_rows_tiled
    for tex in (texture, None):
        want = jfn(jnp.asarray(pos), jnp.asarray(vel), jcfg, albedo=jnp.asarray(albedo),
                   texture=_j(tex))
        got = fn(_t(pos), _t(vel), cfg, albedo=_t(albedo), texture=_t(tex))
        _assert_rows(got, want)


def test_albedo_identifies_the_winner():
    """Two targets on one ray: the nearer one's albedo shades the pixel
    (test_albedo.py's scene), on the plain version and through render_rows."""
    cfg = VisionConfig(width=33)
    pos = torch.tensor([[0.0, 0.0], [10.0, 0.0], [20.0, 0.0]])
    vel = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.0, 1.0]])
    albedo = torch.tensor([0.1, 0.9, 0.4])
    for fn in (render.render_rows, raycast.render_rows_tiled):
        shade, depth = fn(pos, vel, cfg, albedo=albedo)
        assert depth[0, 16].item() == pytest.approx(10.0, rel=1e-5)
        assert shade[0, 16].item() == pytest.approx(0.9, rel=1e-3)


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_render_rows_rgb_matches_jax(backend, sprite):
    pos, vel = _scene(48, 9)
    cfg, jcfg = _cfgs(64, True, sprite)
    colors = render.default_agent_colors(48)
    want = np.asarray(jrender.render_rows_rgb(jnp.asarray(pos), jnp.asarray(vel), jcfg,
                                              jrender.default_agent_colors(48), backend=backend))
    got = render.render_rows_rgb(_t(pos), _t(vel), cfg, colors, backend=backend)
    assert got.shape == (48, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_render_single_row_matches_jax(sprite):
    pos, vel = _scene(80, 10, spread=15.0)
    albedo, texture = _form("albedo+texture", 80, 11)
    cfg, jcfg = _cfgs(256, True, sprite)
    for eye in (1, 17):
        for alb, tex in ((None, None), (albedo, texture)):
            want = jrender.render_single_row(jnp.asarray(pos), jnp.asarray(vel), eye, jcfg,
                                             albedo=_j(alb), texture=_j(tex))
            got = render.render_single_row(_t(pos), _t(vel), eye, cfg, albedo=_t(alb),
                                           texture=_t(tex))
            assert got[0].shape == (256,)
            _assert_rows(got, want)


def _states(n, seed, batch=()):
    pos, vel = _scene(n, seed, batch)
    key = jax.random.split(jax.random.key(0), batch[0]) if batch else jax.random.key(0)
    jst = JSceneState(pos=jnp.asarray(pos), vel=jnp.asarray(vel), key=key,
                      t=jnp.zeros(batch, jnp.int32))
    st = SceneState(pos=_t(pos), vel=_t(vel), t=torch.zeros((), dtype=torch.int32))
    return st, jst


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_scene_observe_textured_across_backends(sprite):
    """Scene.observe_textured on the dense, kernel and ring routes (a CPU
    mesh of 4 shards) against the JAX dense Scene, unbatched and batched."""
    tex = _texture()
    kw = dict(n=64, controller="boids")
    cfg, jcfg = _cfgs(32, sprite=sprite)
    mesh = make_mesh({"agents": 4}, devices=["cpu"] * 4)
    for batch in ((), (2,)):
        st, jst = _states(64, 12, batch)
        jscene = JScene(JSimConfig(**kw, backend="dense", vision=jcfg))
        want = np.asarray(jscene.observe_textured(jst, jnp.asarray(tex)))
        assert want.shape == batch + (64, 32)
        for backend in ("dense", "pallas", "ring"):
            scene = Scene(SimConfig(**kw, backend=backend, vision=cfg), device="cpu", mesh=mesh)
            got = scene.observe_textured(st, tex)  # a numpy texture moves to the state's device
            np.testing.assert_allclose(got.numpy(), want, err_msg=backend, **TEX_TOL)


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_scene_observe_rgb_matches_jax(sprite):
    """observe_rgb with per-agent colors (kernel and dense routes) and
    without (to_rgb of the depth render), against the JAX Scene; colors
    with a batched state are refused, as in the JAX package."""
    kw = dict(n=40, controller="gravity")
    cfg, jcfg = _cfgs(48, True, sprite)
    st, jst = _states(40, 13)
    colors = render.default_agent_colors(40)
    for backend in ("dense", "pallas"):
        jscene = JScene(JSimConfig(**kw, backend=backend, vision=jcfg))
        scene = Scene(SimConfig(**kw, backend=backend, vision=cfg), device="cpu")
        for c, jc in ((colors, jrender.default_agent_colors(40)), (None, None)):
            want = np.asarray(jscene.observe_rgb(jst, colors=jc))
            got = scene.observe_rgb(st, colors=c)
            assert got.shape == (40, 48, 3)
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    batched, _ = _states(40, 14, batch=(2,))
    assert scene.observe_rgb(batched).shape == (2, 40, 48, 3)
    with pytest.raises(ValueError, match="unbatched"):
        scene.observe_rgb(batched, colors=colors)


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_ring_texture_matches_jax_ring(sprite):
    """ring_render_rows(texture=) against the JAX ring on 2 virtual devices
    (test_texture_kernel.py's case) and against the port's one-device rows,
    with N not divisible by the 4 shards (sentinel padding)."""
    pos, vel = _scene(62, 15)
    tex = _texture()
    cfg, jcfg = _cfgs(64, True, sprite)
    want = jring.ring_render_rows(jnp.asarray(pos), jnp.asarray(vel), jcfg,
                                  mesh=jmake_mesh(devices=jax.devices()[:2]),
                                  texture=jnp.asarray(tex))
    mesh = make_mesh({"agents": 4}, devices=["cpu"] * 4)
    got = ring.ring_render_rows(_t(pos), _t(vel), cfg, mesh=mesh, texture=_t(tex))
    _assert_rows(got, want)
    one = (wireframe.render_rows_wireframe_tiled if sprite == "wireframe"
           else raycast.render_rows_tiled)(_t(pos), _t(vel), cfg, texture=_t(tex))
    _assert_rows(got, one, dict(rtol=1e-6, atol=1e-6))


def test_appearance_on_cpu_launches_nothing_and_checks_its_inputs():
    """CPU tensors take the plain versions (no launch); a disc render with
    appearance refuses a gradient (the JAX package has no such route); the
    wrappers check the appearance's shape and type."""
    pos, vel = _scene(16, 16)
    p, v = _t(pos), _t(vel)
    alb, tex = torch.rand(16), render.checker_texture(8, 2)
    disc, _ = _cfgs(16, True)
    wf = dataclasses.replace(disc, sprite_mode="wireframe")
    common.reset_launch_counts()
    raycast.render_rows_tiled(p, v, disc, albedo=alb, texture=tex)
    wireframe.render_rows_wireframe_tiled(p, v, wf, albedo=alb, texture=tex)
    assert all(c == 0 for c in common.launch_counts().values())
    with pytest.raises(NotImplementedError, match="albedo or texture"):
        raycast.render_rows_tiled(p.clone().requires_grad_(), v, disc, texture=tex)
    with pytest.raises(NotImplementedError, match="albedo or texture"):
        raycast.render_rows_tiled(p, v, disc, albedo=alb.clone().requires_grad_())
    with pytest.raises(ValueError, match="one per target"):
        common.appearance_args("disc_eye", p, torch.rand(15), None)
    with pytest.raises(ValueError, match="Ht, Wt"):
        common.appearance_args("disc_eye", p, None, torch.rand(4))
    with pytest.raises(ValueError, match="float32"):
        common.appearance_args("disc_eye", p, alb.double(), None)
