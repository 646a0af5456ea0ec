"""The port's first-person viewport and frame (Scene.render_eye_view,
Scene.render_frame) and the ops modules' render_lines against the JAX
package's, on the CPU, on shared numpy states (the JAX cases of
tests/test_eye_view.py, each run through both packages).

Tolerance: the hit mask of each row is equal, and the uint8 pixels differ
by at most 1 where the shade sits on a rounding edge (the wireframe's AA
shade, ROADMAP queue 3: up to 6.8e-5 apart, which can move a channel across
a quantization step). render_lines: the eye's own tolerances (depth rtol
1e-5 / atol 1e-4, shade 1e-5, the wireframe's 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import Scene as JScene
from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu.ops import raycast as jraycast
from nenbody_tpu.ops import wireframe as jwireframe
from nenbody_tpu.state import SceneState as JSceneState
from nenbody_tpu.state import spawn_batch as jspawn_batch
from nenbody_tpu.vision.render import checker_texture as jchecker

from nenbody_tpu_torch import Scene, SceneState, SimConfig, VisionConfig
from nenbody_tpu_torch.ops import raycast, wireframe
from nenbody_tpu_torch.vision import render
from nenbody_tpu_torch.viz import frame as frame_lib

torch.set_num_threads(1)

CLEAR = frame_lib.to_uint8(np.asarray(frame_lib.CLEAR_COLOR, np.float32)[None, None])[0, 0]


def _scenes(n, vision=None, controller="gravity", **kw):
    """(JAX scene, port scene) of one config on the dense backend."""
    js = JScene(JSimConfig(n=n, controller=controller, backend="dense",
                           vision=None if vision is None else JVisionConfig(**vision), **kw))
    ts = Scene(SimConfig(n=n, controller=controller, backend="dense",
                         vision=None if vision is None else VisionConfig(**vision), **kw),
               device="cpu")
    return js, ts


def _states(pos, vel):
    pos, vel = np.asarray(pos, np.float32), np.asarray(vel, np.float32)
    return (JSceneState(pos=jnp.asarray(pos), vel=jnp.asarray(vel), key=jax.random.key(0),
                        t=jnp.int32(0)),
            SceneState(pos=torch.tensor(pos), vel=torch.tensor(vel),
                       t=torch.tensor(0, dtype=torch.int32)))


def _both_views(js, ts, pos, vel, eye=0, **kw):
    """render_eye_view of both packages, the port's held to the JAX one's."""
    jst, tst = _states(pos, vel)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    want = np.asarray(js.render_eye_view(jst, eye, **jkw))
    got = ts.render_eye_view(tst, eye, **tkw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert ((got != CLEAR).any(-1) == (want != CLEAR).any(-1)).all()  # the hit mask
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    return got


TWO = ([[0.0, 0.0], [10.0, 0.0]], [[1.0, 0.0], [0.0, 1.0]])  # eye 0 faces target 1 at 10


def test_eye_view_shows_target_on_horizon():
    js, ts = _scenes(2, dict(width=64))
    img = _both_views(js, ts, *TWO, size=(120, 240), thickness=2)
    assert img.shape == (120, 240, 3)
    assert (img[:59] == CLEAR).all() and (img[61:] == CLEAR).all()
    mid = img[59:61]
    assert (mid[:, 118:122].mean(axis=(0, 1)) > CLEAR).any() and (mid != CLEAR).any()


def test_eye_view_follows_heading():
    js, ts = _scenes(2, dict(width=64))
    img = _both_views(js, ts, TWO[0], [[-1.0, 0.0], [0.0, 1.0]], size=(60, 120))
    assert (img == CLEAR).all()


def test_eye_view_validation_and_modes():
    js, ts = _scenes(4, dict(width=32, sprite_mode="wireframe"), controller="boids")
    st = ts.spawn(seed=0)
    img = _both_views(js, ts, st.pos.numpy(), st.vel.numpy(), eye=3, size=(40, 80))
    assert img.shape == (40, 80, 3)
    jst, _ = _states(st.pos.numpy(), st.vel.numpy())
    for scene, state in ((js, jst), (ts, st)):
        with pytest.raises(ValueError, match="out of range"):
            scene.render_eye_view(state, eye=4)
    with pytest.raises(ValueError, match="unbatched"):
        js.render_eye_view(jspawn_batch(jax.random.key(0), js.cfg, 2), eye=0)
    with pytest.raises(ValueError, match="unbatched"):
        ts.render_eye_view(ts.spawn_envs(2, seed=0), eye=0)


def test_eye_view_works_without_vision_config():
    js, ts = _scenes(4)
    st = ts.spawn(seed=0)
    img = _both_views(js, ts, st.pos.numpy(), st.vel.numpy(), size=(30, 60))
    assert img.shape == (30, 60, 3)


def test_eye_view_perspective_thickness():
    js, ts = _scenes(3, dict(width=128))
    img = _both_views(js, ts, [[0.0, 0.0], [5.0, 0.0], [40.0, 0.0]],
                      [[1.0, 0.0], [0.0, 1.0], [0.0, 1.0]], size=(120, 128))
    heights = (img != CLEAR).any(axis=-1).sum(axis=0)
    assert heights[54:74].max() >= 10 and (heights[:10] <= 2).all()


def test_eye_view_per_agent_colors_and_texture():
    js, ts = _scenes(2, dict(width=64))
    colors = np.asarray([[1.0, 0.1, 0.1], [0.1, 1.0, 0.1]], np.float32)
    img = _both_views(js, ts, *TWO, size=(60, 64), colors=colors)
    mid = img[29:31].astype(np.int32)
    hit = mid[mid.max(axis=-1) > 80]
    assert hit.size and (hit[:, 1] > hit[:, 0]).all()  # agent 1 is green
    tex = np.asarray(jchecker(8, 2))
    np.testing.assert_array_equal(render.checker_texture(8, 2).numpy(), tex)
    assert _both_views(js, ts, *TWO, size=(60, 64), texture=tex).shape == (60, 64, 3)


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
@pytest.mark.parametrize("aa", [False, True], ids=["aa-off", "aa-on"])
@pytest.mark.parametrize("width", [96, 128])
@pytest.mark.parametrize("form", ["bare", "colors", "texture"])
def test_eye_view_matches_jax_on_a_swarm(sprite, aa, width, form):
    """Many targets at once, each sprite and AA mode, odd and power-of-two
    widths, with and without appearance: hits equal, pixels within 1."""
    n = 48
    rng = np.random.default_rng(width + 7 * aa)
    pos = rng.uniform(-20, 20, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    js, ts = _scenes(n, dict(width=32, sprite_mode=sprite, antialias=aa))
    kw = {"colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
          "texture": rng.uniform(0, 1, (6, 10)).astype(np.float32)}
    _both_views(js, ts, pos, vel, eye=5, size=(50, width),
                **({} if form == "bare" else {form: kw[form]}))


def test_render_eye_row_is_render_single_row():
    n = 32
    rng = np.random.default_rng(12)
    _, st = _states(rng.uniform(-20, 20, (n, 2)), rng.uniform(-1, 1, (n, 2)))
    for sprite in ("disc", "wireframe"):
        vcfg = VisionConfig(width=24, sprite_mode=sprite)
        ts = Scene(SimConfig(n=n, controller="gravity", vision=vcfg), device="cpu")
        got = ts.render_eye_row(st, 3, 80)
        want = render.render_single_row(st.pos, st.vel, 3, VisionConfig(width=80,
                                                                         sprite_mode=sprite))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("with_obs", [False, True], ids=["no-obs", "obs"])
def test_render_frame_matches_jax(with_obs):
    n = 24
    js, ts = _scenes(n, dict(width=32), controller="boids")
    st = ts.spawn(seed=0)
    jst, tst = _states(st.pos.numpy(), st.vel.numpy())
    want = np.asarray(js.render_frame(jst, selected_eye=3, size=(64, 96), with_obs=with_obs))
    got = ts.render_frame(tst, selected_eye=3, size=(64, 96), with_obs=with_obs)
    assert got.dtype == np.uint8 and got.shape[1] == 96
    assert (got.shape[0] > 64) == with_obs
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unbatched"):
        ts.render_frame(ts.spawn_envs(2, seed=0))


@pytest.mark.parametrize("module", ["raycast", "wireframe"])
def test_render_lines_match_jax(module):
    n = 40
    rng = np.random.default_rng(13)
    jst, tst = _states(rng.uniform(-30, 30, (n, 2)), rng.uniform(-1, 1, (n, 2)))
    sprite = "disc" if module == "raycast" else "wireframe"
    jmod, tmod = (jraycast, raycast) if module == "raycast" else (jwireframe, wireframe)
    jcfg = JVisionConfig(width=128, sprite_mode=sprite)
    tcfg = VisionConfig(width=128, sprite_mode=sprite)
    shade_atol = 1e-5 if sprite == "disc" else 2e-4
    jshade, jdepth = jmod.render_lines_with_depth(jst, jcfg)
    shade, depth = tmod.render_lines_with_depth(tst, tcfg)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(shade.numpy(), np.asarray(jshade), rtol=1e-5, atol=shade_atol)
    assert torch.equal(tmod.render_lines(tst, tcfg), shade)
