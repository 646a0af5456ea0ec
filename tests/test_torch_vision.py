"""The port's disc eye (nenbody_tpu_torch.vision and the plain version of the
eye kernel in nenbody_tpu_torch.ops.raycast) against the JAX package's dense
renderer and its Pallas raycast kernels in interpret mode, on shared numpy
inputs made from a seed.

Tolerances are test_kernels.py:209-210's (the JAX kernels against the JAX
dense renderer): shade rtol 1e-5 / atol 1e-5, depth rtol 1e-5 / atol 1e-4.
With antialias the shade's atol is 1e-4: the edge coverage multiplies a
last-bit difference of the splat offset by the splat's half-width in pixels
(W/2 * du, hundreds at W=1024), and XLA contracts and fuses the JAX
renderer's arithmetic under jit (the port's projections equal the JAX ones
bit for bit op by op). The JAX package's own Pallas kernels differ from its
dense renderer by up to 5.7e-5 at (N, W) = (100, 1024) with antialias.

Against the Pallas kernels with antialias, at most 1e-4 of the pixels may
flip coverage: they test it as off^2 < (1 + hp)^2 with off from a reciprocal
multiply (raycast.py:133-145) where the dense renderer and the port test
|off| < 1 + hp; at (N, W) = (100, 1024) one pixel flips between the JAX
package's own Pallas kernel and its dense renderer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import Scene as JScene
from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu import state as jstate
from nenbody_tpu.ops import raycast as jraycast
from nenbody_tpu.vision import camera as jcamera
from nenbody_tpu.vision import render as jrender

from nenbody_tpu_torch import Scene, SceneState, SimConfig, VisionConfig
from nenbody_tpu_torch.ops import common, raycast
from nenbody_tpu_torch.vision import camera, render

torch.set_num_threads(1)

SHADE_TOL = dict(rtol=1e-5, atol=1e-5)
AA_SHADE_TOL = dict(rtol=1e-5, atol=1e-4)
DEPTH_TOL = dict(rtol=1e-5, atol=1e-4)


def _arrays(n, seed, batch=()):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-100, 100, batch + (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, batch + (n, 2)).astype(np.float32)
    return pos, vel


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _assert_rows(got, want, aa=False):
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **DEPTH_TOL)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **(AA_SHADE_TOL if aa else SHADE_TOL))


def _assert_rows_vs_pallas(got, want, aa):
    if not aa:
        return _assert_rows(got, want)
    for g, w, tol in ((got[1], want[1], DEPTH_TOL), (got[0], want[0], AA_SHADE_TOL)):
        g, w = g.numpy(), np.asarray(w)
        beyond = np.abs(g - w) > tol["atol"] + tol["rtol"] * np.abs(w)
        assert beyond.mean() <= 1e-4, f"{beyond.sum()} of {beyond.size} pixels flipped"


def test_camera_matches_jax():
    pos, vel = _arrays(40, 1)
    vel[0] = 0.0  # zero velocity faces +x
    np.testing.assert_allclose(camera.unit_heading(_t(vel)).numpy(),
                               np.asarray(jcamera.unit_heading(jnp.asarray(vel))),
                               rtol=1e-6, atol=1e-6)
    for w in (1, 17, 64, 1024):
        np.testing.assert_array_equal(camera.pixel_centers_for_width(w).numpy(),
                                      np.asarray(jcamera.pixel_centers_for_width(w)))
    cfg, jcfg = VisionConfig(width=64), JVisionConfig(width=64)
    d = np.asarray(jcamera.unit_heading(jnp.asarray(vel)))
    rel = pos - pos[3]
    got = camera.project(_t(rel), _t(d[3]), cfg)
    want = jcamera.project(jnp.asarray(rel), jnp.asarray(d[3]), jcfg)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("n,w", [(24, 64), (100, 128), (60, 32), (20, 512), (100, 1024)])
@pytest.mark.parametrize("aa", [False, True])
def test_disc_eye_matches_jax_dense_and_pallas(n, w, aa):
    pos, vel = _arrays(n, 4 + n)
    jcfg = JVisionConfig(width=w, antialias=aa)
    cfg = VisionConfig(width=w, antialias=aa)
    want_dense = jrender.render_rows(jnp.asarray(pos), jnp.asarray(vel), jcfg)
    want_pallas = jraycast.render_rows_tiled(jnp.asarray(pos), jnp.asarray(vel), jcfg)
    got_dense = render.render_rows(_t(pos), _t(vel), cfg)
    got_plain = raycast.render_rows_tiled(_t(pos), _t(vel), cfg)
    _assert_rows(got_dense, want_dense, aa)
    _assert_rows_vs_pallas(got_plain, want_pallas, aa)
    _assert_rows(got_plain, want_dense, aa)


def test_disc_eye_targets_cross_render_and_merge():
    pos, vel = _arrays(30, 8)
    tgt, _ = _arrays(50, 9)
    cfg, jcfg = VisionConfig(width=96), JVisionConfig(width=96)
    want = jrender.render_rows(jnp.asarray(pos), jnp.asarray(vel), jcfg, targets=jnp.asarray(tgt))
    got = raycast.render_rows_tiled(_t(pos), _t(vel), cfg, targets=_t(tgt))
    _assert_rows(got, want)
    # partial renders against disjoint target blocks merge into the full one
    a = raycast.render_rows_tiled(_t(pos), _t(vel), cfg, targets=_t(tgt[:20]))
    b = raycast.render_rows_tiled(_t(pos), _t(vel), cfg, targets=_t(tgt[20:]))
    merged = render.merge_rows(a, b)
    torch.testing.assert_close(merged[1], got[1], rtol=0, atol=0)
    torch.testing.assert_close(merged[0], got[0], rtol=0, atol=0)


def test_disc_eye_chunking_and_batch_dims():
    """Eye chunks and leading batch dims change no value: the plain version
    chunks over eyes, and a batch of envs equals a loop over envs."""
    pos, vel = _arrays(45, 10, batch=(3,))
    cfg = VisionConfig(width=40, antialias=True)
    whole = render.render_rows(_t(pos), _t(vel), cfg)
    chunked = render.render_rows(_t(pos), _t(vel), cfg, chunk=7)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
    jcfg = JVisionConfig(width=40, antialias=True)
    for i in range(3):
        one = raycast.render_rows_tiled(_t(pos[i]), _t(vel[i]), cfg)
        torch.testing.assert_close(whole[0][i], one[0], rtol=0, atol=0)
        _assert_rows((whole[0][i], whole[1][i]),
                     jrender.render_rows(jnp.asarray(pos[i]), jnp.asarray(vel[i]), jcfg), aa=True)


def test_disc_eye_depth_tie_goes_to_lowest_index():
    """Two coincident targets: the lower index wins (the argmin rule the
    CUDA kernel also keeps), and the shade equals the JAX dense renderer's."""
    pos = np.array([[0.0, 0.0], [10.0, 0.0], [10.0, 0.0], [5.0, 30.0]], np.float32)
    vel = np.array([[1.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 1.0]], np.float32)
    cfg, jcfg = VisionConfig(width=32), JVisionConfig(width=32)
    _assert_rows(render.render_rows(_t(pos), _t(vel), cfg),
                 jrender.render_rows(jnp.asarray(pos), jnp.asarray(vel), jcfg))


def test_cpu_eye_counts_no_launch_and_wireframe_raises():
    """The disc eye's wrappers raise for a wireframe config (wireframe
    sprites render through ops.wireframe, tests/test_torch_wireframe.py),
    and a CPU render launches nothing."""
    common.reset_launch_counts()
    pos, vel = _arrays(16, 2)
    raycast.render_rows_tiled(_t(pos), _t(vel), VisionConfig(width=16))
    assert common.launch_counts()["disc_eye"] == 0
    wf = VisionConfig(width=16, sprite_mode="wireframe")
    for fn in (raycast.render_rows_tiled, raycast.render_rows_diff):
        with pytest.raises(ValueError, match="wireframe"):
            fn(_t(pos), _t(vel), wf)
    scene = Scene(SimConfig(n=16, vision=wf), device="cpu")
    assert scene.observe(scene.spawn(0)).shape == (16, 16)
    assert all(c == 0 for c in common.launch_counts().values())


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_scene_observe_matches_jax(backend):
    pos, vel = _arrays(64, 12, batch=(2,))
    kw = dict(n=64, controller="gravity", backend=backend)
    jscene = JScene(JSimConfig(**kw, vision=JVisionConfig(width=64)))
    scene = Scene(SimConfig(**kw, vision=VisionConfig(width=64)), device="cpu")
    jst = jstate.spawn_batch(jax.random.key(0), jscene.cfg, 2).replace(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    st = SceneState(pos=_t(pos), vel=_t(vel), t=torch.zeros(2, dtype=torch.int32))
    _assert_rows(scene.observe_with_depth(st), jscene.observe_with_depth(jst))
    np.testing.assert_allclose(scene.observe(st).numpy(), np.asarray(jscene.observe(jst)),
                               **SHADE_TOL)
    st0 = SceneState(pos=st.pos[0], vel=st.vel[0], t=st.t[0])
    jst0 = jax.tree_util.tree_map(lambda x: x[0], jst)
    np.testing.assert_allclose(render.render_lines(st0, scene.cfg.vision).numpy(),
                               np.asarray(jrender.render_lines(jst0, jscene.cfg.vision)),
                               **SHADE_TOL)


def test_scene_without_vision_refuses_observe():
    scene = Scene(dataclasses.replace(SimConfig(n=8), vision=None), device="cpu")
    with pytest.raises(ValueError):
        scene.observe(scene.spawn(0))
    with pytest.raises(ValueError):
        scene.rollout(scene.spawn(0), 1, record=("obs",))
