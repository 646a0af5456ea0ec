"""The port's exact wireframe eye (sprite_mode='wireframe': the plain
renderer in nenbody_tpu_torch.vision.render and the wrapper of the
wireframe_eye kernel in nenbody_tpu_torch.ops.wireframe, which runs that
plain version on CPU tensors) against the JAX package's dense wireframe
renderer and its Pallas wireframe kernels in interpret mode, on shared numpy
inputs made from a seed; the Scene and CLI routes; and the card as the
default device of the entry points.

Tolerances are tests/test_wireframe_kernel.py's (the JAX kernels against the
JAX dense renderer): depth and shade rtol 1e-5 / atol 2e-4, with the set of
hit pixels equal. Against the JAX package's inverse-depth routes (rasterq,
compact) at most 1e-3 of the pixels may flip: they derive hit intervals on
another division route than the dense renderer (_assert_rows_close's
near-tie allowance; tests/test_wireframe_kernel.py:491-496 allows the same).
"""

import dataclasses
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import Scene as JScene
from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu import state as jstate
from nenbody_tpu.ops import wireframe as jwireframe
from nenbody_tpu.vision import render as jrender

from nenbody_tpu_torch import Scene, SceneState, SimConfig, VisionConfig, cli
from nenbody_tpu_torch import state as tstate
from nenbody_tpu_torch.ops import common, wireframe
from nenbody_tpu_torch.rl import ac, apg, es, ppo, train
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.vision import camera, render

torch.set_num_threads(1)

FAR = 200.0  # the JAX wireframe suite's: some sprites lie beyond far


def _cfgs(w, aa=False, far=FAR):
    return (VisionConfig(width=w, antialias=aa, sprite_mode="wireframe", far=far),
            JVisionConfig(width=w, antialias=aa, sprite_mode="wireframe", far=far))


def _arrays(n, seed, batch=(), spread=40.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-spread, spread, batch + (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, batch + (n, 2)).astype(np.float32)
    return pos, vel


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _assert_rows_close(got, want, far=FAR, flip_frac=0.0):
    """tests/test_wireframe_kernel.py's _assert_rows_close: with flip_frac 0
    the hit pixels agree exactly and every value holds rtol 1e-5 / atol
    2e-4; otherwise at most that share of pixels may differ beyond it."""
    gs, gd = (np.asarray(x) for x in got)
    ws, wd = (np.asarray(x) for x in want)
    ghit, whit = gd < far, wd < far
    if flip_frac == 0.0:
        np.testing.assert_array_equal(ghit, whit)
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=2e-4)
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=2e-4)
        return
    flips = (ghit != whit) | (np.abs(gd - wd) > 2e-4 + 1e-5 * np.abs(wd))
    flips |= np.abs(gs - ws) > 2e-4 + 1e-5 * np.abs(ws)
    assert flips.mean() <= flip_frac, f"{flips.mean():.2e} near-tie flips"


@pytest.mark.parametrize("n", [1, 7, 64])
@pytest.mark.parametrize("w", [17, 64])
@pytest.mark.parametrize("aa", [False, True])
def test_wireframe_plain_matches_jax_dense(n, w, aa):
    pos, vel = _arrays(n, 100 + n + w)
    cfg, jcfg = _cfgs(w, aa)
    want = jrender.render_rows(jnp.asarray(pos), jnp.asarray(vel), jcfg)
    got = render.render_rows(_t(pos), _t(vel), cfg)
    _assert_rows_close(got, want)
    if n > 1:
        assert (np.asarray(want[1]) < FAR).mean() > 0.05  # sprites are seen
    # the kernel's wrapper runs the same plain version on CPU tensors
    common.reset_launch_counts()
    tiled = wireframe.render_rows_wireframe_tiled(_t(pos), _t(vel), cfg)
    torch.testing.assert_close(tiled, got, rtol=0, atol=0)
    assert all(c == 0 for c in common.launch_counts().values())


@pytest.mark.parametrize("aa", [False, True])
def test_wireframe_near_plane_and_coincident_eye(aa):
    """Sprites that straddle the near plane (clipped there), a target
    coincident with an eye (culled by exact equality, as the eye's own
    sprite is) and one behind the eye."""
    pos = np.array([[0.0, 0.0], [1.3, 0.2], [0.0, 0.0], [0.9, -0.5], [6.0, 1.0],
                    [-4.0, 0.37]], np.float32)
    vel = np.array([[1.0, 0.0], [0.3, 1.0], [-1.0, 0.5], [1.0, 1.0], [-1.0, 0.2],
                    [1.0, 0.0]], np.float32)
    cfg, jcfg = _cfgs(48, aa)
    want = jrender.render_rows(jnp.asarray(pos), jnp.asarray(vel), jcfg)
    got = render.render_rows(_t(pos), _t(vel), cfg)
    _assert_rows_close(got, want)
    depth = got[1].numpy()
    hit = depth[0] < FAR
    assert hit.any() and (depth[0][hit] >= cfg.near).all()
    # eyes 0 and 2 coincide: each culls the other's sprite too, so their
    # rows equal a render without either of them as targets
    others = np.array([1, 3, 4, 5])
    alone = render.render_rows(_t(pos[[0, 2]]), _t(vel[[0, 2]]), cfg,
                               targets=_t(pos[others]), target_vel=_t(vel[others]))
    torch.testing.assert_close((got[0][[0, 2]], got[1][[0, 2]]), alone, rtol=0, atol=0)


@pytest.mark.parametrize("aa", [False, True])
def test_wireframe_depth_tie_goes_to_the_lower_edge_first(aa):
    """The flattened [3M] argmin is edge-major. At the odd width's centre
    pixel (u = 0 exactly) target 0's back edge (edge 2, uv (0.5, 0.5),
    shade 1) and target 1's nose (edge 0 at tau = 1, uv (0, 1), shade 0.5)
    lie at the same depth 9: edge 0 wins, so target 1 does, though its
    index is higher; the JAX dense renderer agrees."""
    cfg, jcfg = _cfgs(17, aa)
    eye, eye_dir = np.array([[0.0, 0.0]], np.float32), np.array([[1.0, 0.0]], np.float32)
    tgt = np.array([[10.0, 0.0], [10.0, 0.0]], np.float32)
    hdg = np.array([[1.0, 0.0], [-1.0, 0.0]], np.float32)
    shade, depth, winner = render.eye_rows_wireframe(_t(eye), _t(eye_dir), _t(tgt), _t(hdg), cfg)
    assert depth[0, 8].item() == 9.0 and winner[0, 8].item() == 1
    assert shade[0, 8].item() == 0.5
    want = jrender._agent_row_wireframe(jnp.asarray(eye[0]), jnp.asarray(eye_dir[0]),
                                        jnp.asarray(tgt), jnp.asarray(hdg), jcfg)
    _assert_rows_close((shade[0], depth[0]), want)


def test_wireframe_winner_index_is_the_plain_argmin():
    """The plain version's winner is the target whose sprite the pixel
    shows (-1 at background): re-rendering each eye against its winners
    alone gives the same rows wherever depths are not tied."""
    pos, vel = _arrays(24, 3)
    cfg, _ = _cfgs(32, True)
    dirs = camera.unit_heading(_t(vel))
    shade, depth, winner = wireframe.wireframe_eye_plain(_t(pos), dirs, _t(pos), dirs, cfg)
    hit = depth < FAR
    assert torch.equal(winner >= 0, hit) and winner.max() < 24
    for e in range(24):
        for p in torch.nonzero(hit[e]).flatten().tolist():
            j = winner[e, p].item()
            s1, d1, w1 = render.eye_rows_wireframe(_t(pos[e:e + 1]), dirs[e:e + 1],
                                                   _t(pos[j:j + 1]), dirs[j:j + 1], cfg)
            assert d1[0, p] == depth[e, p] and s1[0, p] == shade[e, p] and w1[0, p] == 0


@pytest.mark.parametrize("route,n,w", [
    ("rasterq", 64, 64), ("streaming", 48, 64), ("compact", 16, 512),
])
@pytest.mark.parametrize("aa", [False, True])
def test_wireframe_matches_jax_pallas_routes(route, n, w, aa):
    """The JAX package's Pallas wireframe kernels, run in interpret mode as
    its own suite runs them: rasterq (the default narrow-row route),
    streaming (force_streaming) and compact (wide rows)."""
    pos, vel = _arrays(n, 200 + n)
    cfg, jcfg = _cfgs(w, aa)
    want = jwireframe.render_rows_wireframe_tiled(
        jnp.asarray(pos), jnp.asarray(vel), jcfg, force_streaming=route == "streaming",
        force_compact=route == "compact")
    got = wireframe.render_rows_wireframe_tiled(_t(pos), _t(vel), cfg)
    _assert_rows_close(got, want, flip_frac=0.0 if route == "streaming" else 1e-3)


def test_wireframe_batch_chunking_and_cross_render():
    """A batch of envs equals a loop over envs, eye chunks change no value,
    cross renders against disjoint target blocks depth-merge into the full
    render, and the cross render equals the JAX package's."""
    pos, vel = _arrays(30, 8, batch=(3,))
    cfg, jcfg = _cfgs(40, True)
    whole = wireframe.render_rows_wireframe_tiled(_t(pos), _t(vel), cfg)
    torch.testing.assert_close(render.render_rows(_t(pos), _t(vel), cfg, chunk=7), whole,
                               rtol=0, atol=0)
    for i in range(3):
        one = render.render_rows(_t(pos[i]), _t(vel[i]), cfg)
        torch.testing.assert_close((whole[0][i], whole[1][i]), one, rtol=0, atol=0)
    p, v = _t(pos[0]), _t(vel[0])
    a = wireframe.render_rows_wireframe_tiled(p, v, cfg, targets=p[:13], target_vel=v[:13])
    b = wireframe.render_rows_wireframe_tiled(p, v, cfg, targets=p[13:], target_vel=v[13:])
    torch.testing.assert_close(render.merge_rows(a, b), (whole[0][0], whole[1][0]),
                               rtol=0, atol=0)
    tgt, tvel = _arrays(50, 9)
    want = jrender.render_rows(jnp.asarray(pos[0]), jnp.asarray(vel[0]), jcfg,
                               targets=jnp.asarray(tgt), target_vel=jnp.asarray(tvel))
    _assert_rows_close(wireframe.render_rows_wireframe_tiled(p, v, cfg, targets=_t(tgt),
                                                             target_vel=_t(tvel)), want)


def test_wireframe_argument_checks():
    pos, vel = _arrays(8, 1)
    cfg, _ = _cfgs(16)
    for fn in (wireframe.render_rows_wireframe_tiled, render.render_rows):
        with pytest.raises(ValueError, match="target_vel"):
            fn(_t(pos), _t(vel), cfg, targets=_t(pos))
    with pytest.raises(ValueError, match="wireframe"):
        wireframe.render_rows_wireframe_tiled(_t(pos), _t(vel), VisionConfig(width=16))
    with pytest.raises(ValueError, match="CUDA kernel"):
        wireframe.wireframe_eye_with_winner(_t(pos), _t(vel), _t(pos), _t(vel), cfg)
    with pytest.raises(ValueError):
        common.use_kernel(torch.zeros(2, 2, device="meta"))


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_scene_observe_wireframe_matches_jax(backend):
    """Scene routes sprite_mode='wireframe' on either backend (the kernel
    route at any width, no fallback to dense) and agrees with the JAX
    Scene's dense route, batched and unbatched, and with the JAX Scene of
    the same backend (its Pallas backend is the rasterq route: near-tie
    flips allowed)."""
    pos, vel = _arrays(40, 12, batch=(2,))
    cfg, jcfg = _cfgs(64, True)
    kw = dict(n=40, controller="boids")
    jdense = JScene(JSimConfig(**kw, backend="dense", vision=jcfg))
    jscene = JScene(JSimConfig(**kw, backend=backend, vision=jcfg))
    scene = Scene(SimConfig(**kw, backend=backend, vision=cfg), device="cpu")
    jst = jstate.spawn_batch(jax.random.key(0), jscene.cfg, 2).replace(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    st = SceneState(pos=_t(pos), vel=_t(vel), t=torch.zeros(2, dtype=torch.int32))
    _assert_rows_close(scene.observe_with_depth(st), jdense.observe_with_depth(jst))
    _assert_rows_close(scene.observe_with_depth(st), jscene.observe_with_depth(jst),
                       flip_frac=0.0 if backend == "dense" else 1e-3)
    st0 = SceneState(pos=st.pos[0], vel=st.vel[0], t=st.t[0])
    jst0 = jax.tree_util.tree_map(lambda x: x[0], jst)
    np.testing.assert_allclose(scene.observe(st0).numpy(), np.asarray(jdense.observe(jst0)),
                               rtol=1e-5, atol=2e-4)
    _, traj = scene.rollout(st, 2, record=("obs",))
    assert traj["obs"].shape == (2, 2, 40, 64) and torch.isfinite(traj["obs"]).all()


def _entry_points():
    cfg = SimConfig(n=8, controller="gravity", vision=VisionConfig(width=8))
    env = VisionEnv(cfg)
    gen = torch.Generator()
    return {
        "Scene": (Scene, lambda: Scene(cfg)),
        "spawn": (tstate.spawn, lambda: tstate.spawn(cfg, gen)),
        "spawn_batch": (tstate.spawn_batch, lambda: tstate.spawn_batch(cfg, gen, 2)),
        "init_train_state": (train.init_train_state, lambda: train.init_train_state(env, 2)),
        "init_apg_state": (apg.init_apg_state, lambda: apg.init_apg_state(env)),
        "init_ppo_state": (ppo.init_ppo_state, lambda: ppo.init_ppo_state(env)),
        "init_ac_state": (ac.init_ac_state, lambda: ac.init_ac_state(env, 2)),
        "init_es_state": (es.init_es_state, lambda: es.init_es_state(env)),
        "init_recurrent_train_state": (train.init_recurrent_train_state,
                                       lambda: train.init_recurrent_train_state(env, 2)),
    }


@pytest.mark.parametrize("name", ["Scene", "spawn", "spawn_batch", "init_train_state",
                                  "init_apg_state", "init_ppo_state", "init_ac_state",
                                  "init_es_state", "init_recurrent_train_state"])
def test_entry_points_default_to_the_card(name):
    """Without a device argument the entry points target cuda; on a
    machine without a GPU they raise and do not fall back to the CPU."""
    fn, call = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        call()
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            call()


@pytest.mark.parametrize("algo,aa", [("reinforce", False), ("apg", True)])
def test_wireframe_train_cli_runs_on_cpu(capsys, algo, aa):
    argv = ["train", "--algo", algo, "--device", "cpu", "--sprite-mode", "wireframe",
            "--envs", "2", "--agents", "12", "--vision-width", "16", "--horizon", "3",
            "--iters", "2"] + (["--antialias"] if aa else [])
    assert cli.main(argv) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["iter"] for r in lines] == [0, 1]
    for row in lines:
        assert row["agent_frames"] == 2 * 12 * 3
        assert all(np.isfinite(v) for v in row.values())
    env = cli._train_env(_Args(sprite_mode="wireframe", antialias=aa))
    assert env.cfg.vision.sprite_mode == "wireframe" and env.cfg.vision.antialias == aa


@dataclasses.dataclass
class _Args:
    agents: int = 12
    vision_width: int = 16
    sprite_mode: str = "disc"
    antialias: bool = False
