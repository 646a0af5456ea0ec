"""The port's physics (nenbody_tpu_torch.physics.dense and the plain versions
of the gravity and boids kernels in nenbody_tpu_torch.ops) against the JAX
package's dense oracle and its Pallas kernels in interpret mode, on shared
numpy inputs made from a seed.

Tolerances are the JAX suite's between its Pallas kernels and its dense
oracle (tests/test_kernels.py): rtol 3e-5 with atol 1e-7 (gravity) or 1e-6
(boids) — fp32 sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import spawn as jspawn
from nenbody_tpu import state as jstate
from nenbody_tpu.config import BoidsConfig as JBoidsConfig
from nenbody_tpu.config import GravityConfig as JGravityConfig
from nenbody_tpu.ops import boids as jboids
from nenbody_tpu.ops import pairwise as jpairwise
from nenbody_tpu.physics import dense as jdense

from nenbody_tpu_torch import SceneState, SimConfig, VisionConfig, heading, model_matrices, spawn
from nenbody_tpu_torch.config import BoidsConfig, GravityConfig
from nenbody_tpu_torch.ops import boids as tboids
from nenbody_tpu_torch.ops import common, pairwise, raycast, tiled, wireframe
from nenbody_tpu_torch.physics import dense
from nenbody_tpu_torch.vision import render
from oracle import boids_step_np, gravity_step_np

torch.set_num_threads(1)

G_TOL = dict(rtol=3e-5, atol=1e-7)
B_TOL = dict(rtol=3e-5, atol=1e-6)


def _arrays(n, seed, lo=-100.0, hi=100.0, vlo=-1.0, vhi=1.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    vel = rng.uniform(vlo, vhi, (n, 2)).astype(np.float32)
    return pos, vel


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _jstate(pos, vel):
    return jstate.SceneState(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel), key=jax.random.key(0), t=jnp.int32(0)
    )


def _tstate(pos, vel):
    return SceneState(pos=_t(pos), vel=_t(vel), t=torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("n", [16, 257, 1000])
def test_gravity_matches_jax_dense_and_pallas(n):
    pos, _ = _arrays(n, n)
    want_dense = np.asarray(jdense.gravity_forces(jnp.asarray(pos), JGravityConfig()))
    want_pallas = np.asarray(jpairwise.gravity_forces_tiled(jnp.asarray(pos), JGravityConfig()))
    got_dense = dense.gravity_forces(_t(pos), GravityConfig()).numpy()
    got_plain = pairwise.gravity_forces_tiled(_t(pos), GravityConfig()).numpy()
    np.testing.assert_allclose(got_dense, want_dense, **G_TOL)
    np.testing.assert_allclose(got_plain, want_pallas, **G_TOL)
    np.testing.assert_allclose(got_plain, want_dense, **G_TOL)


def test_gravity_cross_form_matches_jax():
    pi, _ = _arrays(40, 1)
    pj, _ = _arrays(70, 2)
    want = np.asarray(jpairwise.gravity_forces_tiled(
        jnp.asarray(pi), JGravityConfig(), pos_j=jnp.asarray(pj)))
    got = pairwise.gravity_forces_tiled(_t(pi), GravityConfig(), _t(pj)).numpy()
    np.testing.assert_allclose(got, want, **G_TOL)
    np.testing.assert_allclose(
        dense.gravity_forces_cross(_t(pi), _t(pj), GravityConfig()).numpy(),
        np.asarray(jdense.gravity_forces_cross(jnp.asarray(pi), jnp.asarray(pj), JGravityConfig())),
        **G_TOL,
    )


@pytest.mark.parametrize("n", [16, 257, 1000])
@pytest.mark.parametrize("global_alignment", [False, True])
def test_boids_matches_jax_dense_and_pallas(n, global_alignment):
    pos, vel = _arrays(n, n + 7, -30, 30)  # dense enough that every rule fires
    jcfg = JBoidsConfig(global_alignment=global_alignment)
    tcfg = BoidsConfig(global_alignment=global_alignment)
    want_pallas = np.asarray(jboids.boids_velocity_tiled(jnp.asarray(pos), jnp.asarray(vel), jcfg))
    want_dense = np.asarray(jdense.boids_accels(jnp.asarray(pos), jnp.asarray(vel), jcfg))
    got_plain = tboids.boids_velocity_tiled(_t(pos), _t(vel), tcfg).numpy()
    got_dense = dense.boids_accels(_t(pos), _t(vel), tcfg).numpy()
    np.testing.assert_allclose(got_plain, want_pallas, **B_TOL)
    np.testing.assert_allclose(got_plain, want_dense, **B_TOL)
    np.testing.assert_allclose(got_dense, want_dense, **B_TOL)


def test_boids_clustered_positions():
    """All three rule masks fire, separation included (test_kernels.py:76)."""
    pos, vel = _arrays(128, 0, -8, 8)
    want = np.asarray(jdense.boids_accels(jnp.asarray(pos), jnp.asarray(vel), JBoidsConfig()))
    got = tboids.boids_velocity_tiled(_t(pos), _t(vel), BoidsConfig()).numpy()
    np.testing.assert_allclose(got, want, **B_TOL)


@pytest.mark.parametrize("exclude", [True, False])
def test_boids_partials_match_jax(exclude):
    pi, vi = _arrays(32, 3, -10, 10)
    pj, vj = (pi, vi) if exclude else _arrays(48, 4, -10, 10)
    want = jdense.boids_partials_cross(
        jnp.asarray(pi), jnp.asarray(vi), jnp.asarray(pj), jnp.asarray(vj),
        JBoidsConfig(), exclude_diagonal=exclude,
    )
    got = dense.boids_partials_cross(
        _t(pi), _t(vi), _t(pj), _t(vj), BoidsConfig(), exclude_diagonal=exclude
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-5, atol=1e-5)


def test_boids_threshold_edge_cases():
    """Agents straddling the separation threshold (d=5) and identical
    velocities (alignment always matches), as test_physics_parity.py."""
    pos = np.array([[0.0, 0.0], [4.9, 0.0], [5.1, 0.0]], np.float32)
    vel = np.zeros((3, 2), np.float32)
    cfg = JSimConfig(n=3, controller="boids", backend="dense")
    want = jdense.boids_step(_jstate(pos, vel), cfg)
    got = dense.boids_step(_tstate(pos, vel), SimConfig(n=3, controller="boids"))
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("controller", ["gravity", "boids"])
@pytest.mark.parametrize("dt_on_position", [False, True])
def test_steps_match_jax(controller, dt_on_position):
    pos, vel = _arrays(200, 3)
    kw = dict(n=200, controller=controller)
    jcfg = JSimConfig(**kw, gravity=JGravityConfig(dt_on_position=dt_on_position))
    tcfg = SimConfig(**kw, gravity=GravityConfig(dt_on_position=dt_on_position))
    want = jdense.STEPPERS[controller](_jstate(pos, vel), jcfg)
    for stepper in (dense.STEPPERS[controller], tiled.STEPPERS[controller]):
        got = stepper(_tstate(pos, vel), tcfg)
        np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), rtol=3e-5, atol=1e-5)
        np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel), rtol=3e-5, atol=1e-6)
        assert int(got.t) == 1


def test_clamp_speed_matches_jax():
    _, vel = _arrays(500, 5, vlo=-3, vhi=3)
    want = np.asarray(jdense.clamp_speed(jnp.asarray(vel), 1.0))
    np.testing.assert_allclose(dense.clamp_speed(_t(vel), 1.0).numpy(), want, rtol=1e-6, atol=1e-7)


def test_plain_versions_chunk_exactly(monkeypatch):
    """The plain versions chunk over i for large N; a chunk boundary must not
    move the self-exclusion diagonal or change a value."""
    pos, vel = _arrays(300, 9, -20, 20)
    pb = np.stack([pos, pos[::-1].copy()])
    vb = np.stack([vel, vel[::-1].copy()])
    whole_g = pairwise.gravity_forces_plain(_t(pb), GravityConfig())
    whole_b = tboids.boids_velocity_plain(_t(pb), _t(vb), BoidsConfig())
    monkeypatch.setattr(pairwise, "PLAIN_PAIR_BUDGET", 2 * 300 * 37)
    monkeypatch.setattr(tboids, "PLAIN_PAIR_BUDGET", 2 * 300 * 37)
    torch.testing.assert_close(pairwise.gravity_forces_plain(_t(pb), GravityConfig()),
                               whole_g, rtol=0, atol=0)
    torch.testing.assert_close(tboids.boids_velocity_plain(_t(pb), _t(vb), BoidsConfig()),
                               whole_b, rtol=0, atol=0)


def test_batched_plain_matches_per_env():
    pos, vel = _arrays(3 * 50, 11, -15, 15)
    pb, vb = _t(pos.reshape(3, 50, 2)), _t(vel.reshape(3, 50, 2))
    g = pairwise.gravity_forces_tiled(pb, GravityConfig())
    b = tboids.boids_velocity_tiled(pb, vb, BoidsConfig(global_alignment=True))
    for i in range(3):
        torch.testing.assert_close(g[i], pairwise.gravity_forces_tiled(pb[i], GravityConfig()))
        torch.testing.assert_close(
            b[i], tboids.boids_velocity_tiled(pb[i], vb[i], BoidsConfig(global_alignment=True)))


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers never touch the kernel library, count no
    launch, and stay differentiable by autograd; the eyes too, with their
    appearance forms (per-target albedo, a texture)."""
    common.reset_launch_counts()
    pos, vel = _arrays(64, 2, -1, 1)  # clustered: forces and their slopes are large
    p = _t(pos).requires_grad_()
    g = pairwise.gravity_forces_tiled(p, GravityConfig())
    tboids.boids_velocity_tiled(_t(pos), _t(vel), BoidsConfig())
    albedo, texture = torch.rand(64), render.checker_texture(8, 2)
    for sprite, rows in (("disc", raycast.render_rows_tiled),
                         ("wireframe", wireframe.render_rows_wireframe_tiled)):
        shade, _ = rows(_t(pos), _t(vel), VisionConfig(width=16, sprite_mode=sprite),
                        albedo=albedo, texture=texture)
        assert torch.isfinite(shade).all()
    assert common.launch_counts() == {"gravity": 0, "boids": 0, "disc_eye": 0,
                                      "gravity_vjp": 0, "disc_eye_bwd": 0, "wireframe_eye": 0,
                                      "boids_partials": 0, "wireframe_eye_bwd": 0,
                                      "rdma_gravity": 0, "rdma_boids": 0, "rdma_vision": 0}
    (g * g).sum().backward()
    assert common.launch_counts()["gravity_vjp"] == 0
    assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0
    with pytest.raises(ValueError):
        common.use_kernel(torch.zeros(2, 2, device="meta"))


def test_random_walk_statistics():
    """Kicks are U(-accel, accel) per axis and the position integrates the
    velocity without dt (src/main.rs:381-402); the streams of torch and
    jax.random differ, so compare by statistics (test_physics_parity.py)."""
    cfg = SimConfig(n=4096, controller="random")
    gen = torch.Generator().manual_seed(7)
    state = spawn(cfg, gen, "cpu")
    out = dense.random_step(state, cfg, generator=gen)
    kick = (out.vel - state.vel).numpy()
    a = cfg.random_walk.accel
    assert kick.max() <= a and kick.min() >= -a
    assert abs(kick.mean()) < a / 10
    np.testing.assert_allclose(out.pos.numpy(), (state.pos + out.vel).numpy(), rtol=1e-6)
    out2 = dense.random_step(out, cfg, generator=gen)
    assert not np.allclose((out2.vel - out.vel).numpy(), kick)
    # the same moments as the JAX stepper's kicks
    jst = jspawn(jax.random.key(7), JSimConfig(n=4096, controller="random"))
    jkick = np.asarray(jdense.random_step(jst, JSimConfig(n=4096, controller="random")).vel - jst.vel)
    assert abs(kick.std() - jkick.std()) < 0.05 * jkick.std()


def test_spawn_distribution_matches_jax():
    cfg = SimConfig(n=4096)
    st = spawn(cfg, torch.Generator().manual_seed(0), "cpu")
    jst = jspawn(jax.random.key(0), JSimConfig(n=4096))
    pos, vel = st.pos.numpy(), st.vel.numpy()
    jpos, jvel = np.asarray(jst.pos), np.asarray(jst.vel)
    assert pos.dtype == np.float32 and st.pos.shape == (4096, 2) and int(st.t) == 0
    assert pos.min() >= -100 and pos.max() <= 100 and vel.min() >= 0 and vel.max() <= 0.1
    for a, b, scale in ((pos, jpos, 100.0), (vel, jvel, 0.1)):
        assert abs(a.mean() - b.mean()) < 0.05 * scale
        assert abs(a.std() - b.std()) < 0.05 * scale
    # seeded: the same seed gives the same spawn
    st2 = spawn(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(st.pos, st2.pos)


def test_heading_and_model_matrices_match_jax():
    pos, vel = _arrays(50, 12)
    vel[0] = 0.0  # zero velocity faces +x
    jst = _jstate(pos, vel)
    np.testing.assert_allclose(heading(_t(vel)).numpy(), np.asarray(jstate.heading(jnp.asarray(vel))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(model_matrices(_tstate(pos, vel)).numpy(),
                               np.asarray(jstate.model_matrices(jst)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [4, 64, 256])
@pytest.mark.parametrize("controller", ["gravity", "boids"])
def test_dense_steps_match_numpy_oracle(controller, n):
    """The port's dense steppers against the loop-for-loop NumPy
    transcription of the reference (tests/oracle.py), on a spawn of the
    port's own, at test_physics_parity.py's tolerances."""
    cfg = SimConfig(n=n, controller=controller)
    state = spawn(cfg, torch.Generator().manual_seed(n), "cpu")
    oracle = gravity_step_np if controller == "gravity" else boids_step_np
    ref_pos, ref_vel = oracle(state.pos.numpy(), state.vel.numpy())
    out = dense.STEPPERS[controller](state, cfg)
    np.testing.assert_allclose(out.vel.numpy(), ref_vel, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(out.pos.numpy(), ref_pos, rtol=2e-5, atol=1e-5)


def test_dense_gravity_multistep_stays_close_to_oracle():
    cfg = SimConfig(n=64, controller="gravity")
    state = spawn(cfg, torch.Generator().manual_seed(3), "cpu")
    pos, vel = state.pos.numpy(), state.vel.numpy()
    for _ in range(5):
        state = dense.gravity_step(state, cfg)
        pos, vel = gravity_step_np(pos, vel)
    np.testing.assert_allclose(state.pos.numpy(), pos, rtol=1e-4, atol=1e-4)
