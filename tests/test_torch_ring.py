"""The port's agent-axis ring physics (nenbody_tpu_torch.parallel: mesh,
ring, auto) against the JAX package's ring on the suite's virtual CPU
devices and against the dense single-device oracle, on shared numpy inputs;
the boids partials kernel's plain version against the JAX kernel in
interpret mode; the mesh helpers. The eyes' ring is in
test_torch_ring_vision.py, the Scene backends and trainers in
test_torch_ring_train.py.

The port runs on meshes that repeat the CPU device (4 for the agent axis,
2 x 4 for data x agents); on CUDA tensors the same code launches the kernels
(tests/test_torch_cuda_kernels.py, chip_smoke.py). Tolerances are
tests/test_sharding.py's: gravity rtol 3e-5 / atol 1e-7, boids rtol 3e-5 /
atol 1e-6; the raw partial sums, which cancel, atol 1e-6 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu.ops import boids as jboids
from nenbody_tpu.parallel import mesh as jmesh
from nenbody_tpu.parallel import ring as jring
from nenbody_tpu.physics import dense as jdense

from nenbody_tpu_torch import Scene, SimConfig, VisionConfig
from nenbody_tpu_torch.ops import boids as boids_ops
from nenbody_tpu_torch.ops import common
from nenbody_tpu_torch.parallel import auto, make_mesh, ring
from nenbody_tpu_torch.parallel import mesh as mesh_lib
from nenbody_tpu_torch.physics import dense
from nenbody_tpu_torch.vision import render

torch.set_num_threads(1)

CPU = torch.device("cpu")
GRAVITY_TOL = dict(rtol=3e-5, atol=1e-7)
BOIDS_TOL = dict(rtol=3e-5, atol=1e-6)
FAR = 200.0  # the JAX wireframe suite's


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh({"agents": 4}, devices=[CPU] * 4)


@pytest.fixture(scope="module")
def mesh2x4():
    return make_mesh({"data": 2, "agents": 4}, devices=[CPU] * 8)


@pytest.fixture(scope="module")
def jmesh4():
    return jmesh.make_mesh({"agents": 4}, devices=jax.devices()[:4])


def _arrays(n, seed, batch=(), spread=100.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-spread, spread, batch + (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, batch + (n, 2)).astype(np.float32)
    return pos, vel


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("n", [100, 37, 9])
def test_ring_gravity_matches_jax_ring_and_dense(mesh4, jmesh4, n):
    pos, _ = _arrays(n, n)
    cfg, jcfg = SimConfig(n=n, controller="gravity"), JSimConfig(n=n, controller="gravity")
    got = ring.ring_gravity_forces(_t(pos), cfg, mesh=mesh4)
    assert got.shape == (n, 2)
    _close(got, jring.ring_gravity_forces(jnp.asarray(pos), jcfg, mesh=jmesh4), GRAVITY_TOL)
    _close(got, dense.gravity_forces(_t(pos), cfg.gravity), GRAVITY_TOL)


@pytest.mark.parametrize("n", [100, 37, 9])
def test_ring_boids_matches_jax_ring_and_dense(mesh4, jmesh4, n):
    pos, vel = _arrays(n, n + 1, spread=20.0)  # clustered: every rule fires
    cfg, jcfg = SimConfig(n=n, controller="boids"), JSimConfig(n=n, controller="boids")
    got = ring.ring_boids_velocity(_t(pos), _t(vel), cfg, mesh=mesh4)
    _close(got, jring.ring_boids_velocity(jnp.asarray(pos), jnp.asarray(vel), jcfg,
                                          mesh=jmesh4), BOIDS_TOL)
    _close(got, dense.boids_accels(_t(pos), _t(vel), cfg.boids), BOIDS_TOL)


def test_ring_batched_with_data_axis(mesh2x4):
    """Envs over the data axis, agents over the ring axis (config 5's
    sharding, scaled down), against the per-env dense oracle."""
    pos, vel = _arrays(30, 5, batch=(4,), spread=20.0)
    cfg = SimConfig(n=30, controller="boids")
    g = ring.ring_gravity_forces(_t(pos), cfg, mesh=mesh2x4, data_axis="data")
    _close(g, dense.gravity_forces(_t(pos), cfg.gravity), GRAVITY_TOL)
    b = ring.ring_boids_velocity(_t(pos), _t(vel), cfg, mesh=mesh2x4, data_axis="data")
    _close(b, dense.boids_accels(_t(pos), _t(vel), cfg.boids), BOIDS_TOL)
    vcfg = VisionConfig(width=16, sprite_mode="wireframe", far=FAR)
    got = ring.ring_render_rows(_t(pos), _t(vel), vcfg, mesh=mesh2x4, data_axis="data")
    for g_, w in zip(got, render.render_rows(_t(pos), _t(vel), vcfg)):
        torch.testing.assert_close(g_, w, rtol=0, atol=0)


def test_ring_indivisible_env_batch_clear_error(mesh2x4):
    pos, _ = _arrays(8, 0, batch=(3,))
    with pytest.raises(ValueError, match="divide evenly"):
        ring.ring_gravity_forces(_t(pos), SimConfig(n=8), mesh=mesh2x4, data_axis="data")


@pytest.mark.parametrize("exclude_diagonal", [True, False])
def test_boids_partials_plain_matches_jax_kernel(exclude_diagonal):
    """#5's plain version against the Pallas `_boids_partials_kernel`
    (interpret mode), an aliased block with the diagonal masked or a cross
    block, and against a j-block padded with the ring's far sentinels."""
    pos, vel = _arrays(48, 7, spread=15.0)
    pj, vj = (pos, vel) if exclude_diagonal else _arrays(40, 8, spread=15.0)
    cfg, jcfg = SimConfig().boids, JSimConfig().boids
    got = boids_ops.boids_partials_tiled(_t(pos), _t(vel), _t(pj), _t(vj), cfg, exclude_diagonal)
    want = jboids.boids_partials_tiled(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(pj),
                                       jnp.asarray(vj), jcfg, exclude_diagonal=exclude_diagonal)
    for g, w in zip(got, want):  # the sums cancel: atol scaled by the largest
        _close(g, w, dict(rtol=3e-5, atol=1e-6 * max(1.0, np.abs(np.asarray(w)).max())))
    assert got[1].min() > 0 and got[4].min() > 0  # the rules fire
    pad = np.full((9, 2), 1e17, np.float32)
    padded = boids_ops.boids_partials_tiled(_t(pos), _t(vel), _t(np.concatenate([pj, pad])),
                                            _t(np.concatenate([vj, pad])), cfg, exclude_diagonal)
    for g, p in zip(got, padded):
        torch.testing.assert_close(p, g, rtol=0, atol=0)  # sentinels stay inert


@pytest.mark.parametrize("exclude_diagonal", [True, False])
def test_dense_boids_partials_cross_matches_jax_dense(exclude_diagonal):
    """physics.dense.boids_partials_cross masks the diagonal by index as the
    JAX dense form does (jnp.eye(n, m), nenbody_tpu/physics/dense.py:68),
    for a rectangular block too."""
    pos, vel = _arrays(30, 12, spread=15.0)
    pj, vj = _arrays(45, 13, spread=15.0)
    pj[:30], vj[:30] = pos, vel  # the first 30 of the j-block alias the i-block
    cfg, jcfg = SimConfig().boids, JSimConfig().boids
    got = dense.boids_partials_cross(_t(pos), _t(vel), _t(pj), _t(vj), cfg, exclude_diagonal)
    want = jdense.boids_partials_cross(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(pj),
                                       jnp.asarray(vj), jcfg, exclude_diagonal)
    for g, w in zip(got, want):
        _close(g, w, dict(rtol=3e-5, atol=1e-6 * max(1.0, np.abs(np.asarray(w)).max())))


def test_ring_boids_launches_its_partials_per_hop_on_cuda_only(mesh4):
    """On CPU tensors the ring runs the plain partials (no launch); the
    partials' wrapper raises for a device mix."""
    common.reset_launch_counts()
    pos, vel = _arrays(16, 2, spread=10.0)
    ring.ring_boids_velocity(_t(pos), _t(vel), SimConfig(n=16, controller="boids"), mesh=mesh4)
    assert all(c == 0 for c in common.launch_counts().values())
    with pytest.raises(ValueError):
        boids_ops.boids_partials_tiled(_t(pos), _t(vel), _t(pos).to("meta"), _t(vel),
                                       SimConfig().boids)


@pytest.mark.parametrize("controller", ["gravity", "boids"])
def test_gspmd_matches_dense_and_ring(mesh4, controller):
    pos, vel = _arrays(50, 11, spread=20.0)
    cfg = SimConfig(n=50, controller=controller)
    if controller == "gravity":
        got = auto.auto_gravity_forces(_t(pos), cfg, mesh=mesh4)
        _close(got, dense.gravity_forces(_t(pos), cfg.gravity), GRAVITY_TOL)
        _close(got, ring.ring_gravity_forces(_t(pos), cfg, mesh=mesh4), GRAVITY_TOL)
    else:
        got = auto.auto_boids_velocity(_t(pos), _t(vel), cfg, mesh=mesh4)
        _close(got, dense.boids_accels(_t(pos), _t(vel), cfg.boids), BOIDS_TOL)
        _close(got, ring.ring_boids_velocity(_t(pos), _t(vel), cfg, mesh=mesh4), BOIDS_TOL)


def test_mesh_helpers():
    m = make_mesh({"data": -1, "agents": 2}, devices=[CPU] * 8)
    assert m.shape == {"data": 4, "agents": 2}
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_mesh({"agents": 16}, devices=[CPU] * 8)
    assert mesh_lib.data_axis_of(m) == "data" and mesh_lib.agent_axis_of(m) == "agents"
    assert mesh_lib.data_axis_of(None) is None
    assert mesh_lib.data_axis_of(make_mesh(devices=[CPU] * 3)) is None
    assert mesh_lib.agent_axis_of(make_mesh({"data": 2}, devices=[CPU] * 2)) is None
    assert mesh_lib.shard_state_specs(batch=True, data_axis="data") == {
        "pos": ("data", "agents", None), "vel": ("data", "agents", None), "t": ("data",)}
    # split and gather a batched state, both layouts
    s = Scene(SimConfig(n=10), device="cpu").spawn_envs(4, seed=0)
    for mesh in (m, make_mesh({"data": 2}, devices=[CPU] * 2)):
        blocks = mesh_lib.place_state_on_mesh(s, mesh)
        assert len(blocks) == mesh.shape["data"]
        back = mesh_lib.gather_state(blocks, mesh, CPU)
        assert all(torch.equal(getattr(back, k), getattr(s, k)) for k in ("pos", "vel", "t"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
