"""The port's cell-list boids backend (nenbody_tpu_torch.physics.cells)
against the JAX package's (nenbody_tpu.physics.cells) and the dense
oracle, on shared numpy inputs made from a seed, on the CPU (the cases of
tests/test_cells.py, each held against the JAX module as well).

- the bucket hash equals the JAX `_bucket_hash` bit for bit, negative and
  int32-extreme cell coordinates included (uint32 wrap-around);
- neighbor_candidates (indices and validity) and cells_stats are equal;
- boids_velocity_cells is within test_cells.py's tolerance (rtol 1e-5,
  atol 1e-5) of the JAX module and of dense.boids_accels, batched too;
- the agent chunks (CELLS_PAIR_BUDGET) change no bit.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu.config import BoidsConfig as JBoidsConfig
from nenbody_tpu.physics import cells as jcells

from nenbody_tpu_torch import Scene, SimConfig
from nenbody_tpu_torch.config import BoidsConfig
from nenbody_tpu_torch.physics import cells, dense

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
R_POS = math.sqrt(BoidsConfig().cohesion_dist_sq)


def _sparse_scene(seed, n, spread=2000.0, vspread=1.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-spread, spread, (n, 2)).astype(np.float32),
            rng.uniform(-vspread, vspread, (n, 2)).astype(np.float32))


def _both(pos, vel, capacity=None, **cfg):
    """(port, JAX, dense) velocities of one config on shared arrays."""
    got = cells.boids_velocity_cells(torch.tensor(pos), torch.tensor(vel), BoidsConfig(**cfg),
                                     capacity=capacity).numpy()
    want = np.asarray(jcells.boids_velocity_cells(jnp.asarray(pos), jnp.asarray(vel),
                                                  JBoidsConfig(**cfg), capacity=capacity))
    plain = dense.boids_accels(torch.tensor(pos), torch.tensor(vel), BoidsConfig(**cfg)).numpy()
    return got, want, plain


@pytest.mark.parametrize("table", [64, 1024, 1 << 16])
def test_bucket_hash_is_the_jax_hash_bit_for_bit(table):
    rng = np.random.default_rng(table)
    edge = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 2, -2 ** 31 + 1, 65535, -65536],
                    np.int32)
    cx = np.concatenate([edge, np.repeat(edge, len(edge)),
                         rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=np.int64).astype(np.int32)])
    cy = np.concatenate([edge[::-1], np.tile(edge, len(edge)),
                         rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=np.int64).astype(np.int32)])
    got = cells._bucket_hash(torch.tensor(cx), torch.tensor(cy), table)
    want = np.asarray(jcells._bucket_hash(jnp.asarray(cx), jnp.asarray(cy), table))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert cells._auto_table_size(table) == jcells._auto_table_size(table)


@pytest.mark.parametrize("spread,capacity", [(2000.0, 8), (120.0, 40), (40.0, 4)],
                         ids=["sparse", "dense", "overflow"])
def test_candidates_and_stats_equal_jax(spread, capacity):
    pos, _ = _sparse_scene(int(spread), 600, spread=spread)
    for table in (None, 256):
        got = cells.neighbor_candidates(torch.tensor(pos), R_POS, capacity, table)
        want = jcells.neighbor_candidates(jnp.asarray(pos), R_POS, capacity, table)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (cells.cells_stats(torch.tensor(pos), R_POS, table)
                == jcells.cells_stats(jnp.asarray(pos), R_POS, table))


def test_matches_dense_sparse():
    got, want, plain = _both(*_sparse_scene(0, 512))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


def test_velocity_space_alignment_exact():
    """A small alignment radius makes rule 3 non-trivial: the v-space cell
    list must reproduce the dense velocity-space mask."""
    pos, vel = _sparse_scene(1, 400, vspread=0.8)
    vd2 = np.sum((vel[None] - vel[:, None]) ** 2, axis=-1)
    assert 0 < (vd2 < 0.3 ** 2).sum() < 400 * 399
    got, want, plain = _both(pos, vel, alignment_dist=0.3)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


def test_global_alignment_identity():
    got, want, plain = _both(*_sparse_scene(2, 300, vspread=0.5), global_alignment=True)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


def test_dense_cluster_exact_with_sized_capacity():
    """At higher density the default capacity overflows; sizing it from
    cells_stats restores exactness."""
    pos, vel = _sparse_scene(3, 600, spread=120.0)
    k = cells.cells_stats(torch.tensor(pos), R_POS)["max_occupancy"]
    got, want, plain = _both(pos, vel, capacity=k)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


def test_overflow_detected_by_stats():
    pos, vel = _sparse_scene(4, 600, spread=40.0)
    assert cells.cells_stats(torch.tensor(pos), R_POS)["max_occupancy"] > 4
    got, want, plain = _both(pos, vel, capacity=4)
    np.testing.assert_allclose(got, want, **TOL)  # the same overflow as the JAX module
    assert not np.allclose(got, plain, **TOL)


def test_batched_matches_dense():
    pos = np.stack([_sparse_scene(10 + i, 128)[0] for i in range(3)])
    vel = np.stack([_sparse_scene(20 + i, 128)[1] for i in range(3)])
    got, want, plain = _both(pos, vel)
    assert got.shape == (3, 128, 2)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("alignment_dist", [500.0, 0.3])
def test_agent_chunks_change_no_bit(monkeypatch, alignment_dist):
    pos, vel = _sparse_scene(5, 300, spread=150.0, vspread=0.8)
    cfg = BoidsConfig(alignment_dist=alignment_dist)
    k = cells.cells_stats(torch.tensor(pos), R_POS)["max_occupancy"]
    whole = cells.boids_velocity_cells(torch.tensor(pos), torch.tensor(vel), cfg, capacity=k)
    monkeypatch.setattr(cells, "CELLS_PAIR_BUDGET", 9 * k * 37)  # chunks of 37 agents
    chunked = cells.boids_velocity_cells(torch.tensor(pos), torch.tensor(vel), cfg, capacity=k)
    assert torch.equal(whole, chunked)


def test_scene_backend_cells():
    cfg = SimConfig(n=256, controller="boids", backend="cells",
                    spawn_pos_range=(-1500.0, 1500.0))
    sc = Scene(cfg, device="cpu")
    sd = Scene(dataclasses.replace(cfg, backend="dense"), device="cpu")
    state = sc.spawn(seed=7)
    for _ in range(3):
        state_c, state_d = sc.step(state), sd.step(state)
        np.testing.assert_allclose(state_c.pos.numpy(), state_d.pos.numpy(), **TOL)
        np.testing.assert_allclose(state_c.vel.numpy(), state_d.vel.numpy(), **TOL)
        assert int(state_c.t) == int(state.t) + 1
        state = state_d


def test_scene_rejects_gravity_cells():
    with pytest.raises(ValueError, match="all-pairs"):
        Scene(SimConfig(n=64, controller="gravity", backend="cells"), device="cpu")


def test_scene_cells_random_and_vision():
    """The random walk steps on plain torch; vision renders on the kernel
    route (the plain versions on the CPU), as the dense backend renders."""
    from nenbody_tpu_torch import VisionConfig

    cfg = SimConfig(n=32, controller="random", backend="cells", vision=VisionConfig(width=16))
    sc = Scene(cfg, device="cpu")
    sd = Scene(dataclasses.replace(cfg, backend="dense"), device="cpu")
    a, _ = sc.rollout(sc.spawn(3), 2)
    b, _ = sd.rollout(sd.spawn(3), 2)
    assert torch.equal(a.pos, b.pos)
    torch.testing.assert_close(sc.observe(a), sd.observe(a), rtol=1e-5, atol=1e-5)
