"""The port's eye ring (nenbody_tpu_torch.parallel.ring.ring_render_rows,
both sprites) against the JAX package's ring on the suite's virtual CPU
devices and the dense oracle, on shared numpy inputs, and the hop order on
an exact depth tie. Its gradients are in test_torch_ring_grad.py.

The port runs on a mesh that repeats the CPU device 4 times. Tolerances:
tests/test_sharding.py's depth rtol 1e-5 / atol 1e-4 and disc shade
rtol 1e-5 / atol 1e-5; wireframe and antialiased shade atol 2e-4
(tests/test_torch_wireframe.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu.parallel import mesh as jmesh
from nenbody_tpu.parallel import ring as jring

from nenbody_tpu_torch import VisionConfig
from nenbody_tpu_torch.parallel import make_mesh, ring
from nenbody_tpu_torch.vision import render

torch.set_num_threads(1)

CPU = torch.device("cpu")
DEPTH_TOL = dict(rtol=1e-5, atol=1e-4)
SHADE_TOL = {"disc": dict(rtol=1e-5, atol=1e-5), "wireframe": dict(rtol=1e-5, atol=2e-4)}
FAR = 200.0  # the JAX wireframe suite's


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh({"agents": 4}, devices=[CPU] * 4)


@pytest.fixture(scope="module")
def jmesh4():
    return jmesh.make_mesh({"agents": 4}, devices=jax.devices()[:4])


def _arrays(n, seed, batch=(), spread=40.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-spread, spread, batch + (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, batch + (n, 2)).astype(np.float32)
    return pos, vel


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("sprite,n,aa", [
    ("disc", 64, False), ("disc", 37, True), ("wireframe", 64, False), ("wireframe", 9, True),
])
def test_ring_render_rows_matches_jax_ring_and_dense(mesh4, jmesh4, sprite, n, aa):
    pos, vel = _arrays(n, 3 * n)
    kw = dict(width=32, sprite_mode=sprite, antialias=aa, far=FAR)
    vcfg, jvcfg = VisionConfig(**kw), JVisionConfig(**kw)
    got = ring.ring_render_rows(_t(pos), _t(vel), vcfg, mesh=mesh4)
    want = jring.ring_render_rows(jnp.asarray(pos), jnp.asarray(vel), jvcfg, mesh=jmesh4)
    assert got[0].shape == (n, 32)
    shade_tol = SHADE_TOL["wireframe"] if aa else SHADE_TOL[sprite]
    _close(got[1], want[1], DEPTH_TOL)
    _close(got[0], want[0], shade_tol)
    for g, w in zip(got, render.render_rows(_t(pos), _t(vel), vcfg)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)  # the same plain partials, merged
    assert (got[1] < FAR).float().mean() > 0.02  # sprites are seen


def _tie_scene():
    """The wireframe tie of tests/test_torch_wireframe.py: two sprites at (10, 0),
    turned to +x and -x, meet at depth 9 on the centre pixel of an odd
    width (the first's edge 2, the second's edge 0). Eye = agent 4 (shard 2
    of 4); the sprites are agents 2 (shard 1) and 6 (shard 3); the rest sit
    behind the eye. The dense render gives the pixel to the lower edge
    (agent 6); the ring keeps the earlier hop's fragment on a tie, and shard
    2 meets block 1 at hop 1 and block 3 at hop 3, so agent 2 wins there
    (the other direction round the ring would give agent 6)."""
    pos = np.array([[-50.0, 30.0 + 9 * k] for k in range(8)], np.float32)
    vel = np.tile(np.array([[0.0, 1.0]], np.float32), (8, 1))
    pos[4], vel[4] = (0.0, 0.0), (1.0, 0.0)
    pos[2], vel[2] = (10.0, 0.0), (1.0, 0.0)
    pos[6], vel[6] = (10.0, 0.0), (-1.0, 0.0)
    return pos, vel


def test_ring_hop_order_decides_an_exact_depth_tie_as_jax(mesh4, jmesh4):
    pos, vel = _tie_scene()
    kw = dict(width=17, sprite_mode="wireframe", far=FAR)
    got = ring.ring_render_rows(_t(pos), _t(vel), VisionConfig(**kw), mesh=mesh4)
    want = jring.ring_render_rows(jnp.asarray(pos), jnp.asarray(vel), JVisionConfig(**kw),
                                  mesh=jmesh4)
    dense_rows = render.render_rows(_t(pos), _t(vel), VisionConfig(**kw))
    assert got[1][4, 8].item() == 9.0 == dense_rows[1][4, 8].item()
    assert abs(dense_rows[0][4, 8].item() - 0.5) < 1e-6  # agent 6's edge 0
    assert abs(got[0][4, 8].item() - dense_rows[0][4, 8].item()) > 0.1  # agent 2 won
    _close(got[0], want[0], SHADE_TOL["wireframe"])
    _close(got[1], want[1], DEPTH_TOL)
