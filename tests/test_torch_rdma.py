"""The port's RDMA ring (nenbody_tpu_torch.parallel.rdma) against the JAX
package's (nenbody_tpu.parallel.rdma: its Pallas kernels in interpret mode,
RDMA emulated, on the suite's virtual CPU devices), against the JAX dense
oracle and against the port's agent-axis ring (parallel.ring), on shared
numpy inputs. The port runs its plain versions here, on meshes that repeat
the CPU device; the kernel (csrc/rdma_ring.cu) is held against them on the
card (tests/test_torch_cuda_kernels.py, chip_smoke.py).

Tolerances are tests/test_rdma_ring.py's: gravity rtol 2e-5 / atol 1e-6,
boids rtol 3e-5 / atol 1e-5, rows rtol 1e-5 / atol 1e-4. The JAX vision
kernel runs on 2-hop meshes only: its interpret-mode compile grows with the
hops (test_rdma_ring.py:95-98).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu.parallel import mesh as jmesh
from nenbody_tpu.parallel import rdma as jrdma
from nenbody_tpu.physics import dense as jdense
from nenbody_tpu.vision import render as jrender

from nenbody_tpu_torch import SimConfig, VisionConfig
from nenbody_tpu_torch.ops import common
from nenbody_tpu_torch.parallel import make_mesh, rdma, ring
from nenbody_tpu_torch.vision import render

torch.set_num_threads(1)

CPU = torch.device("cpu")
GRAVITY_TOL = dict(rtol=2e-5, atol=1e-6)
BOIDS_TOL = dict(rtol=3e-5, atol=1e-5)
ROWS_TOL = dict(rtol=1e-5, atol=1e-4)


def _mesh(d):
    return make_mesh({"agents": d}, devices=[CPU] * d)


def _jmesh(d):
    return jmesh.make_mesh({"agents": d}, devices=jax.devices()[:d])


def _arrays(n, seed, batch=(), spread=100.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-spread, spread, batch + (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, batch + (n, 2)).astype(np.float32)
    return pos, vel


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# divisible N, sentinel-padded N, and an env batch (padded too), on 2-4 hops
CASES = [(64, 2, ()), (37, 3, ()), (30, 4, (3,))]


@pytest.mark.parametrize("n,d,batch", CASES)
def test_rdma_gravity_matches_jax_rdma_dense_and_ring(n, d, batch):
    pos, _ = _arrays(n, n, batch)
    cfg, jcfg = SimConfig(n=n, controller="gravity"), JSimConfig(n=n, controller="gravity")
    common.reset_launch_counts()
    got = rdma.rdma_ring_gravity_forces(_t(pos), cfg, mesh=_mesh(d))
    assert all(c == 0 for c in common.launch_counts().values())  # the plain version
    assert got.shape == batch + (n, 2)
    _close(got, jrdma.rdma_ring_gravity_forces(jnp.asarray(pos), jcfg, mesh=_jmesh(d)),
           GRAVITY_TOL)
    _close(got, jdense.gravity_forces(jnp.asarray(pos), jcfg.gravity), GRAVITY_TOL)
    _close(got, ring.ring_gravity_forces(_t(pos), cfg, mesh=_mesh(d)), GRAVITY_TOL)


@pytest.mark.parametrize("n,d,batch", CASES)
def test_rdma_boids_matches_jax_rdma_dense_and_ring(n, d, batch):
    """Against JAX dense and the port's ring on every mesh, and against the
    JAX RDMA kernel unbatched (its batched boids on 4 hops does not finish
    in interpret mode; test_rdma_ring.py keeps that case in the slow tier)."""
    pos, vel = _arrays(n, n + 1, batch, spread=20.0)  # clustered: every rule fires
    cfg, jcfg = SimConfig(n=n, controller="boids"), JSimConfig(n=n, controller="boids")
    got = rdma.rdma_ring_boids_velocity(_t(pos), _t(vel), cfg, mesh=_mesh(d))
    assert got.shape == batch + (n, 2)
    wants = [jdense.boids_accels(jnp.asarray(pos), jnp.asarray(vel), jcfg.boids),
             ring.ring_boids_velocity(_t(pos), _t(vel), cfg, mesh=_mesh(d))]
    if not batch:
        wants.append(jrdma.rdma_ring_boids_velocity(jnp.asarray(pos), jnp.asarray(vel), jcfg,
                                                    mesh=_jmesh(d)))
    for want in wants:
        _close(got, want, BOIDS_TOL)


@pytest.mark.parametrize("n,d,batch,width", [(48, 2, (), 16), (37, 3, (), 24), (30, 4, (2,), 16)])
def test_rdma_render_rows_matches_jax_dense_and_ring(n, d, batch, width):
    """Against JAX's dense renderer and the port's ring on every mesh, and
    against the JAX RDMA kernel on the 2-hop one."""
    pos, vel = _arrays(n, 3 * n, batch)
    vcfg, jvcfg = VisionConfig(width=width), JVisionConfig(width=width)
    got = rdma.rdma_ring_render_rows(_t(pos), _t(vel), vcfg, mesh=_mesh(d))
    assert got[0].shape == batch + (n, width)
    assert (got[1] < vcfg.far).float().mean() > 0.05  # sprites are seen
    jdense_rows = (jax.vmap(lambda p, v: jrender.render_rows(p, v, jvcfg)) if batch
                   else lambda p, v: jrender.render_rows(p, v, jvcfg))
    wants = [jdense_rows(jnp.asarray(pos), jnp.asarray(vel)),
             ring.ring_render_rows(_t(pos), _t(vel), vcfg, mesh=_mesh(d))]
    if d == 2:
        wants.append(jrdma.rdma_ring_render_rows(jnp.asarray(pos), jnp.asarray(vel), jvcfg,
                                                 mesh=_jmesh(2)))
    for want in wants:
        _close(got[1], want[1], ROWS_TOL)
        _close(got[0], want[0], ROWS_TOL)


def _tie_scene():
    """512 agents on 2 shards (256 each, as the JAX kernel pads them too);
    every agent sits at x = -50, behind the two eyes, except:
    eye 300 (shard 1) at (0, 0) looking along +x sees agent 400 (its own
    block, hop 0) at (10, 0.5) and agent 100 (block 0, hop 1) at (10, 0):
    an exact depth tie on the centre pixel of 17, where agent 100 covers the
    pixel's centre (off^2 = 0) and agent 400 its side (off^2 = 0.25);
    eye 301 at (0, 100) sees agents 150 at (10, 100.5) and 200 at (10, 100),
    both in block 0 (hop 1), the same tie within one hop."""
    pos = np.stack([np.full(512, -50.0), np.linspace(-300.0, 300.0, 512)], -1).astype(np.float32)
    vel = np.tile(np.array([[0.0, 1.0]], np.float32), (512, 1))
    for i, (x, y) in {300: (0, 0), 400: (10, 0.5), 100: (10, 0),
                      301: (0, 100), 150: (10, 100.5), 200: (10, 100)}.items():
        pos[i] = (x, y)
    vel[300] = vel[301] = (1.0, 0.0)
    return pos, vel


def test_rdma_tie_rule_within_and_across_hops_as_jax():
    """The JAX RDMA kernel's tie rule: across hops the earlier hop keeps an
    exact depth tie (eye 300 keeps agent 400, off^2 = 0.25, shade 0.9375,
    as the port's ring does, though agent 100 covers the pixel's centre);
    within a hop the least off^2 wins (eye 301 gets agent 200, shade 1.0,
    where the dense renderer and the ring take the lower index, agent 150)."""
    pos, vel = _tie_scene()
    kw = dict(width=17)
    got = rdma.rdma_ring_render_rows(_t(pos), _t(vel), VisionConfig(**kw), mesh=_mesh(2))
    want = jrdma.rdma_ring_render_rows(jnp.asarray(pos), jnp.asarray(vel), JVisionConfig(**kw),
                                       mesh=_jmesh(2))
    _close(got[1], want[1], ROWS_TOL)
    _close(got[0], want[0], ROWS_TOL)
    dense_rows = render.render_rows(_t(pos), _t(vel), VisionConfig(**kw))
    ring_rows = ring.ring_render_rows(_t(pos), _t(vel), VisionConfig(**kw), mesh=_mesh(2))
    for rows in (got, dense_rows, ring_rows):
        assert rows[1][300, 8].item() == rows[1][301, 8].item() == 10.0
    assert got[0][300, 8].item() == pytest.approx(0.9375) == ring_rows[0][300, 8].item()
    assert dense_rows[0][300, 8].item() == pytest.approx(1.0)
    assert got[0][301, 8].item() == pytest.approx(1.0)
    assert dense_rows[0][301, 8].item() == pytest.approx(0.9375) == ring_rows[0][301, 8].item()


@pytest.mark.parametrize("kw", [dict(antialias=True), dict(sprite_mode="wireframe")])
def test_rdma_render_rows_refuses_what_jax_refuses(kw):
    pos, vel = _arrays(8, 1)
    with pytest.raises(ValueError, match="plain disc sprites"):
        rdma.rdma_ring_render_rows(_t(pos), _t(vel), VisionConfig(width=16, **kw), mesh=_mesh(2))
    with pytest.raises(ValueError, match="plain disc sprites"):
        jrdma.rdma_ring_render_rows(jnp.asarray(pos), jnp.asarray(vel),
                                    JVisionConfig(width=16, **kw), mesh=_jmesh(2))


@pytest.mark.parametrize("fn", ["gravity", "boids", "rows"])
@pytest.mark.parametrize("mix", ["inputs", "mesh"])
def test_rdma_device_mix_raises(fn, mix):
    """Inputs on two devices (gravity's one input on a device neither
    route takes), or a mesh that mixes the CPU with another device, raise
    before anything runs (common.use_kernel's rule)."""
    pos, vel = map(_t, _arrays(8, 2))
    mesh = _mesh(2)
    if mix == "inputs":
        vel = vel.to("meta")
        if fn == "gravity":
            pos = pos.to("meta")
    else:
        mesh = make_mesh({"agents": 2}, devices=[CPU, "meta"])
    call = {"gravity": lambda: rdma.rdma_ring_gravity_forces(pos, SimConfig(n=8), mesh=mesh),
            "boids": lambda: rdma.rdma_ring_boids_velocity(pos, vel, SimConfig(n=8), mesh=mesh),
            "rows": lambda: rdma.rdma_ring_render_rows(pos, vel, VisionConfig(width=8),
                                                       mesh=mesh)}[fn]
    with pytest.raises(ValueError):
        call()


def test_rdma_refuses_inputs_that_need_grad():
    """No silent zero gradient: the kernels have none (nor have the JAX
    ones), so an input that autograd follows raises on either route."""
    pos, vel = map(_t, _arrays(8, 3))
    with pytest.raises(ValueError, match="no gradient"):
        rdma.rdma_ring_gravity_forces(pos.requires_grad_(), SimConfig(n=8), mesh=_mesh(2))
    with torch.no_grad():
        rdma.rdma_ring_gravity_forces(pos, SimConfig(n=8), mesh=_mesh(2))


def test_rdma_plain_versions_are_the_cpu_route():
    """On a CPU mesh the public functions run their plain versions."""
    pos, vel = _arrays(21, 4, (2,), spread=20.0)
    p, v, mesh = _t(pos), _t(vel), _mesh(3)
    cfg, vcfg = SimConfig(n=21), VisionConfig(width=12)
    pairs = [(rdma.rdma_ring_gravity_forces(p, cfg, mesh=mesh),
              rdma.rdma_ring_gravity_forces_plain(p, cfg, mesh=mesh)),
             (rdma.rdma_ring_boids_velocity(p, v, cfg, mesh=mesh),
              rdma.rdma_ring_boids_velocity_plain(p, v, cfg, mesh=mesh)),
             *zip(rdma.rdma_ring_render_rows(p, v, vcfg, mesh=mesh),
                  rdma.rdma_ring_render_rows_plain(p, v, vcfg, mesh=mesh))]
    for got, want in pairs:
        assert torch.equal(got, want)
