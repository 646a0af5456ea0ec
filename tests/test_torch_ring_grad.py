"""Gradients through the port's agent-axis ring: ring_render_rows_diff (both
sprites) against JAX dense autodiff and the JAX package's ring in its
kernel editions (interpret mode), and the ring's gravity (hop 0 the self
form, later hops the cross form) with the cross form's pullback against
float64, on shared numpy inputs.

The port runs on meshes that repeat the CPU device (4 for the agent axis,
2 x 4 for data x agents). On CPU tensors each hop's eye Function runs its
plain versions: the plain renderer forward, and as backward autograd
through it (disc) or winner_pullback (wireframe), the plain version of
csrc/wireframe_eye_bwd.cu (held against it on the card).

Tolerances. The wireframe against JAX dense autodiff and against the JAX
kernel-edition ring (per-hop `render_rows_wireframe_vjp_cross`, #11) at
tests/test_sharding.py:395-398's rtol 1e-4 / atol 1e-5; the disc at
tests/test_ring_diff_vision.py's rtol 3e-4 / atol 3e-4 of the largest
component. Gravity gradients against float64 to 3e-5 of the largest
(ROADMAP queue 3's allowance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu.parallel import mesh as jmesh
from nenbody_tpu.parallel import ring as jring
from nenbody_tpu.vision import render as jrender

from nenbody_tpu_torch import SimConfig, VisionConfig
from nenbody_tpu_torch.config import GravityConfig
from nenbody_tpu_torch.ops import pairwise
from nenbody_tpu_torch.parallel import make_mesh, ring
from nenbody_tpu_torch.physics import dense
from nenbody_tpu_torch.vision import render

torch.set_num_threads(1)

CPU = torch.device("cpu")
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



def _cotangents(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            (1e-2 * rng.randn(*shape)).astype(np.float32))


def _port_grads(fn, pos, vel, cu, cd):
    p, v = _t(pos).requires_grad_(), _t(vel).requires_grad_()
    s, d = fn(p, v)
    ((s * _t(cu)).sum() + (torch.where(d < FAR, d, 0.0) * _t(cd)).sum()).backward()
    return p.grad.numpy(), v.grad.numpy()


def _jax_grads(fn, pos, vel, cu, cd):
    def loss(p, v):
        s, d = fn(p, v)
        return jnp.sum(s * cu) + jnp.sum(jnp.where(d < FAR, d, 0.0) * cd)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(pos),
                                                                 jnp.asarray(vel))]


def _assert_grads(got, want, sprite):
    for g, w, name in zip(got, want, ("pos", "vel")):
        assert np.abs(w).max() > 0, name
        if sprite == "wireframe":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=3e-4, atol=3e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
@pytest.mark.parametrize("aa", [False, True])
def test_ring_diff_matches_jax_dense_autodiff(mesh4, sprite, aa):
    """ring_render_rows_diff's gradients (each hop's Function with its own
    winner index, merge_rows routing the cotangents, the peer copies'
    transposes bringing block gradients home) against JAX autodiff of the
    dense single-device render, shade and depth cotangents together."""
    n, w = 16, 16
    pos, vel = _arrays(n, 6)
    cu, cd = _cotangents((n, w), 7)
    kw = dict(width=w, sprite_mode=sprite, antialias=aa, far=FAR)
    got = _port_grads(lambda p, v: ring.ring_render_rows_diff(p, v, VisionConfig(**kw),
                                                              mesh=mesh4), pos, vel, cu, cd)
    want = _jax_grads(lambda p, v: jrender.render_rows(p, v, JVisionConfig(**kw)),
                      pos, vel, cu, cd)
    _assert_grads(got, want, sprite)


def test_ring_diff_wireframe_matches_jax_kernel_edition(monkeypatch, mesh4, jmesh4):
    """Against the JAX ring's kernel edition (tests/test_sharding.py:362-399
    forces it): per-hop `_wf_bwd_kernel` pullbacks (interpret mode), with
    the headings circulating, at N=16, W=16 over 4 hops, AA on."""
    monkeypatch.setattr(jring, "_use_pallas", lambda backend: True)
    n, w = 16, 16
    pos, vel = _arrays(n, 8)
    cu, cd = _cotangents((n, w), 9)
    kw = dict(width=w, sprite_mode="wireframe", antialias=True, far=FAR)
    got = _port_grads(lambda p, v: ring.ring_render_rows_diff(p, v, VisionConfig(**kw),
                                                              mesh=mesh4), pos, vel, cu, cd)
    want = _jax_grads(lambda p, v: jring.ring_render_rows_diff(p, v, JVisionConfig(**kw),
                                                               mesh=jmesh4), pos, vel, cu, cd)
    _assert_grads(got, want, "wireframe")
    assert np.abs(got[1]).max() > 0  # heading gradients live


@pytest.mark.slow
def test_ring_diff_wireframe_matches_jax_compact_edition(monkeypatch, mesh4, jmesh4):
    """Against the JAX ring's compact edition (per-hop `_compact_bwd_kernel`
    at wide rows, W=512; tests/test_sharding.py:402 keeps it in the slow
    tier for its compile time), at its tolerance (rtol 2e-4 / atol 2e-4)."""
    monkeypatch.setattr(jring, "_use_pallas", lambda backend: True)
    n, w = 16, 512
    pos, vel = _arrays(n, 8)
    cu, cd = _cotangents((n, w), 9)
    kw = dict(width=w, sprite_mode="wireframe", antialias=True, far=FAR)
    got = _port_grads(lambda p, v: ring.ring_render_rows_diff(p, v, VisionConfig(**kw),
                                                              mesh=mesh4), pos, vel, cu, cd)
    want = _jax_grads(lambda p, v: jring.ring_render_rows_diff(p, v, JVisionConfig(**kw),
                                                               mesh=jmesh4), pos, vel, cu, cd)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, x, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_ring_diff_batched_with_data_axis(sprite):
    """A (data 2, agents 4) mesh and a batch of 4 envs against the dense
    render's autograd per env, in the port (both sides plain PyTorch)."""
    mesh = make_mesh({"data": 2, "agents": 4}, devices=[CPU] * 8)
    pos, vel = _arrays(16, 2, batch=(4,))
    cu, cd = _cotangents((4, 16, 16), 3)
    vcfg = VisionConfig(width=16, sprite_mode=sprite, antialias=True, far=FAR)
    got = _port_grads(lambda p, v: ring.ring_render_rows_diff(p, v, vcfg, mesh=mesh,
                                                              data_axis="data"),
                      pos, vel, cu, cd)
    want = _port_grads(lambda p, v: render.render_rows(p, v, vcfg), pos, vel, cu, cd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_ring_diff_rejects_indivisible(mesh4):
    pos, vel = _arrays(21, 1)
    with pytest.raises(ValueError, match="divisible"):
        ring.ring_render_rows_diff(_t(pos), _t(vel), VisionConfig(width=16), mesh=mesh4)


def test_ring_gravity_grads_against_float64(mesh4):
    """Gradients through the ring's gravity (hop 0 the self form and its VJP,
    hops >= 1 the cross form GravityForcesCrossDiff), N not divisible (the
    sentinels' rows carry no gradient), against float64 dense autograd."""
    pos, _ = _arrays(37, 4, batch=(2,), spread=30.0)
    cfg = SimConfig(n=37, controller="gravity")
    p = _t(pos).requires_grad_()
    (ring.ring_gravity_forces(p, cfg, mesh=mesh4) ** 2).sum().backward()
    q = torch.tensor(pos, dtype=torch.float64, requires_grad=True)
    (dense.gravity_forces(q, cfg.gravity) ** 2).sum().backward()
    assert ((p.grad.double() - q.grad).abs().max() / q.grad.abs().max()).item() < 3e-5


@pytest.mark.parametrize("n,m", [(1, 1), (17, 40), (300, 77)])
def test_gravity_cross_vjp_plain_against_float64(n, m):
    """The cross form's pullback (the plain version, autograd through
    dense.gravity_forces_cross in float32) against its float64 run, both
    outputs, and the Function's gradients equal to it."""
    rng = np.random.RandomState(n + m)
    pos_i = rng.uniform(-30, 30, (2, n, 2)).astype(np.float32)
    pos_j = rng.uniform(-30, 30, (2, m, 2)).astype(np.float32)
    u = rng.randn(2, n, 2).astype(np.float32)
    cfg = GravityConfig()
    got = pairwise.gravity_vjp_cross_plain(_t(pos_i), _t(pos_j), _t(u), cfg)
    want = pairwise.gravity_vjp_cross_plain(*(torch.tensor(x, dtype=torch.float64)
                                              for x in (pos_i, pos_j, u)), cfg)
    for g, w in zip(got, want):
        assert w.abs().max() > 0
        assert ((g.double() - w).abs().max() / w.abs().max()).item() < 3e-5
    pi, pj = _t(pos_i).requires_grad_(), _t(pos_j).requires_grad_()
    g = pairwise.gravity_forces_tiled(pi, cfg, pos_j=pj)
    assert type(g.grad_fn).__name__ == "GravityForcesCrossDiffBackward"
    g.backward(_t(u))
    torch.testing.assert_close(pi.grad, got[0], rtol=0, atol=0)
    torch.testing.assert_close(pj.grad, got[1], rtol=0, atol=0)
