"""The port's differentiable gravity force and disc eye, and the policy's
sampling helpers, against the JAX package's on shared numpy inputs.

On the CPU the port's autograd Functions (ops.pairwise.GravityForcesDiff,
ops.raycast.RenderRowsDiff) run the plain versions of their kernels: the
closed-form gravity VJP and autograd through the plain renderer. The JAX
side runs its Pallas VJP kernels in interpret mode, as its own tests do,
and its dense autodiff.

Tolerances, with their reasons:
- gravity VJP: normalized atol 3e-5 (error / max|grad|), the JAX suite's
  bound between its VJP kernel and a float64 oracle (test_kernels.py:141-155):
  the pair sums cancel, so the error scales with the largest gradient.
- disc VJP: rtol 2e-4 and atol 2e-4 * max|grad|, the JAX suite's between its
  VJP kernel and its dense autodiff (test_diff_vision.py:31-57): per-pixel
  terms round differently and their sums over pixels and eyes cancel.
- log-probs and returns: rtol 1e-6 (elementwise float32 arithmetic in
  another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu.config import GravityConfig as JGravityConfig
from nenbody_tpu.config import VisionConfig as JVisionConfig
from nenbody_tpu.ops import pairwise as jpairwise
from nenbody_tpu.ops import raycast as jraycast
from nenbody_tpu.rl import policy as jpolicy
from nenbody_tpu.rl import train as jtrain
from nenbody_tpu.vision import render as jrender

from nenbody_tpu_torch import SceneState
from nenbody_tpu_torch.config import GravityConfig, SimConfig, VisionConfig
from nenbody_tpu_torch.ops import common, pairwise, raycast, tiled
from nenbody_tpu_torch.rl import policy, train
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.vision import camera, render

torch.set_num_threads(1)

VJP_NORM_ATOL = 3e-5
DISC_RTOL = 2e-4


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _gravity_inputs(n, seed, batch=()):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-100, 100, batch + (n, 2)).astype(np.float32)
    u = rng.randn(*(batch + (n, 2))).astype(np.float32)
    return pos, u


def _assert_normalized(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    if scale == 0.0:  # N=1: the self-pair gives exactly 0 on both sides
        np.testing.assert_array_equal(got, 0.0)
        return
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=VJP_NORM_ATOL)


@pytest.mark.parametrize("n", [1, 17, 300])
def test_gravity_vjp_plain_matches_jax_kernel(n):
    pos, u = _gravity_inputs(n, n)
    want = jpairwise.gravity_vjp_tiled(jnp.asarray(pos), jnp.asarray(u), JGravityConfig())
    got = pairwise.gravity_vjp_tiled(_t(pos), _t(u), GravityConfig())
    _assert_normalized(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 17, 300])
def test_gravity_forces_diff_matches_jax_vjp(n):
    pos, u = _gravity_inputs(n, n + 1)
    jcfg = JGravityConfig()
    fwd, vjp = jax.vjp(lambda p: jpairwise.gravity_forces_diff(p, jcfg), jnp.asarray(pos))
    p = _t(pos).requires_grad_()
    g = pairwise.gravity_forces_diff(p, GravityConfig())
    g.backward(_t(u))
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(fwd), rtol=3e-5, atol=1e-7)
    _assert_normalized(p.grad.numpy(), vjp(jnp.asarray(u))[0])


def test_gravity_vjp_batched_equals_per_env_and_self_pair_is_zero():
    pos, u = _gravity_inputs(40, 3, batch=(3,))
    cfg = GravityConfig()
    got = pairwise.gravity_vjp_tiled(_t(pos), _t(u), cfg)
    for b in range(3):
        torch.testing.assert_close(got[b], pairwise.gravity_vjp_tiled(_t(pos[b]), _t(u[b]), cfg))
    # a lone agent: only the self-pair, which contributes exactly 0
    one = pairwise.gravity_vjp_plain(_t(pos[0, :1]), _t(u[0, :1]), cfg)
    assert torch.equal(one, torch.zeros_like(one))


def test_gravity_forces_diff_gradcheck_float64():
    rng = np.random.RandomState(5)
    pos = torch.tensor(rng.uniform(-3, 3, (2, 12, 2)), dtype=torch.float64, requires_grad=True)
    cfg = GravityConfig()
    assert torch.autograd.gradcheck(lambda p: pairwise.gravity_forces_diff(p, cfg), (pos,))


def test_gravity_routing_by_grad_mode():
    pos, _ = _gravity_inputs(20, 9)
    cfg = GravityConfig()
    assert pairwise.gravity_forces_tiled(_t(pos), cfg).grad_fn is None
    p = _t(pos).requires_grad_()
    grad_fn = pairwise.gravity_forces_tiled(p, cfg).grad_fn
    assert type(grad_fn).__name__ == "GravityForcesDiffBackward"
    with torch.no_grad():
        assert pairwise.gravity_forces_tiled(p, cfg).grad_fn is None
    # the cross form (a ring hop) routes through its own Function
    grad_fn = pairwise.gravity_forces_tiled(p, cfg, _t(pos)).grad_fn
    assert type(grad_fn).__name__ == "GravityForcesCrossDiffBackward"
    assert all(c == 0 for c in common.launch_counts().values())


def test_steps_enter_the_gravity_function_only_when_autograd_needs_it(monkeypatch):
    """gravity_step and VisionEnv.dynamics route through the wrapper alone:
    without grad (serving, semi-APG's no_grad renders) they never reach the
    autograd Function; with grad they go through it, as the JAX steps go
    through their custom VJP."""
    calls = []
    real = pairwise.gravity_forces_diff
    monkeypatch.setattr(pairwise, "gravity_forces_diff",
                        lambda p, c: calls.append(p.shape) or real(p, c))
    cfg = SimConfig(n=12, controller="gravity", vision=VisionConfig(width=8))
    env = VisionEnv(cfg)
    pos, _ = _gravity_inputs(12, 4, batch=(2,))
    state = SceneState(pos=_t(pos), vel=torch.zeros(2, 12, 2), t=torch.zeros(2, dtype=torch.int32))
    action = torch.zeros(2, 12, 2)

    def steps(s):
        return tiled.gravity_step(s, cfg).pos, env.dynamics(s, action).pos

    assert all(x.grad_fn is None for x in steps(state)) and calls == []
    grad_state = state.replace(pos=state.pos.clone().requires_grad_())
    with torch.no_grad():
        steps(grad_state)
    assert calls == []
    outs = steps(grad_state)
    assert len(calls) == 2
    for x in outs:
        x.sum().backward()
    assert torch.isfinite(grad_state.pos.grad).all()


def _scene(n, seed, spread=30.0, batch=()):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-spread, spread, batch + (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, batch + (n, 2)).astype(np.float32)
    return pos, vel


def _cotangents(shape, seed):
    rng = np.random.RandomState(seed + 100)
    return rng.randn(*shape).astype(np.float32), (rng.randn(*shape) * 1e-3).astype(np.float32)


def _jax_disc_grads(render_fn, pos, vel, ws, wd, cfg):
    def loss(p, v):
        s, d = render_fn(p, v, cfg)
        # depth cotangent only on hits (miss depth is the far constant)
        return jnp.sum(s * ws) + jnp.sum(jnp.where(d < cfg.far, d, 0.0) * wd)

    grads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(pos), jnp.asarray(vel))
    return [np.asarray(g) for g in grads]


def _port_disc_grads(render_fn, pos, vel, ws, wd, cfg):
    p, v = _t(pos).requires_grad_(), _t(vel).requires_grad_()
    s, d = render_fn(p, v, cfg)
    loss = (s * _t(ws)).sum() + (torch.where(d < cfg.far, d, torch.zeros_like(d)) * _t(wd)).sum()
    loss.backward()
    return p.grad.numpy(), v.grad.numpy(), s.grad_fn


def _assert_disc_close(got, want):
    for a, b in zip(got, want):
        assert np.abs(b).max() > 0  # the check must not pass vacuously
        np.testing.assert_allclose(a, b, rtol=DISC_RTOL, atol=DISC_RTOL * np.abs(b).max())


@pytest.mark.parametrize("reference", ["pallas_vjp", "dense_autodiff"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_disc_vjp_matches_jax(reference, antialias, seed):
    n, w = 24, 32
    pos, vel = _scene(n, seed)
    ws, wd = _cotangents((n, w), seed)
    jfn = jraycast.render_rows_diff if reference == "pallas_vjp" else jrender.render_rows
    want = _jax_disc_grads(jfn, pos, vel, ws, wd, JVisionConfig(width=w, antialias=antialias))
    gp, gv, grad_fn = _port_disc_grads(
        raycast.render_rows_diff, pos, vel, ws, wd, VisionConfig(width=w, antialias=antialias))
    assert type(grad_fn).__name__ == "RenderRowsDiffBackward"
    _assert_disc_close((gp, gv), want)


def test_disc_routing_and_batched_grads_equal_per_env():
    """render_rows_tiled routes through the Function when an input requires
    grad (and not otherwise); a batch of envs equals each env alone."""
    cfg = VisionConfig(width=16, antialias=True)
    pos, vel = _scene(12, 4, batch=(2,))
    ws, wd = _cotangents((2, 12, 16), 4)
    assert raycast.render_rows_tiled(_t(pos), _t(vel), cfg)[0].grad_fn is None
    gp, gv, grad_fn = _port_disc_grads(raycast.render_rows_tiled, pos, vel, ws, wd, cfg)
    assert type(grad_fn).__name__ == "RenderRowsDiffBackward"
    for b in range(2):
        one = _port_disc_grads(raycast.render_rows_diff, pos[b], vel[b], ws[b], wd[b], cfg)
        np.testing.assert_allclose(gp[b], one[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gv[b], one[1], rtol=1e-5, atol=1e-6)


def test_disc_vjp_cross_targets_match_dense_autograd():
    """Eyes against another position set: the target gradient comes back
    apart from the eye gradient, as the dense renderer's autograd gives it."""
    cfg = VisionConfig(width=24, antialias=True)
    pos, vel = _scene(10, 11)
    tgt, _ = _scene(15, 12, spread=20.0)
    us, ud = _cotangents((10, 24), 11)
    dirs = camera.unit_heading(_t(vel))
    got = raycast.render_rows_vjp_cross(_t(pos), dirs, None, _t(us), _t(ud), cfg, targets=_t(tgt))
    p, d, t = (x.clone().requires_grad_() for x in (_t(pos), dirs, _t(tgt)))
    s, dep = render.eye_rows(p, d, t, cfg)
    want = torch.autograd.grad((s * _t(us)).sum() + (dep * _t(ud)).sum(), (p, d, t))
    _assert_disc_close([g.numpy() for g in got], [g.numpy() for g in want])


def test_disc_vjp_zero_cotangent_zero_grad():
    cfg = VisionConfig(width=16, antialias=True)
    pos, vel = _scene(12, 3)
    p, v = _t(pos).requires_grad_(), _t(vel).requires_grad_()
    s, d = raycast.render_rows_diff(p, v, cfg)
    (s * 0.0).sum().backward()
    assert torch.equal(p.grad, torch.zeros_like(p)) and torch.equal(v.grad, torch.zeros_like(v))


def test_gaussian_log_prob_matches_jax():
    rng = np.random.RandomState(2)
    action, mean = rng.randn(2, 5, 7, 2).astype(np.float32)
    log_std = np.array([-1.0, -0.3], np.float32)
    want = jpolicy.gaussian_log_prob(jnp.asarray(action), jnp.asarray(mean), jnp.asarray(log_std))
    got = policy.gaussian_log_prob(_t(action), _t(mean), _t(log_std))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_discounted_returns_match_jax():
    rewards = np.random.RandomState(3).randn(6, 4, 5).astype(np.float32)
    want = jtrain.discounted_returns(jnp.asarray(rewards), 0.99)
    got = train.discounted_returns(_t(rewards), 0.99)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_sample_action_uses_its_generator():
    pol = policy.MLPPolicy(10, use_bf16=False)
    obs = torch.rand(3, 4, 10)
    a1, lp1 = policy.sample_action(pol, obs, torch.Generator().manual_seed(1))
    a2, lp2 = policy.sample_action(pol, obs, torch.Generator().manual_seed(1))
    a3, _ = policy.sample_action(pol, obs, torch.Generator().manual_seed(2))
    assert a1.shape == (3, 4, 2) and lp1.shape == (3, 4)
    assert torch.equal(a1, a2) and torch.equal(lp1, lp2) and not torch.equal(a1, a3)
    mean, log_std = pol(obs)
    torch.testing.assert_close(lp1, policy.gaussian_log_prob(a1, mean, log_std))
