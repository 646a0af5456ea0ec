"""Gradients of the port's wireframe eye (RenderRowsWireframeDiff: the
forward with each pixel's winning target, the winner pullback as its
backward) against the JAX package's winner route (render_rows_wireframe_diff
and render_rows_wireframe_batched_diff, their Pallas forwards in interpret
mode) and against JAX dense autodiff; and one REINFORCE and one APG
diff_vision step with sprite_mode='wireframe' against the JAX trainers.

Tolerances. Gradients to rtol 2e-4 and atol 2e-4 of the largest component
(tests/test_wireframe_winner_bwd.py's 2e-4 between the two JAX backward
routes, scaled: the pullbacks sum each target's pixel shares in another
order, and the JAX pullback shades through the per-edge quadratic
c0 + tau (c1 + c2 tau) where the port keeps the dense renderer's
|uv - 0.5|^2). Trainers as tests/test_torch_train.py holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu.ops import wireframe as jwireframe
from nenbody_tpu.rl import apg as japg
from nenbody_tpu.rl import train as jtrain
from nenbody_tpu.rl.env import VisionEnv as JVisionEnv
from nenbody_tpu.rl.policy import MLPPolicy as JMLPPolicy
from nenbody_tpu.rl.policy import gaussian_log_prob as jgaussian_log_prob
from nenbody_tpu.vision import render as jrender

from nenbody_tpu_torch import SimConfig, VisionConfig
from nenbody_tpu_torch.ops import common, wireframe
from nenbody_tpu_torch.rl import apg, train
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.rl.policy import gaussian_log_prob
from nenbody_tpu_torch.vision import render
from test_torch_train import LR, _assert_updates, _ported_policy, _shared_spawn

torch.set_num_threads(1)

FAR = 200.0


def _cfgs(w, aa, far=FAR):
    return (VisionConfig(width=w, antialias=aa, sprite_mode="wireframe", far=far),
            JVisionConfig(width=w, antialias=aa, sprite_mode="wireframe", far=far))


def _inputs(n, w, seed, batch=()):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-40, 40, batch + (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, batch + (n, 2)).astype(np.float32)
    cu = rng.randn(*batch, n, w).astype(np.float32)
    cd = (1e-2 * rng.randn(*batch, n, w)).astype(np.float32)
    return pos, vel, cu, cd


def _port_grads(fn, pos, vel, cu, cd, on):
    p = torch.tensor(pos, requires_grad=True)
    v = torch.tensor(vel, requires_grad=True)
    s, d = fn(p, v)
    loss = (s * torch.tensor(cu)).sum() * ("shade" in on) + (d * torch.tensor(cd)).sum() * (
        "depth" in on)
    loss.backward()
    return p.grad.numpy(), v.grad.numpy()


def _jax_grads(fn, pos, vel, cu, cd, on):
    def loss(p, v):
        s, d = fn(p, v)
        return jnp.sum(s * cu) * ("shade" in on) + jnp.sum(d * cd) * ("depth" in on)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(pos),
                                                                 jnp.asarray(vel))]


def _assert_grads(got, want):
    for g, x, name in zip(got, want, ("pos", "vel")):
        assert np.abs(x).max() > 0, f"{name}: the reference gradient is zero"
        np.testing.assert_allclose(g, x, rtol=2e-4, atol=2e-4 * np.abs(x).max(), err_msg=name)


@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("on", ["shade", "depth"])
def test_wireframe_diff_matches_jax_winner_route_and_dense(aa, on):
    pos, vel, cu, cd = _inputs(32, 32, 7)
    cfg, jcfg = _cfgs(32, aa)
    got = _port_grads(lambda p, v: wireframe.render_rows_wireframe_diff(p, v, cfg),
                      pos, vel, cu, cd, on)
    _assert_grads(got, _jax_grads(lambda p, v: jwireframe.render_rows_wireframe_diff(p, v, jcfg),
                                  pos, vel, cu, cd, on))
    _assert_grads(got, _jax_grads(lambda p, v: jrender.render_rows(p, v, jcfg),
                                  pos, vel, cu, cd, on))
    # the port's own dense autograd, the plain renderer differentiated whole
    _assert_grads(got, _port_grads(lambda p, v: render.render_rows(p, v, cfg),
                                   pos, vel, cu, cd, on))


@pytest.mark.parametrize("aa", [False, True])
def test_wireframe_batched_diff_matches_jax_batched(aa):
    pos, vel, cu, cd = _inputs(16, 32, 11, batch=(3,))
    cfg, jcfg = _cfgs(32, aa)
    got = _port_grads(lambda p, v: wireframe.render_rows_wireframe_tiled(p, v, cfg),
                      pos, vel, cu, cd, "shade+depth")
    _assert_grads(got, _jax_grads(
        lambda p, v: jwireframe.render_rows_wireframe_batched_diff(p, v, jcfg),
        pos, vel, cu, cd, "shade+depth"))


def test_wireframe_pullback_chunks_over_envs(monkeypatch):
    """The pullback's env chunks (WF_PULL_PIXELS) change no gradient."""
    pos, vel, cu, cd = _inputs(12, 16, 13, batch=(4,))
    cfg, _ = _cfgs(16, True)

    def grads():
        return _port_grads(lambda p, v: wireframe.render_rows_wireframe_diff(p, v, cfg),
                           pos, vel, cu, cd, "shade+depth")

    whole = grads()
    monkeypatch.setattr(wireframe, "WF_PULL_PIXELS", 12 * 16)  # one env a chunk
    for g, x in zip(grads(), whole):
        np.testing.assert_array_equal(g, x)
        assert np.abs(x).max() > 0


def test_wireframe_routes_through_the_function_only_when_autograd_needs_it():
    pos, vel, _, _ = _inputs(10, 16, 2)
    cfg, _ = _cfgs(16, True)
    common.reset_launch_counts()
    p, v = torch.tensor(pos), torch.tensor(vel)
    assert wireframe.render_rows_wireframe_tiled(p, v, cfg)[0].grad_fn is None
    p.requires_grad_()
    grad_fn = wireframe.render_rows_wireframe_tiled(p, v, cfg)[0].grad_fn
    assert type(grad_fn).__name__ == "RenderRowsWireframeDiffBackward"
    with torch.no_grad():
        assert wireframe.render_rows_wireframe_tiled(p, v, cfg)[0].grad_fn is None
    assert all(c == 0 for c in common.launch_counts().values())


def test_wireframe_pullback_degenerate_scenes_finite():
    """All-miss scenes and the single agent's self-cull give finite, exactly
    zero gradients (background cotangents are dropped)."""
    cfg, _ = _cfgs(64, True, far=50.0)
    pos = np.array([[0.0, 0.0], [1000.0, 1000.0], [-1000.0, 1000.0], [0.0, -1500.0]],
                   np.float32)
    vel = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0]], np.float32)
    for p, v in ((pos, vel), (np.zeros((1, 2), np.float32), np.ones((1, 2), np.float32))):
        cu = np.ones(p.shape[:1] + (64,), np.float32)
        g = _port_grads(lambda a, b: wireframe.render_rows_wireframe_diff(a, b, cfg),
                        p, v, cu, cu, "shade+depth")
        for x in g:
            assert np.isfinite(x).all() and np.abs(x).max() == 0.0


def _wf_envs(reward_mode, antialias, n=16, w=16, **env_kw):
    kw = dict(n=n, controller="gravity")
    cfg, jcfg = _cfgs(w, antialias, far=10000.0)
    jenv = JVisionEnv(JSimConfig(**kw, backend="dense", vision=jcfg), reward_mode=reward_mode,
                      **env_kw)
    env = VisionEnv(SimConfig(**kw, vision=cfg), reward_mode=reward_mode, **env_kw)
    return jenv, env


def test_reinforce_step_wireframe_matches_jax(monkeypatch):
    """One REINFORCE step with wireframe observations: the port's kernel
    route (the plain version on the CPU, no grad in the rollout) against
    the JAX trainer's dense route (tests/test_torch_train.py's pattern)."""
    b, n, h = 3, 16, 3
    jenv, env = _wf_envs("cohesion", False)
    _shared_spawn(monkeypatch, jtrain, train, seed=1)
    noise = np.random.RandomState(2).randn(b, n, 2).astype(np.float32)

    def jsample(params, apply_fn, obs, key):
        mean, log_std = apply_fn(params, obs)
        action = mean + jnp.exp(log_std) * jnp.asarray(noise)
        return action, jgaussian_log_prob(action, mean, log_std)

    def sample(policy, obs, generator):
        mean, log_std = policy(obs)
        action = mean + torch.exp(log_std) * torch.tensor(noise)
        return action, gaussian_log_prob(action, mean, log_std)

    monkeypatch.setattr(jtrain, "sample_action", jsample)
    monkeypatch.setattr(train, "sample_action", sample)
    opt = optax.adam(LR)
    jts, apply_fn, _ = jtrain.init_train_state(jenv, b, jax.random.key(0), opt,
                                               policy=JMLPPolicy(use_bf16=False))
    jts2, jm = jax.jit(jtrain.make_train_step(jenv, apply_fn, opt, horizon=h))(jts)
    ts = train.init_train_state(env, b, seed=0, lr=LR,
                                policy=_ported_policy(jts.params, env.obs_width), device="cpu")
    old = {k: v.clone() for k, v in ts.policy.state_dict().items()}
    ts2, m = train.make_train_step(env, horizon=h)(ts)
    for key in ("loss", "reward_mean", "return_mean"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    _assert_updates(ts2.policy, old, jts2.params)


def test_apg_diff_vision_step_wireframe_matches_jax(monkeypatch):
    """One APG step with diff_vision, antialias and the visibility reward:
    d reward / d perception runs through RenderRowsWireframeDiff's winner
    pullback in the port and through dense autodiff in the JAX trainer."""
    b, h = 3, 3
    jenv, env = _wf_envs("visibility", True, max_accel=1.0, smooth_clip=True)
    _shared_spawn(monkeypatch, japg, apg, seed=3)
    opt = optax.adam(LR)
    jts, apply_fn, _ = japg.init_apg_state(jenv, jax.random.key(0), opt,
                                           policy=JMLPPolicy(use_bf16=False))
    jts2, jm = jax.jit(japg.make_apg_step(jenv, apply_fn, opt, horizon=h, num_envs=b,
                                          diff_vision=True))(jts)
    ts = apg.init_apg_state(env, seed=0, lr=LR,
                            policy=_ported_policy(jts.params, env.obs_width), device="cpu")
    old = {k: v.clone() for k, v in ts.policy.state_dict().items()}
    ts2, m = apg.make_apg_step(env, horizon=h, num_envs=b, diff_vision=True)(ts)
    for key in ("loss", "reward_mean", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    assert float(m["grad_norm"]) > 0
    _assert_updates(ts2.policy, old, jts2.params)
