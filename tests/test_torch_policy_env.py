"""The port's MLP policy and VisionEnv against the JAX package's, on shared
numpy inputs and flax weights carried across by state_dict_from_flax.

Tolerances: the fp32 MLP agrees to rtol 1e-5 (matmuls sum in another
order). In bf16 both frameworks round inputs, weights and activations to 8
bits of mantissa, but the products may be summed and rounded at other
points, so the mean action (of order 1) is held to atol 2e-3, half a bf16
step at 1. Env steps use the physics and vision tolerances of
test_torch_physics.py and test_torch_vision.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu import state as jstate
from nenbody_tpu.rl.env import VisionEnv as JVisionEnv
from nenbody_tpu.rl.policy import MLPPolicy as JMLPPolicy

from nenbody_tpu_torch import SceneState, SimConfig, VisionConfig
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.rl.policy import MLPPolicy, state_dict_from_flax

torch.set_num_threads(1)


def _flax_params(obs_dim, use_bf16, seed=0):
    params = JMLPPolicy(use_bf16=use_bf16).init(
        jax.random.key(seed), jnp.zeros((1, obs_dim), jnp.float32))
    return jax.tree_util.tree_map(np.asarray, params)


def _obs(n, w, seed):
    rng = np.random.RandomState(seed)
    return np.concatenate(
        [rng.uniform(0.2, 1.0, (n, w)), rng.uniform(-0.5, 0.5, (n, 2))], axis=1
    ).astype(np.float32)


def test_state_dict_crossing_is_complete():
    policy = MLPPolicy(66)
    sd = state_dict_from_flax(policy, _flax_params(66, False))
    assert set(sd) == set(policy.state_dict())
    policy.load_state_dict(sd, strict=True)
    assert policy.hidden[0].weight.shape == (128, 66) and policy.head.weight.shape == (2, 128)


def test_mlp_fp32_matches_flax():
    params = _flax_params(66, False)
    obs = _obs(300, 64, 1)
    want_mean, want_log_std = JMLPPolicy(use_bf16=False).apply(params, jnp.asarray(obs))
    policy = MLPPolicy(66, use_bf16=False)
    policy.load_state_dict(state_dict_from_flax(policy, params))
    with torch.no_grad():
        mean, log_std = policy(torch.from_numpy(obs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(log_std.detach().numpy(), np.asarray(want_log_std))
    assert mean.dtype == torch.float32


def test_mlp_bf16_matches_flax_within_bf16_bound():
    params = _flax_params(66, True)
    obs = _obs(300, 64, 2)
    want, _ = JMLPPolicy(use_bf16=True).apply(params, jnp.asarray(obs))
    policy = MLPPolicy(66, use_bf16=True)
    policy.load_state_dict(state_dict_from_flax(policy, params))
    with torch.no_grad():
        mean, _ = policy(torch.from_numpy(obs))
    assert mean.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), np.asarray(want), rtol=0, atol=2e-3)


def test_mlp_init_is_lecun_normal_like_flax():
    torch.manual_seed(0)
    w = MLPPolicy(1024, hidden=(512,)).hidden[0].weight
    assert abs(w.std().item() - (1 / 1024) ** 0.5) < 0.05 * (1 / 1024) ** 0.5
    assert w.abs().max().item() <= 2 * (1 / 1024) ** 0.5 / 0.8796 + 1e-6


def _pair(reward_mode, n=48, w=32, **env_kw):
    kw = dict(n=n, controller="gravity", backend="dense")
    jenv = JVisionEnv(JSimConfig(**kw, vision=JVisionConfig(width=w)),
                      reward_mode=reward_mode, **env_kw)
    env = VisionEnv(SimConfig(**kw, vision=VisionConfig(width=w)),
                    reward_mode=reward_mode, **env_kw)
    return jenv, env


def _inputs(n, seed, batch=()):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-30, 30, batch + (n, 2)).astype(np.float32)
    vel = rng.uniform(-0.5, 0.5, batch + (n, 2)).astype(np.float32)
    act = rng.uniform(-0.1, 0.1, batch + (n, 2)).astype(np.float32)
    return pos, vel, act


def _check_step(got, want):
    (gs, go, gr), (ws, wo, wr) = got, want
    np.testing.assert_allclose(gs.pos.numpy(), np.asarray(ws.pos), rtol=3e-5, atol=1e-5)
    np.testing.assert_allclose(gs.vel.numpy(), np.asarray(ws.vel), rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("reward_mode", ["cohesion", "team", "difference", "visibility"])
def test_env_step_matches_jax(reward_mode):
    jenv, env = _pair(reward_mode, speed_penalty=0.1)
    pos, vel, act = _inputs(48, 3)
    jst = jstate.SceneState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                            key=jax.random.key(0), t=jnp.int32(0))
    st = SceneState(pos=torch.from_numpy(pos), vel=torch.from_numpy(vel),
                    t=torch.zeros((), dtype=torch.int32))
    want = jenv.step(jst, jnp.asarray(act))
    got = env.step(st, torch.from_numpy(act))
    _check_step(got, want)
    assert int(got[0].t) == 1
    np.testing.assert_allclose(env.observe(st).numpy(), np.asarray(jenv.observe(jst)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("smooth_clip", [False, True])
def test_env_actuator_and_batched_step_match_jax(smooth_clip):
    """A batch of envs in one call equals the JAX env vmapped over envs."""
    jenv, env = _pair("cohesion", smooth_clip=smooth_clip)
    pos, vel, act = _inputs(48, 4, batch=(3,))
    act = act * 10  # beyond max_accel, so the actuator bounds them
    np.testing.assert_allclose(env.actuate(torch.from_numpy(act)).numpy(),
                               np.asarray(jenv.actuate(jnp.asarray(act))), rtol=1e-6, atol=1e-7)
    jst = jstate.SceneState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                            key=jax.random.split(jax.random.key(0), 3),
                            t=jnp.zeros(3, jnp.int32))
    st = SceneState(pos=torch.from_numpy(pos), vel=torch.from_numpy(vel),
                    t=torch.zeros(3, dtype=torch.int32))
    want = jax.vmap(jenv.step)(jst, jnp.asarray(act))
    got = env.step(st, torch.from_numpy(act))
    _check_step(got, want)


def test_env_validation_matches_jax():
    cfg = SimConfig(n=1, vision=VisionConfig(width=8))
    with pytest.raises(ValueError):
        VisionEnv(cfg, reward_mode="difference")
    with pytest.raises(ValueError):
        VisionEnv(cfg, reward_mode="nearest")
    with pytest.raises(ValueError):
        VisionEnv(SimConfig(n=4))
    assert VisionEnv(SimConfig(n=4, vision=VisionConfig(width=8))).obs_width == 10


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_env_reset_matches_jax(sprite):
    """VisionEnv.reset(generator, device) -> (state, obs): the obs equals
    the JAX env's observe on the same spawned arrays, the spawn is seeded,
    and its draws match the JAX env's reset by statistics (the random
    streams differ)."""
    n = 512
    kw = dict(n=n, controller="gravity")
    vcfg = dict(width=32, sprite_mode=sprite, far=200.0)
    env = VisionEnv(SimConfig(**kw, vision=VisionConfig(**vcfg)))
    jenv = JVisionEnv(JSimConfig(**kw, backend="dense", vision=JVisionConfig(**vcfg)))
    state, obs = env.reset(torch.Generator().manual_seed(4), "cpu")
    assert obs.shape == (n, 34) and state.pos.shape == (n, 2) and int(state.t) == 0
    jst = jstate.SceneState(pos=jnp.asarray(state.pos.numpy()), vel=jnp.asarray(state.vel.numpy()),
                            key=jax.random.key(0), t=jnp.int32(0))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jenv.observe(jst)), rtol=1e-5, atol=1e-4)
    again, _ = env.reset(torch.Generator().manual_seed(4), "cpu")
    assert torch.equal(again.pos, state.pos) and torch.equal(again.vel, state.vel)
    jreset, _ = jenv.reset(jax.random.key(4))
    for got, want, scale in ((state.pos, jreset.pos, 100.0), (state.vel, jreset.vel, 0.1)):
        got, want = got.numpy(), np.asarray(want)
        assert abs(got.mean() - want.mean()) < 0.1 * scale
        assert abs(got.std() - want.std()) < 0.1 * scale
        assert got.min() >= want.min() - 0.05 * scale and got.max() <= want.max() + 0.05 * scale
