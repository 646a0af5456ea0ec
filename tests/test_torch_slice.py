"""The port's main path as a whole against the JAX package's, on shared numpy
inputs and shared flax weights: the entry step (observe -> MLP policy ->
env.step) and Scene rollouts of gravity and boids, batched and unbatched.

On the JAX side the kernels run in Pallas interpret mode (backend="pallas")
or as the dense oracle (backend="dense"); on the port's side the kernel
wrappers take CPU tensors, so they run their plain versions. Positions carry
the physics tolerance of test_torch_physics.py from step to step
(rtol 3e-5, atol 1e-5), observations the shade tolerance of
test_kernels.py:210.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import Scene as JScene
from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu import state as jstate
from nenbody_tpu.rl.env import VisionEnv as JVisionEnv
from nenbody_tpu.rl.policy import MLPPolicy as JMLPPolicy

from nenbody_tpu_torch import PRESETS, Scene, SceneState, SimConfig, VisionConfig
from nenbody_tpu_torch.entry import CONFIG_2, entry, make_entry_fn
from nenbody_tpu_torch.parallel import make_mesh
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.rl.policy import MLPPolicy, state_dict_from_flax

torch.set_num_threads(1)

POS_TOL = dict(rtol=3e-5, atol=1e-5)
VEL_TOL = dict(rtol=3e-5, atol=1e-6)
OBS_TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_entry_fn(env, policy):
    """The body of __graft_entry__.entry()'s fn, for any env."""

    def fn(params, pos, vel):
        state = jstate.SceneState(pos=pos, vel=vel, key=jax.random.key(1), t=jnp.int32(0))
        obs = env.observe(state)
        action, _ = policy.apply(params, obs)
        next_state, next_obs, reward = env.step(state, action)
        return next_state.pos, next_state.vel, next_obs, reward

    return jax.jit(fn)


@pytest.mark.parametrize("jax_backend", ["pallas", "dense"])
def test_entry_step_matches_jax_for_three_steps(jax_backend):
    n, w = 64, 32
    cfg = SimConfig(n=n, controller="gravity", vision=VisionConfig(width=w))
    jenv = JVisionEnv(JSimConfig(n=n, controller="gravity", backend=jax_backend,
                                 vision=JVisionConfig(width=w)))
    assert jenv.backend == jax_backend
    jpolicy = JMLPPolicy(use_bf16=False)
    params = jpolicy.init(jax.random.key(0), jnp.zeros((1, w + 2), jnp.float32))
    jfn = _jax_entry_fn(jenv, jpolicy)

    fn, (policy, _, _) = entry("cpu", cfg=cfg, use_bf16=False)
    policy.load_state_dict(state_dict_from_flax(policy,
                                                jax.tree_util.tree_map(np.asarray, params)))

    rng = np.random.RandomState(0)
    pos = rng.uniform(-30, 30, (n, 2)).astype(np.float32)
    vel = rng.uniform(0, 0.1, (n, 2)).astype(np.float32)
    jpos, jvel, tpos, tvel = jnp.asarray(pos), jnp.asarray(vel), torch.tensor(pos), torch.tensor(vel)
    for _ in range(3):
        jpos, jvel, _, _ = jfn(params, jpos, jvel)
        tpos, tvel, tobs, trew = fn(policy, tpos, tvel)
        np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), **POS_TOL)
        np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel), **VEL_TOL)
        # the observation and reward of the port's own next state: the two
        # trajectories differ in the last bits, and an eye amplifies that
        # (off = (u_p - u_c)/du grows as 1/du for far targets)
        jnext = jstate.SceneState(pos=jnp.asarray(tpos.numpy()), vel=jnp.asarray(tvel.numpy()),
                                  key=jax.random.key(1), t=jnp.int32(1))
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jenv.observe(jnext)), **OBS_TOL)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jenv.reward(jnext)),
                                   rtol=1e-4, atol=1e-6)


def test_entry_defaults_to_config_2():
    assert dataclasses.asdict(CONFIG_2) == dataclasses.asdict(PRESETS["gravity-vision-1024"]())
    small = SimConfig(n=16, controller="gravity", vision=VisionConfig(width=8))
    fn, (policy, pos, vel) = entry("cpu", cfg=small)
    assert isinstance(policy, MLPPolicy) and policy.use_bf16
    out = fn(policy, pos, vel)
    assert [tuple(o.shape) for o in out] == [(16, 2), (16, 2), (16, 10), (16,)]
    assert all(torch.isfinite(o).all() for o in out)
    # batched envs go through the same function
    env = VisionEnv(small)
    out = make_entry_fn(env)(policy, torch.stack([pos, pos + 1]), torch.stack([vel, vel]))
    assert tuple(out[2].shape) == (2, 16, 10)


# Rollouts (controller, envs, steps, record): three steps recording every
# key, under the ids these cases had before zero-step rollouts joined them;
# then zero steps for each record set, where the JAX scan of length 0
# returns each recorded key as an empty stack of its shape
ROLLOUT_RECORDS = [(), ("pos",), ("vel", "obs"), ("pos", "vel", "obs")]
ROLLOUT_CASES = [pytest.param(c, e, 3, ("pos", "vel", "obs"), id=f"{e}-{c}")
                 for c in ("gravity", "boids") for e in (None, 2)]
ROLLOUT_CASES += [pytest.param(c, e, 0, rec, id=f"{e}-{c}-0steps-{'+'.join(rec) or 'none'}")
                  for c in ("gravity", "boids") for e in (None, 2) for rec in ROLLOUT_RECORDS]


@pytest.mark.parametrize("controller,num_envs,steps,record", ROLLOUT_CASES)
def test_scene_rollout_matches_jax(controller, num_envs, steps, record):
    n, w = 48, 32
    kw = dict(n=n, controller=controller)
    jscene = JScene(JSimConfig(**kw, backend="pallas", vision=JVisionConfig(width=w)))
    scene = Scene(SimConfig(**kw, vision=VisionConfig(width=w)), device="cpu")
    batch = () if num_envs is None else (num_envs,)
    rng = np.random.RandomState(5)
    lo = -30 if controller == "gravity" else -15  # boids: every rule fires
    pos = rng.uniform(lo, -lo, batch + (n, 2)).astype(np.float32)
    vel = rng.uniform(-0.5, 0.5, batch + (n, 2)).astype(np.float32)
    jst = (jscene.spawn(0) if num_envs is None else jscene.spawn_envs(num_envs, 0)).replace(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    st = SceneState(pos=torch.tensor(pos), vel=torch.tensor(vel),
                    t=torch.zeros(batch, dtype=torch.int32))
    jfinal, jtraj = jscene.rollout(jst, steps, record=record)
    final, traj = scene.rollout(st, steps, record=record)
    np.testing.assert_array_equal(final.t.numpy(), np.asarray(jfinal.t))
    np.testing.assert_allclose(final.pos.numpy(), np.asarray(jfinal.pos), **POS_TOL)
    assert sorted(traj) == sorted(jtraj) == sorted(record)
    tols = {"pos": POS_TOL, "vel": VEL_TOL, "obs": OBS_TOL}
    for k in record:
        assert tuple(traj[k].shape) == jtraj[k].shape and traj[k].dtype == torch.float32
        np.testing.assert_allclose(traj[k].numpy(), np.asarray(jtraj[k]), **tols[k])
    if "obs" in record:
        assert traj["obs"].shape == (steps,) + batch + (n, w)


def test_random_controller_and_unported_backends():
    cfg = SimConfig(n=32, controller="random", vision=VisionConfig(width=8))
    scene = Scene(cfg, device="cpu")
    a, _ = scene.rollout(scene.spawn(3), 2)
    b, _ = scene.rollout(scene.spawn(3), 2)
    torch.testing.assert_close(a.pos, b.pos, rtol=0, atol=0)  # seeded stream
    assert int(a.t) == 2
    # the mesh backends step the random controller on plain torch, as the
    # JAX package does
    mesh = make_mesh({"agents": 2}, devices=["cpu"] * 2)
    for backend in ("ring", "gspmd"):
        sc = Scene(dataclasses.replace(cfg, backend=backend), device="cpu", mesh=mesh)
        c, _ = sc.rollout(sc.spawn(3), 2)
        torch.testing.assert_close(c.pos, a.pos, rtol=0, atol=0)
