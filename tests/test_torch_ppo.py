"""The port's PPO (rl/ppo.py) against the JAX package's, on shared inputs;
the twin of tests/test_ppo.py.

As in tests/test_torch_train.py, pytest's monkeypatch gives both packages
one numpy batch of spawned env states (`spawn_batch`), one fixed noise
array for the sampled actions (`sample_action`) and one minibatch order
(the JAX `jax.random.permutation`, the port's `_permutation`); flax weights
cross with state_dict_from_flax in float32. Both sides step with plain SGD,
whose update is -lr * g, so every later minibatch reads parameters the
earlier ones moved and a gradient that differs shows in the parameters.

Tolerances: losses and metrics to rtol 1e-4 (tests/test_torch_train.py's);
parameter updates to 1e-4 of their tensor's largest update plus 1e-7 (the
16 float32 SGD steps sum their gradients in another order); the port on a
mesh against one device: metrics rtol 1e-4, gradients 1e-4 of their
largest component (tests/test_torch_ring_train.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nenbody_tpu.parallel import mesh as jmesh_lib
from nenbody_tpu.rl import ppo as jppo
from nenbody_tpu.rl.policy import CentralValueMLP as JCentralValueMLP
from nenbody_tpu.rl.policy import MLPPolicy as JMLPPolicy
from nenbody_tpu.rl.policy import ValueMLP as JValueMLP

from nenbody_tpu_torch import cli
from nenbody_tpu_torch.parallel import make_mesh
from nenbody_tpu_torch.rl import ppo
from nenbody_tpu_torch.rl.policy import (CentralValueMLP, MLPPolicy, ValueMLP, seeded,
                                          state_dict_from_flax)
from test_torch_train import B, N, _envs, _shared_noise, _shared_spawn

torch.set_num_threads(1)

SGD_LR = 1e-2
H = 4
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shared_order(monkeypatch, seed=7):
    """One minibatch order for both packages: a permutation of n from
    `seed` (the same for every epoch)."""
    def order(n):
        return np.random.RandomState(seed).permutation(n)

    monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(order(n)))
    monkeypatch.setattr(ppo, "_permutation", lambda n, generator: torch.from_numpy(order(n)))


def test_gae_matches_jax():
    rng = np.random.RandomState(0)
    r = rng.randn(7, 3, 5).astype(np.float32)
    v = rng.randn(7, 3, 5).astype(np.float32)
    last = rng.randn(3, 5).astype(np.float32)
    want = jppo.gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(last), 0.9, 0.8)
    got = ppo.gae(torch.from_numpy(r), torch.from_numpy(v), torch.from_numpy(last), 0.9, 0.8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def _jax_ppo(jenv, central, mesh=None, **step_kw):
    opt = optax.sgd(SGD_LR)
    value = JCentralValueMLP(use_bf16=False) if central else JValueMLP(use_bf16=False)
    jts, papply, vapply = jppo.init_ppo_state(jenv, jax.random.key(0), opt,
                                              policy=JMLPPolicy(use_bf16=False), value=value,
                                              mesh=mesh)
    step = jax.jit(jppo.make_ppo_step(jenv, papply, vapply, opt, central_critic=central,
                                      mesh=mesh, **step_kw))
    return jts, step


def _ported_ppo(env, jts, central):
    pol = MLPPolicy(env.obs_width, use_bf16=False)
    value = (CentralValueMLP if central else ValueMLP)(env.obs_width, use_bf16=False)
    for mod, params in ((pol, jts.params.policy), (value, jts.params.value)):
        mod.load_state_dict(state_dict_from_flax(mod, _np(params)))
    return ppo.init_ppo_state(env, policy=pol, value=value, lr=SGD_LR,
                              optimizer=torch.optim.SGD, device="cpu")


def _assert_params(ts, old, jparams, jold):
    """The port's parameter updates against the JAX step's."""
    for mod, params, params_old in ((ts.policy, jparams.policy, jold.policy),
                                    (ts.value, jparams.value, jold.value)):
        new = state_dict_from_flax(mod, _np(params))
        was = state_dict_from_flax(mod, _np(params_old))
        moved = 0.0
        for name, p in mod.state_dict().items():
            want = (new[name] - was[name]).numpy()
            got = (p - old[id(mod)][name]).numpy()
            scale = np.abs(want).max()
            moved = max(moved, scale)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale + 1e-7,
                                       err_msg=name)
        assert moved > 0


@pytest.mark.parametrize("central,episodic,reward_mode", [
    (False, True, "cohesion"), (True, True, "team"), (False, False, "cohesion"),
])
def test_ppo_step_matches_jax(monkeypatch, central, episodic, reward_mode):
    """One PPO step (two with episodic=False: the second starts from the
    carried env states) of the agent critic, MAPPO's central critic and
    the non-episodic form: 2 epochs x 3 minibatches each, against the JAX
    step on the same spawns, noise, weights and minibatch order."""
    jenv, env = _envs(reward_mode, False)
    _shared_spawn(monkeypatch, jppo, ppo, seed=11)
    _shared_noise(monkeypatch, jppo, ppo, seed=12)
    _shared_order(monkeypatch)
    kw = dict(horizon=H, num_envs=B, epochs=2, num_minibatches=3, episodic=episodic)
    jts, jstep = _jax_ppo(jenv, central, **kw)
    ts = _ported_ppo(env, jts, central)
    step = ppo.make_ppo_step(env, central_critic=central, **kw)
    for i in range(1 if episodic else 2):
        old = {id(m): {k: v.clone() for k, v in m.state_dict().items()}
               for m in (ts.policy, ts.value)}
        jold = jts.params
        jts, jm = jstep(jts)
        ts, m = step(ts)
        assert set(m) == set(jm) == {"loss", "reward_mean", "return_mean", "value_mean"}
        for key in jm:
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
        _assert_params(ts, old, jts.params, jold)
        assert ts.iteration == i + 1
    if episodic:
        assert ts.env_states is None and jts.env_states is None
    else:
        np.testing.assert_array_equal(ts.env_states.t.numpy(), 2 * H)
        np.testing.assert_allclose(ts.env_states.pos.numpy(), np.asarray(jts.env_states.pos),
                                   rtol=1e-4, atol=1e-4)


def test_ppo_rejects_what_jax_rejects():
    """The two ValueErrors of the JAX step, with its messages: a central
    critic's samples (whole agent rows) fewer than the minibatches, and a
    mesh horizon that does not divide into them."""
    jenv, env = _envs("cohesion", False, n=8, w=8)
    mesh = make_mesh({"data": 2, "agents": 4}, devices=[CPU] * 8)
    cases = [(dict(horizon=2, num_envs=1, num_minibatches=4, central_critic=True), None,
              "minibatches would be empty"),
             (dict(horizon=5, num_envs=2, num_minibatches=2), mesh, "time axis")]
    for kw, m, match in cases:
        jm = jmesh_lib.make_mesh({"data": 2, "agents": 4}) if m is not None else None
        with pytest.raises(ValueError, match=match):
            jppo.make_ppo_step(jenv, None, None, None, mesh=jm, **kw)
        with pytest.raises(ValueError, match=match):
            ppo.make_ppo_step(env, mesh=m, **kw)
    with pytest.raises(ValueError, match="divide evenly"):
        ppo.make_ppo_step(env, horizon=2, num_envs=3, num_minibatches=2, mesh=mesh)


@pytest.mark.parametrize("mesh_axes,central", [
    ({"data": 2, "agents": 4}, False), ({"agents": 4}, True), ({"data": 2}, False),
])
def test_ppo_on_mesh_matches_one_device(mesh_axes, central):
    """PPO with mesh= (the ring's observe and step; a data-only mesh splits
    the envs) against one device, same seed. With one minibatch and one
    epoch both minibatch schemes (flat samples, time slabs) take the whole
    rollout, so loss, metrics and every gradient agree."""
    mesh = make_mesh(mesh_axes, devices=[CPU] * 8)
    _, env = _envs("team", True, n=N)
    out = []
    for m in (mesh, None):
        value = seeded(4, lambda: CentralValueMLP(env.obs_width)) if central else None
        ts = ppo.init_ppo_state(env, seed=3, value=value, device="cpu")
        step = ppo.make_ppo_step(env, horizon=2, num_envs=4, epochs=1, num_minibatches=1,
                                 mesh=m, central_critic=central)
        ts, metrics = step(ts)
        grads = [p.grad.clone() for mod in (ts.policy, ts.value) for p in mod.parameters()]
        out.append((metrics, grads))
    (m_mesh, g_mesh), (m_one, g_one) = out
    for key in m_one:
        np.testing.assert_allclose(float(m_mesh[key]), float(m_one[key]), rtol=1e-4, err_msg=key)
    for a, b in zip(g_mesh, g_one):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())


def test_ppo_on_mesh_matches_jax_mesh(monkeypatch):
    """Under a mesh both packages draw minibatches along the time axis:
    the port's PPO on a (data 2, agents 4) mesh of the CPU against the JAX
    PPO on its 8 virtual CPU devices, 2 epochs x 2 time slabs, shared
    spawns, noise and slab order."""
    jenv, env = _envs("cohesion", False, n=8, w=8)
    _shared_spawn(monkeypatch, jppo, ppo, seed=13, b=2, n=8)
    _shared_noise(monkeypatch, jppo, ppo, seed=14, b=2, n=8)
    _shared_order(monkeypatch)
    kw = dict(horizon=H, num_envs=2, epochs=2, num_minibatches=2)
    jts, jstep = _jax_ppo(jenv, False, mesh=jmesh_lib.make_mesh({"data": 2, "agents": 4}), **kw)
    ts = _ported_ppo(env, jts, False)
    old = {id(m): {k: v.clone() for k, v in m.state_dict().items()}
           for m in (ts.policy, ts.value)}
    jts2, jm = jstep(jts)
    mesh = make_mesh({"data": 2, "agents": 4}, devices=[CPU] * 8)
    ts, m = ppo.make_ppo_step(env, mesh=mesh, **kw)(ts)
    for key in jm:
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    _assert_params(ts, old, jts2.params, jts.params)


class _ClippedAdam(torch.optim.Adam):
    """Adam after clipping the gradients' global norm to 0.5 (the JAX
    test's optax.chain(clip_by_global_norm(0.5), adam))."""

    def step(self, closure=None):
        torch.nn.utils.clip_grad_norm_([p for g in self.param_groups for p in g["params"]], 0.5)
        return super().step(closure)


@pytest.mark.slow
def test_ppo_learns_multiagent_cohesion_n64():
    """The credit-assignment pin of
    tests/test_ppo.py::test_ppo_learns_multiagent_cohesion_n64 (slow there
    too): PPO's per-agent GAE advantages and clipped minibatch reuse
    improve the cohesion reward of 64 agents on a fixed evaluation set,
    median over 3 seeds above 0.005 (flat runs sit at about +-0.002)."""
    from nenbody_tpu_torch import SimConfig, VisionConfig
    from nenbody_tpu_torch.rl.env import VisionEnv
    from nenbody_tpu_torch.state import spawn_batch

    env = VisionEnv(SimConfig(n=64, controller="gravity", vision=VisionConfig(width=16)),
                    max_accel=1.0)
    eval_envs = spawn_batch(env.cfg, torch.Generator().manual_seed(999), 16, "cpu")
    step = ppo.make_ppo_step(env, horizon=32, num_envs=16, epochs=4, num_minibatches=8)

    @torch.no_grad()
    def evaluate(policy):
        states, rewards = eval_envs, []
        for _ in range(32):
            action, _ = policy(env.observe(states))
            states = env.dynamics(states, action)
            rewards.append(env.reward(states).mean())
        return float(torch.stack(rewards).mean())

    deltas = []
    for seed in (0, 1, 2):
        ts = ppo.init_ppo_state(
            env, seed=seed, lr=3e-4, optimizer=_ClippedAdam, device="cpu",
            policy=seeded(seed, lambda: MLPPolicy(env.obs_width, use_bf16=False)),
            value=seeded(seed + 1, lambda: ValueMLP(env.obs_width, use_bf16=False)))
        r0 = evaluate(ts.policy)
        for _ in range(60):
            ts, metrics = step(ts)
        assert np.isfinite(float(metrics["loss"]))
        deltas.append(evaluate(ts.policy) - r0)
    assert float(np.median(deltas)) > 0.005, deltas
