"""The port's recurrent REINFORCE (rl/train.py's make_recurrent_train_step
with GRUPolicy) against the JAX package's, on shared inputs; the twin of
tests/test_recurrent.py's trainer tests.

Monkeypatch gives both packages one numpy batch of spawned env states and
one fixed noise array for the sampled actions: the JAX step draws it with
`jax.random.normal` inside its rollout, the port through
`policy.sample_gaussian` (imported into rl/train.py). The GRU weights cross
with state_dict_from_flax in float32; the JAX step's gradients are read
through an optimizer that records them.

Tolerances: losses and metrics to rtol 1e-4, each gradient to 1e-4 of its
tensor's largest component (tests/test_torch_train.py's); on a mesh
against one device rtol 1e-4 and 1e-4 of the largest component
(tests/test_torch_ring_train.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu.rl import train as jtrain
from nenbody_tpu.rl.policy import GRUPolicy as JGRUPolicy

from nenbody_tpu_torch.parallel import make_mesh
from nenbody_tpu_torch.rl import train
from nenbody_tpu_torch.rl.policy import GRUPolicy, state_dict_from_flax
from test_torch_train import B, H, N, _assert_grads, _envs, _grad_recorder, _shared_spawn

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("reward_mode,antialias", [("cohesion", False), ("visibility", True)])
def test_recurrent_step_matches_jax(monkeypatch, reward_mode, antialias):
    """One recurrent REINFORCE step: the rollout carries the hidden state,
    the loss re-runs the recurrence from zero (BPTT); loss, reward_mean,
    return_mean and every gradient, the cell's among them, against JAX."""
    jenv, env = _envs(reward_mode, antialias)
    _shared_spawn(monkeypatch, jtrain, train, seed=41)
    opt = _grad_recorder()
    jts, _, jpol = jtrain.init_recurrent_train_state(
        jenv, B, jax.random.key(0), opt, policy=JGRUPolicy(hidden=16, use_bf16=False))
    pol = GRUPolicy(env.obs_width, hidden=16, use_bf16=False)
    pol.load_state_dict(state_dict_from_flax(pol, jax.tree_util.tree_map(np.asarray,
                                                                         jts.params)))
    noise = np.random.RandomState(42).randn(B, N, 2).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(noise))
    monkeypatch.setattr(train, "sample_gaussian",
                        lambda mean, log_std, gen: mean + torch.exp(log_std) * torch.tensor(noise))
    jts2, jm = jax.jit(jtrain.make_recurrent_train_step(jenv, jpol, opt, horizon=H))(jts)

    ts = train.init_recurrent_train_state(env, B, policy=pol, device="cpu")
    ts2, m = train.make_recurrent_train_step(env, horizon=H)(ts)
    assert set(m) == set(jm) == {"loss", "reward_mean", "return_mean"}
    for key in jm:
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    _assert_grads(ts2.policy, jts2.opt_state, 1e-4)
    assert ts2.policy.cell.weight_hh.grad.abs().max() > 0
    assert int(ts2.env_states.t[0]) == H


@pytest.mark.parametrize("mesh_axes", [{"data": 2, "agents": 4}, {"data": 2}])
def test_recurrent_on_mesh_matches_one_device(mesh_axes):
    """Recurrent REINFORCE with mesh= against one device, same seed:
    loss, metrics and every gradient; the default GRUPolicy (bf16 encoder)."""
    mesh = make_mesh(mesh_axes, devices=[CPU] * 8)
    _, env = _envs("visibility", True)
    out = []
    for m in (mesh, None):
        ts = train.init_recurrent_train_state(env, 4, seed=3, device="cpu", mesh=m)
        ts, metrics = train.make_recurrent_train_step(env, horizon=2, mesh=m)(ts)
        out.append((metrics, [p.grad.clone() for p in ts.policy.parameters()]))
    (m_mesh, g_mesh), (m_one, g_one) = out
    for key in m_one:
        np.testing.assert_allclose(float(m_mesh[key]), float(m_one[key]), rtol=1e-4, err_msg=key)
    for a, b in zip(g_mesh, g_one):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())
    with pytest.raises(ValueError, match="divide evenly"):
        train.init_recurrent_train_state(env, 3, device="cpu", mesh=mesh)


@pytest.mark.slow
def test_recurrent_reinforce_learns_brake_task():
    """Estimator correctness through the recurrence: on the single-agent
    brake task (reward -0.5 |v|^2) the GRU policy improves (the pin of
    tests/test_recurrent.py::test_recurrent_reinforce_learns_brake_task,
    slow there too)."""
    from nenbody_tpu_torch import SimConfig, VisionConfig
    from nenbody_tpu_torch.rl.env import VisionEnv

    env = VisionEnv(SimConfig(n=1, controller="gravity", vision=VisionConfig(width=8)),
                    max_accel=1.0, speed_penalty=0.5)
    ts = train.init_recurrent_train_state(
        env, 128, lr=3e-3, device="cpu",
        policy=GRUPolicy(env.obs_width, hidden=32, use_bf16=False))
    step = train.make_recurrent_train_step(env, horizon=8)
    ts, m0 = step(ts)
    for _ in range(150):
        ts, m = step(ts)
    assert float(m["reward_mean"]) > float(m0["reward_mean"]) + 1e-3
    assert float(m["reward_mean"]) > -2e-3
