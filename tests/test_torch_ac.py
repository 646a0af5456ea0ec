"""The port's actor-critic (rl/ac.py) against the JAX package's, on shared
inputs; the twin of tests/test_rl.py::test_ac_trainer_runs_and_trains_both_heads.

As in tests/test_torch_train.py, monkeypatch gives both packages one numpy
batch of spawned env states and one fixed action-noise array (the port's
AC rolls out through rl/train.py's sampled_rollout, so the port's patches
go there); flax weights cross with state_dict_from_flax in float32. The
JAX step's gradients are read through an optimizer that records them
(_grad_recorder).

Tolerances: losses and metrics to rtol 1e-4, each gradient to 1e-4 of its
tensor's largest component (tests/test_torch_train.py's); the port on a
mesh against one device: rtol 1e-4 and 1e-4 of the largest component
(tests/test_torch_ring_train.py's).
"""

import jax
import numpy as np
import pytest
import torch

from nenbody_tpu.rl import ac as jac
from nenbody_tpu.rl.policy import CentralValueMLP as JCentralValueMLP
from nenbody_tpu.rl.policy import MLPPolicy as JMLPPolicy
from nenbody_tpu.rl.policy import ValueMLP as JValueMLP

from nenbody_tpu_torch.parallel import make_mesh
from nenbody_tpu_torch.rl import ac, train
from nenbody_tpu_torch.rl.policy import CentralValueMLP, MLPPolicy, ValueMLP, seeded
from nenbody_tpu_torch.rl.policy import state_dict_from_flax
from test_torch_train import (B, H, N, _assert_grads, _envs, _grad_recorder, _shared_noise,
                              _shared_spawn)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("central,reward_mode,antialias", [
    (False, "cohesion", False), (True, "team", False), (False, "visibility", True),
])
def test_ac_step_matches_jax(monkeypatch, central, reward_mode, antialias):
    """One AC step with the per-agent value head or the central critic:
    loss, pg_loss, value_loss, reward_mean and every gradient of both heads
    against the JAX step's."""
    jenv, env = _envs(reward_mode, antialias)
    _shared_spawn(monkeypatch, jac, train, seed=21)
    _shared_noise(monkeypatch, jac, train, seed=22)
    opt = _grad_recorder()
    jvalue = JCentralValueMLP(use_bf16=False) if central else JValueMLP(use_bf16=False)
    jts, papply, vapply = jac.init_ac_state(jenv, B, jax.random.key(0), opt,
                                            policy=JMLPPolicy(use_bf16=False), value=jvalue)
    jts2, jm = jax.jit(jac.make_ac_step(jenv, papply, vapply, opt, horizon=H))(jts)

    pol = MLPPolicy(env.obs_width, use_bf16=False)
    value = (CentralValueMLP if central else ValueMLP)(env.obs_width, use_bf16=False)
    for mod, params in ((pol, jts.params["policy"]), (value, jts.params["value"])):
        mod.load_state_dict(state_dict_from_flax(mod, _np(params)))
    ts = ac.init_ac_state(env, B, policy=pol, value=value, device="cpu")
    ts2, m = ac.make_ac_step(env, horizon=H)(ts)
    assert set(m) == set(jm) == {"loss", "pg_loss", "value_loss", "reward_mean"}
    for key in jm:
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    assert float(m["value_loss"]) > 0
    _assert_grads(ts2.policy, jts2.opt_state["policy"], 1e-4)
    _assert_grads(ts2.value, jts2.opt_state["value"], 1e-4)
    assert int(ts2.env_states.t[0]) == H


@pytest.mark.parametrize("mesh_axes,central", [({"data": 2, "agents": 4}, False),
                                               ({"agents": 4}, True)])
def test_ac_on_mesh_matches_one_device(mesh_axes, central):
    """AC with mesh= against one device, same seed (the same spawns and
    noise): metrics and every gradient of both heads; both heads move."""
    mesh = make_mesh(mesh_axes, devices=[CPU] * 8)
    _, env = _envs("visibility", True)
    out = []
    for m in (mesh, None):
        value = seeded(5, lambda: CentralValueMLP(env.obs_width)) if central else None
        ts = ac.init_ac_state(env, 4, seed=3, value=value, device="cpu", mesh=m)
        old = [p.detach().clone() for p in ts.value.parameters()]
        ts, metrics = ac.make_ac_step(env, horizon=2, mesh=m)(ts)
        assert any(not torch.equal(a, b) for a, b in zip(old, ts.value.parameters()))
        out.append((metrics, [p.grad.clone() for mod in (ts.policy, ts.value)
                              for p in mod.parameters()], ts.env_states))
    (m_mesh, g_mesh, s_mesh), (m_one, g_one, s_one) = out
    for key in m_one:
        np.testing.assert_allclose(float(m_mesh[key]), float(m_one[key]), rtol=1e-4, err_msg=key)
    for a, b in zip(g_mesh, g_one):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())
    torch.testing.assert_close(s_mesh.pos, s_one.pos, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="divide evenly"):
        ac.init_ac_state(env, 3, device="cpu", mesh=make_mesh({"data": 2}, devices=[CPU] * 2))
