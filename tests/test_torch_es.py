"""The port's evolution strategies (rl/es.py) against the JAX package's, on
shared inputs; the twin of tests/test_rl.py's ES tests.

Monkeypatch gives both packages one numpy batch of spawned env states
(`spawn_batch`) and one noise draw: the JAX step draws one
`jax.random.normal` array per flax leaf (sorted keys: Dense_0/bias,
Dense_0/kernel, ..., log_std), the port one `_noise` tensor per parameter
(`parameters()` order, kernels transposed), so the test makes the flax
tree and crosses each member's slice with state_dict_from_flax. The JAX
step's gradient is read through an optimizer that records it.

The gradient weighs the noise by the members' fitness differences, so the
parity steps take sigma 0.5 and actions up to 1.0: at the CLI's sigma 0.02
and 0.05 clip those differences are about 1e-6 of the fitness, near float32
rounding, and the two estimators would differ by their rounding alone.

Tolerances: fitness and grad_norm to rtol 1e-4, each gradient to 1e-4 of
its tensor's largest component (tests/test_torch_train.py's), and so the
port on a mesh against one device (the same spawns and noise on both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu.rl import es as jes
from nenbody_tpu.rl.policy import ConvPolicy as JConvPolicy
from nenbody_tpu.rl.policy import MLPPolicy as JMLPPolicy

from nenbody_tpu_torch.parallel import make_mesh
from nenbody_tpu_torch.rl import es
from nenbody_tpu_torch.rl.policy import ConvPolicy, MLPPolicy, state_dict_from_flax
from test_torch_train import B, H, N, W, _assert_grads, _envs, _grad_recorder, _shared_spawn

torch.set_num_threads(1)

CPU = torch.device("cpu")
P = 2
SIGMA = 0.5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("net,reward_mode", [("mlp", "cohesion"), ("conv", "visibility")])
def test_es_step_matches_jax(monkeypatch, net, reward_mode):
    """One ES generation (P = 2 antithetic pairs, shared spawns): fitness
    mean and best, grad_norm and the gradient against the JAX step's."""
    jenv, env = _envs(reward_mode, reward_mode == "visibility", max_accel=1.0)
    _shared_spawn(monkeypatch, jes, es, seed=31)
    opt = _grad_recorder()
    jpol = (JMLPPolicy(use_bf16=False) if net == "mlp"
            else JConvPolicy(vision_width=W, channels=(4, 8), hidden=16, use_bf16=False))
    jts, apply_fn, _ = jes.init_es_state(jenv, jax.random.key(0), opt, policy=jpol)
    pol = (MLPPolicy(env.obs_width, use_bf16=False) if net == "mlp"
           else ConvPolicy(env.obs_width, W, channels=(4, 8), hidden=16, use_bf16=False))
    pol.load_state_dict(state_dict_from_flax(pol, _np(jts.params)))

    rng = np.random.RandomState(32)
    eps_tree = jax.tree_util.tree_map(
        lambda x: rng.randn(P, *x.shape).astype(np.float32), _np(jts.params))
    leaves = jax.tree_util.tree_leaves(eps_tree)
    drawn = []

    def normal(key, shape, dtype):
        out = leaves[len(drawn)]
        assert out.shape == tuple(shape)
        drawn.append(shape)
        return jnp.asarray(out)

    members = [state_dict_from_flax(pol, jax.tree_util.tree_map(lambda e: e[i], eps_tree))
               for i in range(P)]
    eps = [torch.stack([sd[name] for sd in members]) for name, _ in pol.named_parameters()]
    monkeypatch.setattr(es, "_noise", lambda params, population, generator: eps)
    monkeypatch.setattr(jax.random, "normal", normal)
    jts2, jm = jax.jit(jes.make_es_step(jenv, apply_fn, opt, horizon=H, population=P,
                                        num_envs=B, sigma=SIGMA))(jts)
    assert len(drawn) == len(leaves)

    ts = es.init_es_state(env, policy=pol, device="cpu")
    ts2, m = es.make_es_step(env, horizon=H, population=P, num_envs=B, sigma=SIGMA)(ts)
    assert set(m) == set(jm) == {"fitness_mean", "fitness_best", "grad_norm"}
    for key in jm:
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    assert float(m["grad_norm"]) > 0 and ts2.generation == 1
    _assert_grads(ts2.policy, jts2.opt_state, 1e-4)


@pytest.mark.parametrize("mesh_axes", [{"data": 2, "agents": 4}, {"agents": 4}])
def test_es_on_mesh_matches_one_device(mesh_axes):
    """ES with mesh= (each member's rollout on the ring) against one
    device, same seed: the same spawns and noise, so the same fitness and
    gradient; two generations, the parameters moved."""
    mesh = make_mesh(mesh_axes, devices=[CPU] * 8)
    _, env = _envs("cohesion", False, max_accel=1.0)
    out = []
    for m in (mesh, None):
        ts = es.init_es_state(env, seed=2, device="cpu")
        old = [p.detach().clone() for p in ts.policy.parameters()]
        step = es.make_es_step(env, horizon=2, population=P, num_envs=4, sigma=SIGMA, mesh=m)
        ts, _ = step(ts)
        ts, metrics = step(ts)
        assert ts.generation == 2
        assert any(not torch.equal(a, b) for a, b in zip(old, ts.policy.parameters()))
        out.append((metrics, [p.grad.clone() for p in ts.policy.parameters()]))
    (m_mesh, g_mesh), (m_one, g_one) = out
    for key in m_one:
        np.testing.assert_allclose(float(m_mesh[key]), float(m_one[key]), rtol=1e-4, err_msg=key)
    for a, b in zip(g_mesh, g_one):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())
    with pytest.raises(ValueError, match="divide evenly"):
        es.make_es_step(env, num_envs=3, mesh=make_mesh({"data": 2}, devices=[CPU] * 2))
