"""The port's scripted controllers (rl/scripted.py) against the JAX
package's on shared observations, and the geometry pin of
tests/test_rl.py::test_scripted_seek_brightest_geometry.

Tolerance: rtol 1e-5 / atol 1e-6 (the same float32 sums in another order;
atan2, cos and sin of two libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu.rl import scripted as jscripted

from nenbody_tpu_torch import SceneState, SimConfig, VisionConfig
from nenbody_tpu_torch.rl import scripted
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.rl.policy import sample_action

torch.set_num_threads(1)


def _obs(seed, shape=(3, 16), w=32):
    """Eye lines with background 0.2 and bright runs, the ego velocity,
    including stopped agents (velocity 0: they face +x)."""
    rng = np.random.RandomState(seed)
    lines = np.full(shape + (w,), 0.2)
    lines += rng.uniform(0, 0.8, shape + (w,)) * (rng.uniform(size=shape + (w,)) < 0.3)
    vel = rng.uniform(-0.5, 0.5, shape + (2,))
    vel[..., 0, :] = 0.0
    lines[..., 1, :] = 0.2  # blind agents
    return np.concatenate([lines, vel], axis=-1).astype(np.float32)


@pytest.mark.parametrize("name", sorted(scripted.SCRIPTED))
@pytest.mark.parametrize("kw", [{}, {"gain": 0.05, "background": 0.3}])
def test_scripted_controllers_match_jax(name, kw):
    assert set(scripted.SCRIPTED) == set(jscripted.SCRIPTED)
    obs = _obs(1)
    want = np.asarray(jscripted.SCRIPTED[name](jnp.asarray(obs), **kw))
    got = scripted.SCRIPTED[name](torch.from_numpy(obs), **kw).numpy()
    assert got.shape == (3, 16, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_seek_brightest_geometry():
    """A target on the eye's right pulls a seeker right (forward +x, right
    -y in the world), an avoider left; a blind agent emits about zero."""
    env = VisionEnv(SimConfig(n=2, controller="gravity", vision=VisionConfig(width=32)))
    st = SceneState(pos=torch.tensor([[0.0, 0.0], [10.0, -3.0]]),
                    vel=torch.tensor([[1.0, 0.0], [0.0, 0.0]]), t=torch.zeros((), dtype=torch.int32))
    obs = env.observe(st)
    a = scripted.seek_brightest(obs)
    assert a[0, 0] > 0 and a[0, 1] < 0
    assert scripted.avoid_crowding(obs)[0, 1] > 0
    blind = env.observe(st.replace(pos=torch.tensor([[0.0, 0.0], [-10.0, 0.0]])))
    torch.testing.assert_close(scripted.seek_brightest(blind)[0], torch.zeros(2), rtol=0,
                               atol=1e-5)


def test_scripted_policy_plugs_into_sample_action():
    """ScriptedPolicy gives (controller(obs), log_std -8): sampled actions
    sit within a few e^-8 of the controller's (the JAX as_apply_fn)."""
    obs = torch.from_numpy(_obs(2))
    pol = scripted.ScriptedPolicy(scripted.seek_brightest, gain=0.05)
    mean, log_std = pol(obs)
    assert torch.equal(log_std, torch.full((2,), -8.0))
    jmean, jlog_std = jscripted.as_apply_fn(jscripted.seek_brightest, gain=0.05)(
        None, jnp.asarray(obs.numpy()))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(log_std.numpy(), np.asarray(jlog_std))
    action, logp = sample_action(pol, obs, torch.Generator().manual_seed(0))
    assert action.shape == (3, 16, 2) and logp.shape == (3, 16)
    assert (action - mean).abs().max() < 6 * np.exp(-8.0)
