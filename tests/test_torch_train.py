"""The port's REINFORCE and APG trainers and its `train` CLI against the JAX
package's, on shared inputs.

jax.random and torch give different streams, so each parity test patches
the JAX trainers' module attributes with pytest's monkeypatch (their files
are untouched): `spawn_batch` returns one shared numpy batch of env states
on both sides and, for REINFORCE, `sample_action` draws one fixed numpy
noise array. The flax weights cross into the port with
mlp_state_dict_from_flax, in float32 (use_bf16=False). The JAX side runs its
dense backend (plain jnp autodiff, the reference); the port runs its kernel
route, which on the CPU is its autograd Functions over the kernels' plain
versions.

Tolerances: losses, returns and gradient norms to rtol 1e-4 (a few steps of
float32 dynamics and renders, summed in another order). Updated parameters
are compared through the Adam update p_new - p_old, which after one step is
-lr * g / (|g| + eps): held to atol 1e-2 * lr, i.e. the gradients agree in
sign and, where |g| is near eps, in size.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu import state as jstate
from nenbody_tpu.rl import apg as japg
from nenbody_tpu.rl import train as jtrain
from nenbody_tpu.rl.env import VisionEnv as JVisionEnv
from nenbody_tpu.rl.policy import MLPPolicy as JMLPPolicy
from nenbody_tpu.rl.policy import gaussian_log_prob as jgaussian_log_prob

from nenbody_tpu_torch import SceneState, SimConfig, VisionConfig
from nenbody_tpu_torch import cli, profile_train
from nenbody_tpu_torch.rl import apg, train
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.rl.policy import MLPPolicy, gaussian_log_prob, mlp_state_dict_from_flax

torch.set_num_threads(1)

LR = 1e-3
N, W, B, H = 16, 16, 3, 3


def _envs(reward_mode, antialias, n=N, w=W, **env_kw):
    kw = dict(n=n, controller="gravity")
    jenv = JVisionEnv(JSimConfig(**kw, backend="dense",
                                 vision=JVisionConfig(width=w, antialias=antialias)),
                      reward_mode=reward_mode, **env_kw)
    env = VisionEnv(SimConfig(**kw, vision=VisionConfig(width=w, antialias=antialias)),
                    reward_mode=reward_mode, **env_kw)
    return jenv, env


def _shared_spawn(monkeypatch, jmodule, module, seed, b=B, n=N, spread=30.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-spread, spread, (b, n, 2)).astype(np.float32)
    vel = rng.uniform(-0.5, 0.5, (b, n, 2)).astype(np.float32)

    def jspawn(key, cfg, num_envs):
        return jstate.SceneState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                                 key=jax.random.split(jax.random.key(0), num_envs),
                                 t=jnp.zeros(num_envs, jnp.int32))

    def spawn(cfg, generator, num_envs, device="cpu"):
        return SceneState(pos=torch.tensor(pos), vel=torch.tensor(vel),
                          t=torch.zeros(num_envs, dtype=torch.int32))

    monkeypatch.setattr(jmodule, "spawn_batch", jspawn)
    monkeypatch.setattr(module, "spawn_batch", spawn)


def _ported_policy(params, obs_dim):
    """The JAX trainer's initial flax params as the port's float32 MLP."""
    pol = MLPPolicy(obs_dim, use_bf16=False)
    pol.load_state_dict(mlp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return pol


def _assert_updates(policy, old_sd, new_flax_params):
    """The Adam update of every parameter, port against JAX, where the
    gradient's sign is settled: |g| above 1e-3 of its tensor's largest
    component (the float32 sums carry noise of about 1e-5 of that). Below,
    Adam's g / (|g| + eps) turns that noise into a different update, and
    only its bound lr holds."""
    assert all(np.abs(v.numpy()).max() < 8 for v in old_sd.values())
    want_new = mlp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, new_flax_params))
    grads = {k: p.grad for k, p in policy.named_parameters()}
    for name, p in policy.state_dict().items():
        got = (p - old_sd[name]).numpy()
        want = (want_new[name] - old_sd[name]).numpy()
        g = np.abs(grads[name].numpy())
        settled = g > 1e-3 * g.max()
        assert settled.mean() > 0.9 or g.max() == 0, name
        np.testing.assert_allclose(got[settled], want[settled], rtol=0, atol=1e-2 * LR,
                                   err_msg=name)
        # |update| <= lr, up to the rounding of p_new - p_old (|p| < 8)
        assert max(np.abs(got).max(), np.abs(want).max()) <= LR + 1e-6
    assert any((p - old_sd[k]).abs().max() > 0 for k, p in policy.state_dict().items())


@pytest.mark.parametrize("reward_mode,antialias", [("cohesion", False), ("visibility", True)])
def test_reinforce_step_matches_jax(monkeypatch, reward_mode, antialias):
    jenv, env = _envs(reward_mode, antialias)
    _shared_spawn(monkeypatch, jtrain, train, seed=1)
    noise = np.random.RandomState(2).randn(B, N, 2).astype(np.float32)

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
    jts, apply_fn, _ = jtrain.init_train_state(jenv, B, jax.random.key(0), opt,
                                               policy=JMLPPolicy(use_bf16=False))
    jts2, jm = jax.jit(jtrain.make_train_step(jenv, apply_fn, opt, horizon=H))(jts)

    ts = train.init_train_state(env, B, seed=0, lr=LR,
                                policy=_ported_policy(jts.params, env.obs_width), device="cpu")
    old = {k: v.clone() for k, v in ts.policy.state_dict().items()}
    ts2, m = train.make_train_step(env, horizon=H)(ts)
    for key in ("loss", "reward_mean", "return_mean"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    _assert_updates(ts2.policy, old, jts2.params)
    assert ts2.env_states.pos.shape == (B, N, 2) and int(ts2.env_states.t[0]) == H


@pytest.mark.parametrize("reward_mode,diff_vision", [
    ("cohesion", False), ("team", False), ("visibility", True),
])
def test_apg_step_matches_jax(monkeypatch, reward_mode, diff_vision):
    jenv, env = _envs(reward_mode, True, max_accel=1.0, smooth_clip=True)
    _shared_spawn(monkeypatch, japg, apg, seed=3)
    opt = optax.adam(LR)
    jts, apply_fn, _ = japg.init_apg_state(jenv, jax.random.key(0), opt,
                                           policy=JMLPPolicy(use_bf16=False))
    jts2, jm = jax.jit(japg.make_apg_step(jenv, apply_fn, opt, horizon=H, num_envs=B,
                                          diff_vision=diff_vision))(jts)

    ts = apg.init_apg_state(env, seed=0, lr=LR,
                            policy=_ported_policy(jts.params, env.obs_width), device="cpu")
    old = {k: v.clone() for k, v in ts.policy.state_dict().items()}
    ts2, m = apg.make_apg_step(env, horizon=H, num_envs=B, diff_vision=diff_vision)(ts)
    for key in ("loss", "reward_mean", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    assert float(m["grad_norm"]) > 0
    _assert_updates(ts2.policy, old, jts2.params)
    assert ts2.iteration == 1


def _grad_recorder():
    """An optax transformation that applies no update and keeps the last
    gradients as its state: the JAX step's raw parameter gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads), grads),
    )


@pytest.mark.parametrize("reward_mode,diff_vision,n,w,b,h,spread,rtol,gtol", [
    ("cohesion", False, N, W, B, H, 30.0, 1e-4, 1e-4),
    ("visibility", True, N, W, B, H, 30.0, 1e-4, 1e-4),
    # config-5 width (256 agents, 64 px) on 2 envs with the reference spawn
    # range; horizon 1, since from horizon 2 on this gradient is
    # ill-conditioned at this width (PERF.md section 7). Even at horizon 1
    # it moves by about 5e-3 for a 1e-6 relative change of the positions,
    # and the two renderers' AA shades differ by up to 6.8e-5 (XLA
    # contracts the JAX arithmetic): grad_norm to rtol 1e-3 (measured
    # 1.1e-4), each gradient to 1e-2 of its largest component (measured
    # 4.9e-3)
    ("visibility", True, 256, 64, 2, 1, 100.0, 1e-3, 1e-2),
])
def test_apg_step_with_default_actuation_matches_jax(monkeypatch, reward_mode, diff_vision,
                                                     n, w, b, h, spread, rtol, gtol):
    """The CLI's actuation (hard clip at max_accel=0.05), which the parity
    test above replaces with a smooth one. Loss and grad_norm to rtol, and
    every parameter gradient to gtol of its tensor's largest component,
    read from the JAX step through an optimizer that records them."""
    jenv, env = _envs(reward_mode, True, n=n, w=w)
    assert env.max_accel == 0.05 and not env.smooth_clip
    _shared_spawn(monkeypatch, japg, apg, seed=5, b=b, n=n, spread=spread)
    opt = _grad_recorder()
    jts, apply_fn, _ = japg.init_apg_state(jenv, jax.random.key(0), opt,
                                           policy=JMLPPolicy(use_bf16=False))
    jts2, jm = jax.jit(japg.make_apg_step(jenv, apply_fn, opt, horizon=h, num_envs=b,
                                          diff_vision=diff_vision))(jts)
    want = mlp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jts2.opt_state))

    ts = apg.init_apg_state(env, seed=0, lr=LR,
                            policy=_ported_policy(jts.params, env.obs_width), device="cpu")
    _, m = apg.make_apg_step(env, horizon=h, num_envs=b, diff_vision=diff_vision)(ts)
    for key in ("loss", "reward_mean", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=rtol, err_msg=key)
    assert float(m["grad_norm"]) > 0
    for name, p in ts.policy.named_parameters():
        g = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=gtol * np.abs(g).max(),
                                   err_msg=name)


def test_apg_remat_equals_plain_backward():
    _, env = _envs("cohesion", False)
    grads = []
    for remat in (False, True):
        ts = apg.init_apg_state(env, seed=4, lr=LR, device="cpu")
        _, m = apg.make_apg_step(env, horizon=H, num_envs=B, remat=remat)(ts)
        grads.append(float(m["grad_norm"]))
    assert grads[0] > 0
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)


def test_apg_diff_vision_gradient_is_load_bearing():
    """With an observation-defined reward, semi-APG (perception rendered
    without grad) has exactly zero gradient; diff_vision makes it finite and
    nonzero: the eye's backward is the only gradient path (the port's twin
    of test_diff_vision.py::test_apg_diff_vision_gradient_is_load_bearing)."""
    env = VisionEnv(SimConfig(n=16, controller="gravity",
                              vision=VisionConfig(width=16, antialias=True)),
                    max_accel=1.0, smooth_clip=True, reward_mode="visibility")
    norms = {}
    for diff in (False, True):
        ts = apg.init_apg_state(env, seed=0, lr=LR, policy=MLPPolicy(env.obs_width, use_bf16=False),
                                device="cpu")
        _, m = apg.make_apg_step(env, horizon=4, num_envs=8, diff_vision=diff)(ts)
        norms[diff] = float(m["grad_norm"])
    assert norms[False] == 0.0, f"stop-gradient APG leaked: {norms[False]}"
    assert np.isfinite(norms[True]) and norms[True] > 0.0, norms[True]


def test_torch_adam_equals_optax_adam():
    """torch.optim.Adam with its default eps makes optax.adam's update."""
    rng = np.random.RandomState(6)
    p0 = rng.randn(5, 3).astype(np.float32)
    grads = rng.randn(4, 5, 3).astype(np.float32)
    opt = optax.adam(LR)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    p = torch.nn.Parameter(torch.tensor(p0))
    topt = torch.optim.Adam([p], lr=LR)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        p.grad = torch.tensor(g)
        topt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_train_states_are_seeded_and_mesh_waits_for_the_ring():
    _, env = _envs("cohesion", False)
    a = train.init_train_state(env, 2, seed=9, device="cpu")
    b = train.init_train_state(env, 2, seed=9, device="cpu")
    assert torch.equal(a.env_states.pos, b.env_states.pos)
    for (_, x), (_, y) in zip(a.policy.state_dict().items(), b.policy.state_dict().items()):
        assert torch.equal(x, y)
    assert apg.init_apg_state(env, seed=9, device="cpu").policy.state_dict()["head.weight"].equal(
        a.policy.state_dict()["head.weight"])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 17"):
        train.make_train_step(env, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 17"):
        apg.make_apg_step(env, mesh=object())


@pytest.mark.parametrize("algo", ["reinforce", "apg"])
def test_train_cli_runs_on_cpu(capsys, algo):
    rc = cli.main(["train", "--algo", algo, "--device", "cpu", "--envs", "2", "--agents", "12",
                   "--vision-width", "16", "--horizon", "3", "--iters", "2", "--antialias"])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["iter"] for r in lines] == [0, 1]
    keys = {"loss", "reward_mean", "iter", "sec", "agent_frames"}
    keys |= {"grad_norm"} if algo == "apg" else {"return_mean"}
    for row in lines:
        assert set(row) == keys and row["agent_frames"] == 2 * 12 * 3
        assert all(np.isfinite(v) for v in row.values())


@pytest.mark.parametrize("argv,item", [
    (["--algo", "ppo"], "item 13"), (["--algo", "ac"], "item 13"), (["--algo", "es"], "item 13"),
    (["--algo", "reinforce-gru"], "item 13"),
])
def test_train_cli_names_the_roadmap_item_of_what_is_not_ported(capsys, argv, item):
    assert cli.main(["train", "--device", "cpu", *argv]) == 2
    err = capsys.readouterr().err
    assert "ROADMAP" in err and item in err


def test_profile_train_runs_on_cpu(tmp_path, capsys):
    """The training profiler (python -m nenbody_tpu_torch.profile_train)
    at a tiny size on the CPU: host times for all three trainers, no device
    events and no kernel launches there."""
    out = tmp_path / "prof.json"
    assert profile_train.main(["--device", "cpu", "--envs", "2", "--agents", "12",
                               "--vision-width", "16", "--horizon", "2", "--warmup", "1",
                               "--runs", "2", "--out", str(out)]) == 0
    result = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == result
    assert result["card"] == "cpu" and set(result["trainers"]) == {
        "reinforce", "apg", "apg_diff_vision"}
    for row in result["trainers"].values():
        assert len(row["runs"]) == 2 and row["median_s"] > 0 and row["device_ms"] == {}
        assert row["busy"] == 0.0 and row["peak_gib"] is None
        assert all(c == 0 for c in row["launches"].values())
    assert profile_train.category("disc_eye_bwd_kernel") == "disc_eye_bwd_kernel"
    assert profile_train.category("sm90_xmma_gemm_bf16") == "gemm"
    assert profile_train.category("vectorized_elementwise_kernel") == profile_train.OTHER
