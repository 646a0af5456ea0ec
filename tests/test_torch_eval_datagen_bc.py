"""The port's `eval`, `datagen` (rl/datagen.py) and `bc` (rl/bc.py) against
the JAX package's, on shared spawns and patched noise.

jax.random and torch give different streams, so the parity tests patch the
random draws with pytest's monkeypatch (the JAX files are untouched): the
spawns (`nenbody_tpu.state.spawn_batch`, `nenbody_tpu.rl.datagen.
spawn_batch`; the port's `cli.spawn_eval_states`, `rl.datagen.spawn_batch`),
datagen's uniform actions (`jax.random.uniform`; the port's
`datagen._random_action`) and BC's minibatch indices (`jax.random.randint`;
the port's `bc._minibatch`). Nets run in float32 (use_bf16=False) where
values are compared.

Tolerances: observations as the slice's (rtol 1e-5, atol 1e-5), rewards and
eval's means rtol 1e-5 / atol 1e-6 (a few float32 steps summed in another
order), datagen's actions exactly (the same noise through the same
arithmetic); BC after 4 Adam steps: the final loss to rtol 1e-4 and each
parameter's update to atol 1e-6 (1.2e-7 measured: Adam's lr * g / (|g| +
eps) rounds apart only where |g| nears eps, ROADMAP queue 3's Adam
allowance, which this dataset's gradients stay far from); inverse dynamics
(a = (v' - v)/dt - g(x)) to atol 1e-5, its 1/dt = 10 amplifying the
velocities' float32 rounding.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu import cli as jcli
from nenbody_tpu import state as jstate
from nenbody_tpu.rl import bc as jbc
from nenbody_tpu.rl import datagen as jdg
from nenbody_tpu.rl.env import VisionEnv as JVisionEnv
from nenbody_tpu.rl.policy import MLPPolicy as JMLPPolicy
from nenbody_tpu.utils import checkpoint as jck

from nenbody_tpu_torch import SceneState, SimConfig, VisionConfig, cli
from nenbody_tpu_torch.rl import bc, datagen, scripted
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.rl.policy import MLPPolicy, state_dict_from_flax
from nenbody_tpu_torch.utils import native

torch.set_num_threads(1)

N, W, B = 8, 16, 2
OBS_TOL = dict(rtol=1e-5, atol=1e-5)
REWARD_TOL = dict(rtol=1e-5, atol=1e-6)


def _envs(reward_mode="cohesion", **vision):
    kw = dict(n=N, controller="gravity")
    return (JVisionEnv(JSimConfig(**kw, vision=JVisionConfig(width=W, **vision)),
                       reward_mode=reward_mode),
            VisionEnv(SimConfig(**kw, vision=VisionConfig(width=W, **vision)),
                      reward_mode=reward_mode))


def _spawn_arrays(seed, b=B, n=N, spread=30.0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-spread, spread, (b, n, 2)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (b, n, 2)).astype(np.float32))


def _jax_spawn(pos, vel):
    def spawn(key, cfg, num_envs):
        return jstate.SceneState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                                 key=jax.random.split(jax.random.key(0), num_envs),
                                 t=jnp.zeros(num_envs, jnp.int32))
    return spawn


def _port_spawn(pos, vel):
    return SceneState(pos=torch.tensor(pos), vel=torch.tensor(vel),
                      t=torch.zeros(pos.shape[0], dtype=torch.int32))


def _last_json(capsys):
    return json.loads([x for x in capsys.readouterr().out.splitlines() if x.startswith("{")][-1])


@pytest.mark.parametrize("case", ["zero-action", "mlp", "visibility"])
def test_eval_matches_the_jax_eval(tmp_path, monkeypatch, capsys, case):
    pos, vel = _spawn_arrays(0)
    monkeypatch.setattr(jstate, "spawn_batch", _jax_spawn(pos, vel))
    monkeypatch.setattr(cli, "spawn_eval_states", lambda env, seed, b, dev: _port_spawn(pos, vel))
    argv = ["eval", "--envs", str(B), "--agents", str(N), "--vision-width", str(W),
            "--horizon", "4"]
    if case == "visibility":
        argv += ["--reward-mode", "visibility"]
    if case == "mlp":
        import functools

        from nenbody_tpu.rl import policy as jpolicy
        from nenbody_tpu_torch.rl import policy as tpolicy

        monkeypatch.setattr(jpolicy, "MLPPolicy", functools.partial(JMLPPolicy, use_bf16=False))
        monkeypatch.setattr(tpolicy, "MLPPolicy", functools.partial(MLPPolicy, use_bf16=False))
        params = JMLPPolicy().init(jax.random.key(3), jnp.zeros((1, W + 2)))
        argv += ["--policy", jck.save_pytree(str(tmp_path / "p.npz"), params)]
    assert jcli.main(argv) == 0
    want = _last_json(capsys)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want) == {"reward_mean", "reward_first", "reward_final",
                                     "reward_mode", "horizon", "envs", "agents", "policy"}
    for k in ("reward_mean", "reward_first", "reward_final"):
        np.testing.assert_allclose(got[k], want[k], **REWARD_TOL, err_msg=k)
    assert {k: got[k] for k in ("reward_mode", "horizon", "envs", "agents", "policy")} == \
        {k: want[k] for k in ("reward_mode", "horizon", "envs", "agents", "policy")}


def _shared_datagen(monkeypatch, seed=1):
    """Shared spawns and one fixed uniform noise array for both collectors."""
    pos, vel = _spawn_arrays(seed)
    u = np.random.RandomState(seed + 10).uniform(0, 1, (B, N, 2)).astype(np.float32)
    monkeypatch.setattr(jdg, "spawn_batch", _jax_spawn(pos, vel))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, minval, maxval: minval + (maxval - minval) * jnp.asarray(u))
    monkeypatch.setattr(datagen, "spawn_batch", lambda cfg, gen, b, dev: _port_spawn(pos, vel))
    monkeypatch.setattr(datagen, "_random_action",
                        lambda shape, a, gen: torch.tensor(u) * (2.0 * a) - a)


def _float(x):
    """A shard's array as float32 (bfloat16 obs load back as 2-byte voids)."""
    import ml_dtypes

    return x.view(ml_dtypes.bfloat16).astype(np.float32) if x.dtype == np.dtype("V2") else x


@pytest.mark.parametrize("obs_dtype", ["float32", "bfloat16"])
def test_datagen_shards_match_the_jax_collect(tmp_path, monkeypatch, obs_dtype):
    """3 steps at horizon 2 (2 shards, the last one full, as the JAX
    collector writes it): the JAX keys, shapes, dtypes and names, and the
    values on shared spawns and noise (bfloat16 obs to one bf16 ulp, 2^-8,
    since a float32 difference of 1e-5 may round either way); each
    package's load_shards reads the other's directory."""
    _shared_datagen(monkeypatch)
    jenv, env = _envs()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jchunks = list(jdg.collect(jenv, num_envs=B, total_steps=3, key=jax.random.key(0),
                               horizon=2, out_dir=jdir, obs_dtype=getattr(jnp, obs_dtype)))
    chunks = list(datagen.collect(env, B, 3, horizon=2, out_dir=tdir, device="cpu",
                                  obs_dtype=getattr(torch, obs_dtype)))
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == ["shard_00000.npz",
                                                                    "shard_00001.npz"]
    assert [i for i, _ in chunks] == [i for i, _ in jchunks] == [0, 1]
    for name in os.listdir(jdir):
        with np.load(os.path.join(jdir, name)) as a, np.load(os.path.join(tdir, name)) as b:
            assert sorted(a.files) == sorted(b.files) == ["action", "obs", "reward"]
            for k in a.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            np.testing.assert_allclose(_float(b["obs"]), _float(a["obs"]), atol=1e-5,
                                       rtol=1e-5 if obs_dtype == "float32" else 2 ** -8)
            np.testing.assert_array_equal(b["action"], a["action"])
            np.testing.assert_allclose(b["reward"], a["reward"], **REWARD_TOL)
    assert chunks[0][1]["obs"].shape == (2, B, N, W + 2)
    for mine, theirs in ((datagen.load_shards(jdir), jdg.load_shards(jdir)),
                         (jdg.load_shards(tdir), datagen.load_shards(tdir))):
        for k in ("obs", "action", "reward"):
            assert mine[k].dtype == theirs[k].dtype and np.array_equal(mine[k], theirs[k]), k
    with pytest.raises(FileNotFoundError, match="no shard"):
        datagen.load_shards(str(tmp_path))


def test_fit_matches_the_jax_fit(monkeypatch):
    """bc.fit on one dataset from the JAX fit's initial weights, with one
    minibatch order on both sides."""
    rng = np.random.RandomState(2)
    data = {"obs": rng.uniform(-1, 1, (3, B, N, W + 2)).astype(np.float32),
            "action": rng.uniform(-0.1, 0.1, (3, B, N, 2)).astype(np.float32)}
    idx = rng.randint(0, 3 * B * N, 16)
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.asarray(idx))
    monkeypatch.setattr(bc, "_minibatch", lambda n, size, gen: torch.tensor(idx))
    jenv, env = _envs()
    key = jax.random.key(5)
    jpol = JMLPPolicy(use_bf16=False)
    params0 = jpol.init(jax.random.split(key)[0], jnp.asarray(data["obs"].reshape(-1, W + 2)[:1]))
    pol = MLPPolicy(W + 2, use_bf16=False)
    pol.load_state_dict(state_dict_from_flax(pol, jax.tree_util.tree_map(np.asarray, params0)))
    old = {k: v.clone() for k, v in pol.state_dict().items()}
    steps, lr = 4, 1e-3
    jparams, _, jloss = jbc.fit(jenv, data, key, steps=steps, batch_size=16, lr=lr, policy=jpol)
    pol, loss = bc.fit(env, data, steps=steps, batch_size=16, lr=lr, policy=pol, device="cpu")
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    want = state_dict_from_flax(pol, jax.tree_util.tree_map(np.asarray, jparams))
    for name, p in pol.state_dict().items():
        np.testing.assert_allclose((p - old[name]).numpy(), (want[name] - old[name]).numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert max((p - old[k]).abs().max() for k, p in pol.state_dict().items()) > 0


@pytest.fixture
def recorder():
    assert native.build()
    return native.TrajectoryRecorder


def test_dataset_from_trajectory_matches_the_jax_one(tmp_path, recorder):
    """One recording of an actuated run (written by the port's recorder)
    through both packages' inverse dynamics and re-render; the recovered
    actions are the actuated ones."""
    jenv, env = _envs()
    pos, vel = _spawn_arrays(4, b=1)
    state = SceneState(pos=torch.tensor(pos[0]), vel=torch.tensor(vel[0]),
                       t=torch.tensor(0, dtype=torch.int32))
    rng = np.random.RandomState(5)
    path = str(tmp_path / "run.nentraj")
    actions = []
    with recorder(path, N) as rec:
        rec.append(0, state.pos.numpy(), state.vel.numpy())
        for t in range(1, 7):
            a = env.actuate(torch.tensor(rng.uniform(-0.04, 0.04, (N, 2)).astype(np.float32)))
            actions.append(a.numpy())
            state = env.dynamics(state, a)
            rec.append(t, state.pos.numpy(), state.vel.numpy())
    got = bc.dataset_from_trajectory(path, env, chunk=4, device="cpu")
    want = jbc.dataset_from_trajectory(path, jenv, chunk=4)
    assert got["obs"].shape == want["obs"].shape == (6, 1, N, W + 2)
    assert got["action"].shape == want["action"].shape == (6, 1, N, 2)
    np.testing.assert_allclose(got["obs"], want["obs"], **OBS_TOL)
    np.testing.assert_allclose(got["action"], want["action"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["action"][:, 0], np.stack(actions), rtol=0, atol=1e-5)


def test_dataset_from_trajectory_refuses_strided_recordings(tmp_path, recorder):
    _, env = _envs()
    path = str(tmp_path / "strided.nentraj")
    z = np.zeros((N, 2), np.float32)
    with recorder(path, N) as rec:
        for t in (0, 5, 10):  # stride 5: inverse dynamics ill-posed
            rec.append(t, z, z)
    with pytest.raises(ValueError, match="log-every 1"):
        bc.dataset_from_trajectory(path, env, device="cpu")
    one = str(tmp_path / "one.nentraj")
    with recorder(one, N) as rec:
        rec.append(0, z, z)
    with pytest.raises(ValueError, match=">= 2 frames"):
        bc.dataset_from_trajectory(one, env, device="cpu")


def _tiny_env():
    return VisionEnv(SimConfig(n=8, controller="gravity", backend="dense",
                               vision=VisionConfig(width=16, far=300.0)))


def test_distill_learns_a_scripted_teacher():
    """Mirrors tests/test_distill.py: the log-density objective improves by
    more than 1 over the run, and the student's mean tracks the teacher on
    fresh states better than the zero predictor."""
    env = _tiny_env()
    teacher = lambda obs: scripted.seek_brightest(obs, gain=0.8)  # noqa: E731
    policy, losses = bc.distill(env, teacher, seed=0, iters=16, num_envs=4, horizon=4,
                                bc_steps_per_iter=32, batch_size=256, lr=3e-3,
                                policy=MLPPolicy(env.obs_width, hidden=(32, 32)), device="cpu")
    assert losses.shape == (16 * 32,)
    first, last = losses[:32].mean(), losses[-32:].mean()
    assert last < first - 1.0, (first, last)
    gen = torch.Generator().manual_seed(9)
    from nenbody_tpu_torch.state import spawn_batch

    obs = env.observe(spawn_batch(env.cfg, gen, 4, "cpu")).reshape(-1, env.obs_width)
    with torch.no_grad():
        want, got = teacher(obs), policy(obs)[0]
    resid, base = ((got - want) ** 2).mean().item(), (want ** 2).mean().item()
    assert resid < 0.7 * base, (resid, base)


def test_distill_persistent_envs_run():
    env = _tiny_env()
    _, losses = bc.distill(env, scripted.avoid_crowding, seed=1, iters=2, num_envs=2, horizon=3,
                           bc_steps_per_iter=4, batch_size=64,
                           policy=MLPPolicy(env.obs_width, hidden=(16,)), episodic=False,
                           device="cpu")
    assert losses.shape == (8,) and np.isfinite(losses).all()


class _Behavior(torch.nn.Module):
    """The scripted teacher as a near-deterministic Gaussian behavior."""

    def forward(self, obs):
        mean = scripted.seek_brightest(obs, gain=0.8)
        return mean, torch.full((2,), -4.0)


def test_fit_streaming_from_device_chunks():
    """Mirrors tests/test_distill.py's fit_streaming case: BC from the
    datagen collector's chunks, the objective improving by more than 1."""
    env = _tiny_env()
    _, losses = bc.fit_streaming(env, seed=1, total_steps=64, num_envs=4, horizon=8,
                                 behavior=_Behavior(), bc_steps_per_shard=32, batch_size=256,
                                 lr=3e-3, policy=MLPPolicy(env.obs_width, hidden=(32, 32)),
                                 device="cpu")
    assert losses.shape == (8 * 32,)
    first, last = losses[:32].mean(), losses[-32:].mean()
    assert last < first - 1.0, (first, last)


def test_datagen_bc_eval_cli_pipeline(tmp_path, capsys):
    """datagen -> bc --data -> eval --policy, and datagen --policy, all
    through the port's CLI on the CPU; bc's save loads like any params npz."""
    base = ["--device", "cpu", "--agents", str(N), "--vision-width", str(W)]
    ds = str(tmp_path / "ds")
    assert cli.main(["datagen", *base, "--envs", "2", "--steps", "4", "--horizon", "2",
                     "--out-dir", ds]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rows == [{"shard": 0, "obs_shape": [2, 2, N, W + 2], "agent_frames_total": 2 * 2 * N},
                    {"shard": 1, "obs_shape": [2, 2, N, W + 2], "agent_frames_total": 4 * 2 * N}]
    params = str(tmp_path / "bc.npz")
    assert cli.main(["bc", *base, "--data", ds, "--steps", "5", "--batch-size", "32",
                     "--save", params]) == 0
    out = capsys.readouterr().out.splitlines()
    assert np.isfinite(json.loads(out[0])["bc_loss"]) and out[1] == f"saved params -> {params}"
    assert cli.main(["eval", *base, "--envs", "2", "--horizon", "2", "--policy", params]) == 0
    assert np.isfinite(_last_json(capsys)["reward_mean"])
    assert cli.main(["datagen", *base, "--envs", "2", "--steps", "2", "--horizon", "2",
                     "--out-dir", str(tmp_path / "ds2"), "--policy", params]) == 0


@pytest.mark.parametrize("argv,message", [
    ([], "exactly one of --data"),
    (["--data", "d", "--trajectory", "t.nentraj"], "exactly one of --data"),
    (["--data", "no/such/dir"], "No such file"),
], ids=["neither", "both", "missing-dir"])
def test_bc_flag_errors(capsys, argv, message):
    assert cli.main(["bc", "--device", "cpu", *argv]) == 2
    assert message in capsys.readouterr().err


def test_bc_refuses_recurrent_policies(capsys):
    """The JAX `bc` parser takes --net mlp|conv only, and its command
    refuses gru as well (cli.py:604-607): both are kept."""
    with pytest.raises(SystemExit) as e:
        cli.main(["bc", "--device", "cpu", "--data", "d", "--net", "gru"])
    assert e.value.code == 2
    args = type("Args", (), dict(data="d", trajectory="", net="gru"))()
    assert cli.cmd_bc(args) == 2
    assert "bc fits feedforward policies" in capsys.readouterr().err
