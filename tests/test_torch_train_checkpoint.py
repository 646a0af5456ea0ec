"""`train --save/--checkpoint/--checkpoint-every/--resume` of the port's CLI
(utils.checkpoint.train_state_tree), and policy params files crossing
between the two packages.

Tolerances: resuming is held bit for bit (the CPU runs one deterministic
order). Action means of one params file through the two packages' nets:
float32 nets (use_bf16=False) to rtol 1e-5 / atol 1e-6 (one matmul order
against another); the default bfloat16 hidden layers to atol 2e-2 of an
action (5.2e-3 measured on means up to 1.1: XLA and PyTorch round a bf16
product one ulp, 2^-8, apart now and then, and the head sums 128 such
units).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu import cli as jcli
from nenbody_tpu.rl import policy as jpolicy
from nenbody_tpu.rl import train as jtrain
from nenbody_tpu.rl.env import VisionEnv as JVisionEnv
from nenbody_tpu.utils import checkpoint as jck

from nenbody_tpu_torch import SimConfig, VisionConfig, cli
from nenbody_tpu_torch.rl import policy as tpolicy
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)

N, W = 8, 16
BASE = ["train", "--device", "cpu", "--envs", "2", "--agents", str(N), "--vision-width",
        str(W), "--horizon", "2"]
TRAINERS = {
    "reinforce": [], "reinforce-gru": ["--algo", "reinforce-gru"], "ppo": ["--algo", "ppo"],
    "ac": ["--algo", "ac"], "es": ["--algo", "es", "--population", "2"], "apg": ["--algo", "apg"],
    "ppo-central-conv": ["--algo", "ppo", "--critic", "central", "--net", "conv"],
}


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("trainer", list(TRAINERS))
def test_resumed_training_equals_uninterrupted(tmp_path, capsys, trainer):
    """2 iterations equal 1 iteration, --checkpoint, then --resume for 1:
    the saved policy and the whole final train state (modules, optimizer
    state, env states, generator, iteration), bit for bit."""
    argv = BASE + TRAINERS[trainer]
    p = {k: str(tmp_path / k) for k in ("a.npz", "a_ts.npz", "mid.npz", "b.npz", "b_ts.npz")}
    assert cli.main(argv + ["--iters", "2", "--save", p["a.npz"], "--checkpoint", p["a_ts.npz"]]) == 0
    assert cli.main(argv + ["--iters", "1", "--checkpoint", p["mid.npz"]]) == 0
    assert cli.main(argv + ["--iters", "1", "--resume", p["mid.npz"], "--save", p["b.npz"],
                            "--checkpoint", p["b_ts.npz"]]) == 0
    for x, y in (("a.npz", "b.npz"), ("a_ts.npz", "b_ts.npz")):
        a, b = _npz(p[x]), _npz(p[y])
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), (x, k)
    leaves = _npz(p["a_ts.npz"])
    assert "['generator']" in leaves and any(k.startswith("['optimizer']['state']") for k in leaves)
    assert any(k.endswith("['exp_avg']") for k in leaves)
    if trainer in ("reinforce", "reinforce-gru", "ac"):
        assert leaves["['env_states']['pos']"].shape == (2, N, 2)
    if trainer in ("ppo", "apg"):
        assert int(leaves["['iteration']"]) == 2
    if trainer == "es":
        assert int(leaves["['generation']"]) == 2
    lines = [x for x in capsys.readouterr().out.splitlines() if not x.startswith("{")]
    assert lines == [f"saved params -> {p['a.npz']}", f"saved params -> {p['b.npz']}"]


def test_periodic_checkpoint_fires_as_the_jax_command_pins(tmp_path, monkeypatch):
    """--checkpoint-every 1 over 2 iterations saves at i = 0, i = 1 and once
    at the end: 3 writes (JAX tests/test_cli.py:264-296); 50 over 2 saves
    only the final state."""
    saves = []
    orig = ck.save_pytree
    monkeypatch.setattr(ck, "save_pytree",
                        lambda path, tree: (saves.append(path), orig(path, tree))[1])
    every1, every50 = str(tmp_path / "e1.npz"), str(tmp_path / "e50.npz")
    assert cli.main(BASE + ["--iters", "2", "--checkpoint", every1, "--checkpoint-every", "1"]) == 0
    assert cli.main(BASE + ["--iters", "2", "--checkpoint", every50]) == 0
    assert saves.count(every1) == 3 and saves.count(every50) == 1


def _envs():
    jenv = JVisionEnv(JSimConfig(n=N, controller="gravity", vision=JVisionConfig(width=W)))
    env = VisionEnv(SimConfig(n=N, controller="gravity", vision=VisionConfig(width=W)))
    return jenv, env


def _obs(seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.uniform(0.2, 1.0, (3, N, W)), rng.uniform(-0.5, 0.5, (3, N, 2))],
                          axis=-1).astype(np.float32)


def _means(net, path, obs, jenv, env):
    """Action means of the params at `path` through the JAX `_load_policy`
    and the port's, on obs [3, N, W+2] (the GRU from a zero carry)."""
    jpol, jparams = jcli._load_policy(jenv, path, net)
    pol = cli._load_policy(env, path, net, "cpu")
    with torch.no_grad():
        if net == "gru":
            want = jpol.apply(jparams, jpol.initial_carry(obs.shape[:-1]), jnp.asarray(obs))[1][0]
            got = pol(pol.initial_carry(obs.shape[:-1], "cpu"), torch.tensor(obs))[1][0]
        else:
            want = jpol.apply(jparams, jnp.asarray(obs))[0]
            got = pol(torch.tensor(obs))[0]
    return got.numpy(), np.asarray(want)


@pytest.fixture
def nets_in(monkeypatch, request):
    """Both packages' policy families built with use_bf16=request.param."""
    for module in (jpolicy, tpolicy):
        for name in ("MLPPolicy", "ConvPolicy", "GRUPolicy"):
            monkeypatch.setattr(module, name,
                                functools.partial(getattr(module, name), use_bf16=request.param))
    return request.param


def _close(got, want, bf16):
    if bf16:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nets_in", [False, True], ids=["fp32", "bf16"], indirect=True)
@pytest.mark.parametrize("net,algo", [("mlp", []), ("conv", ["--net", "conv"]),
                                      ("gru", ["--algo", "reinforce-gru"])])
def test_port_save_plays_back_in_the_jax_package(tmp_path, net, algo, nets_in):
    """`train --save` of the port loads into the JAX `_load_policy` and gives
    the port's action means."""
    path = str(tmp_path / "p.npz")
    assert cli.main(BASE + algo + ["--iters", "1", "--save", path]) == 0
    jenv, env = _envs()
    _close(*_means(net, path, _obs(), jenv, env), nets_in)


@pytest.mark.parametrize("nets_in", [False, True], ids=["fp32", "bf16"], indirect=True)
@pytest.mark.parametrize("net", ["mlp", "conv", "gru"])
def test_jax_params_play_back_in_the_port(tmp_path, net, nets_in):
    """A JAX params file (save_pytree of the flax params, as the JAX `train
    --save` writes it) loads into the port with the JAX action means; the
    port's flax_from_state_dict gives back the file's arrays exactly."""
    dummy = jnp.zeros((1, W + 2), jnp.float32)
    cls = {"mlp": jpolicy.MLPPolicy, "conv": functools.partial(jpolicy.ConvPolicy, vision_width=W),
           "gru": jpolicy.GRUPolicy}[net]
    pol = cls()
    args = (pol.initial_carry((1,)), dummy) if net == "gru" else (dummy,)
    params = jax.tree_util.tree_map(lambda x: x + 0.01, pol.init(jax.random.key(2), *args))
    path = jck.save_pytree(str(tmp_path / "j.npz"), params)
    jenv, env = _envs()
    _close(*_means(net, path, _obs(1), jenv, env), nets_in)
    ported = ck.save_pytree(str(tmp_path / "t.npz"),
                            tpolicy.flax_from_state_dict(cli._load_policy(env, path, net, "cpu")))
    a, b = _npz(path), _npz(ported)
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_resume_refuses_a_mismatched_checkpoint(tmp_path, capsys):
    """Another --agents, another --algo, or a JAX train checkpoint (a
    jax.random key and optax state have no torch counterpart): rc 2 with
    the strict match's error and the JAX hint; a missing file: rc 2."""
    ts = str(tmp_path / "ts.npz")
    assert cli.main(BASE + ["--iters", "1", "--checkpoint", ts]) == 0
    capsys.readouterr()
    env = JVisionEnv(JSimConfig(n=N, controller="gravity", vision=JVisionConfig(width=W)))
    jts, _, _ = jtrain.init_train_state(env, num_envs=2, key=jax.random.key(0),
                                        optimizer=optax.adam(1e-3))
    jax_ts = jck.save_pytree(str(tmp_path / "jax_ts.npz"), jts)
    for argv, message in (  # a repeated flag takes its last value
        (["--agents", "12", "--resume", ts], "has shape"),
        (["--algo", "ppo", "--resume", ts], "do not contain leaf"),
        (["--resume", jax_ts], "do not contain leaf"),
    ):
        assert cli.main(BASE + argv + ["--iters", "1"]) == 2
        out = capsys.readouterr()
        assert message in out.err and "rerun with the --algo/--envs/--agents/--vision-width" \
            in out.err and out.out == ""
    assert cli.main(BASE + ["--iters", "1", "--resume", str(tmp_path / "no.npz")]) == 2
    assert "train checkpoint not found" in capsys.readouterr().err
