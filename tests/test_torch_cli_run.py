"""The port's `run` command (nenbody_tpu_torch.cli) against the JAX
package's (nenbody_tpu.cli), both in-process on the CPU, on shared files.

Each comparison resumes both commands from one JAX-written checkpoint and
compares their final checkpoints (their `--checkpoint-dir` files):
- gravity and boids: the dense physics' parity tolerance
  (tests/test_torch_slice.py: pos rtol 3e-5 / atol 1e-5, vel rtol 3e-5 /
  atol 1e-6), over 20 steps;
- policy playback from a JAX params file (the file `train --save`
  writes), over 6 steps: with the nets in float32 (both packages' policy
  classes patched to use_bf16=False) pos and vel to atol 1e-5 (1e-6
  measured: the renders' rounding carried through the nets); with the
  nets' default bfloat16 layers to atol 5e-3 (2.2e-3 measured), since XLA
  and PyTorch round a bf16 product one ulp (2^-8) apart now and then, and
  an action's difference moves the velocity by dt times it every step.
Within the port, resuming equals not stopping bit for bit (the random
controller, whose stream the checkpoint carries), and a GRU's carry
persists across chunks (one chunk and three give the same bits).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import cli as jcli
from nenbody_tpu import state as jstate
from nenbody_tpu.rl import policy as jpolicy
from nenbody_tpu.utils import checkpoint as jck
from nenbody_tpu.utils import native as jnative

from nenbody_tpu_torch import cli
from nenbody_tpu_torch.utils import native

torch.set_num_threads(1)

POS_TOL = dict(rtol=3e-5, atol=1e-5)
VEL_TOL = dict(rtol=3e-5, atol=1e-6)
PLAYBACK_ATOL = {False: 1e-5, True: 5e-3}


def _jax_checkpoint(path, n, t=5, seed=0, spread=40.0):
    """A JAX scene checkpoint of n agents at step t (shared numpy values)."""
    rng = np.random.RandomState(seed)
    st = jstate.spawn(jax.random.key(seed), JSimConfig(n=n)).replace(
        pos=jnp.asarray(rng.uniform(-spread, spread, (n, 2)).astype(np.float32)),
        vel=jnp.asarray(rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)),
        t=jnp.int32(t))
    return jck.save_state(str(path), st)


def _both_run(tmp_path, argv, final):
    """Run `argv` through both commands, each with its own checkpoint dir;
    returns the two final checkpoints (jax, port) as npz dicts."""
    out = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        d = str(tmp_path / name)
        assert main(argv + ["--checkpoint-dir", d] + extra) == 0, name
        with np.load(os.path.join(d, final)) as z:
            out[name] = {k: z[k] for k in z.files}
    return out["jax"], out["port"]


@pytest.mark.parametrize("controller", ["gravity", "boids"])
def test_run_resumes_a_jax_checkpoint_as_the_jax_run_does(tmp_path, capsys, controller):
    ckpt = _jax_checkpoint(tmp_path / "start.npz", 16)
    want, got = _both_run(tmp_path, ["run", "--n", "16", "--controller", controller,
                                     "--steps", "20", "--log-every", "10", "--resume", ckpt,
                                     "--checkpoint-every", "20"], "state_000000025.npz")
    np.testing.assert_allclose(got["pos"], want["pos"], **POS_TOL)
    np.testing.assert_allclose(got["vel"], want["vel"], **VEL_TOL)
    assert got["t"] == want["t"] == 25
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [r["t"] for r in rows] == [15, 25, 15, 25]  # the JAX run's lines, then the port's


def _jax_params(net, n_obs, width):
    dummy = jnp.zeros((1, n_obs), jnp.float32)
    if net == "gru":
        pol = jpolicy.GRUPolicy()
        params = pol.init(jax.random.key(1), pol.initial_carry((1,)), dummy)
    elif net == "conv":
        params = jpolicy.ConvPolicy(vision_width=width).init(jax.random.key(1), dummy)
    else:
        params = jpolicy.MLPPolicy().init(jax.random.key(1), dummy)
    # a trained-looking log_std and nonzero biases, so every leaf matters
    return jax.tree_util.tree_map(lambda x: x + 0.01, params)


@pytest.fixture
def nets_in(monkeypatch, request):
    """Both packages' policy families built with use_bf16=request.param."""
    from nenbody_tpu_torch.rl import policy as tpolicy

    for module in (jpolicy, tpolicy):
        for name in ("MLPPolicy", "ConvPolicy", "GRUPolicy"):
            monkeypatch.setattr(module, name,
                                functools.partial(getattr(module, name), use_bf16=request.param))
    return request.param


@pytest.mark.parametrize("nets_in", [False, True], ids=["fp32", "bf16"], indirect=True)
@pytest.mark.parametrize("net", ["mlp", "conv", "gru"])
def test_run_plays_back_a_jax_policy_as_the_jax_run_does(tmp_path, net, nets_in):
    """run --policy with a JAX params file (as `train --save` writes it)
    agrees with the JAX run; for the GRU, whose carry persists over the
    whole playback, three chunks give the port the same bits as one."""
    params = jck.save_pytree(str(tmp_path / "p.npz"), _jax_params(net, 18, 16))
    ckpt = _jax_checkpoint(tmp_path / "start.npz", 12, spread=15.0)
    argv = ["run", "--n", "12", "--controller", "gravity", "--vision-width", "16",
            "--steps", "6", "--checkpoint-every", "11", "--resume", ckpt,
            "--policy", params, "--net", net]
    want, got = _both_run(tmp_path, argv + ["--log-every", "2"], "state_000000011.npz")
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=0, atol=PLAYBACK_ATOL[nets_in])
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=0, atol=PLAYBACK_ATOL[nets_in])
    assert np.abs(got["pos"] - np.load(ckpt)["pos"]).max() > 0
    one = str(tmp_path / "one")
    assert cli.main(argv + ["--log-every", "6", "--device", "cpu", "--checkpoint-dir", one]) == 0
    with np.load(os.path.join(one, "state_000000011.npz")) as z:
        assert np.array_equal(z["pos"], got["pos"]) and np.array_equal(z["vel"], got["vel"])


def test_random_controller_resumed_equals_uninterrupted(tmp_path):
    """The port's checkpoint carries the scene's random stream, so a run
    resumed from it equals the run that did not stop, bit for bit."""
    base = ["run", "--device", "cpu", "--n", "10", "--controller", "random",
            "--log-every", "10", "--checkpoint-every", "20"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert cli.main(base + ["--steps", "40", "--checkpoint-dir", a, "--seed", "4"]) == 0
    # one chunk of 20: its checkpointer counts from 0, so it saves at t = 40
    assert cli.main(base + ["--steps", "20", "--log-every", "20", "--checkpoint-dir", b,
                            "--resume", os.path.join(a, "state_000000020.npz")]) == 0
    with np.load(os.path.join(a, "state_000000040.npz")) as x, \
            np.load(os.path.join(b, "state_000000040.npz")) as y:
        assert sorted(x.files) == sorted(y.files) == ["generator", "pos", "t", "vel"]
        for k in x.files:
            assert np.array_equal(x[k], y[k]), k


def test_random_controller_from_a_jax_checkpoint_warns(tmp_path, capsys):
    """A JAX checkpoint has no torch stream: the run seeds it from --seed
    and says so in one line."""
    ckpt = _jax_checkpoint(tmp_path / "j.npz", 8)
    assert cli.main(["run", "--device", "cpu", "--n", "8", "--controller", "random",
                     "--steps", "2", "--log-every", "1", "--seed", "3", "--resume", ckpt]) == 0
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "seeded from --seed 3" in err[0]


@pytest.fixture
def jax_recorder_on_the_port_library(monkeypatch):
    """The JAX package's recorder bindings over the port's build of the same
    native/nenhost.cpp (so no test builds native/libnenhost.so)."""
    assert native.build()
    monkeypatch.setattr(jnative, "_LIB_PATH", str(native.lib_path()))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_host", None)
    return jnative


def test_record_frames_cross_between_the_packages(tmp_path, jax_recorder_on_the_port_library):
    traj = str(tmp_path / "run.nentraj")
    assert cli.main(["run", "--device", "cpu", "--n", "16", "--controller", "gravity",
                     "--steps", "12", "--log-every", "4", "--record", traj]) == 0
    ts, pos, vel = jnative.read_trajectory(traj)  # the JAX reader on the port's file
    assert list(ts) == [4, 8, 12] and pos.shape == vel.shape == (3, 16, 2)
    jtraj = str(tmp_path / "jax.nentraj")
    rng = np.random.RandomState(0)
    frames = [(t, rng.randn(16, 2).astype(np.float32), rng.randn(16, 2).astype(np.float32))
              for t in (3, 6)]
    with jax_recorder_on_the_port_library.TrajectoryRecorder(jtraj, 16) as rec:
        for t, p, v in frames:
            assert rec.append(t, p, v)
    ts, pos, vel = native.read_trajectory(jtraj)  # the port's reader on the JAX file
    assert list(ts) == [3, 6]
    for i, (_, p, v) in enumerate(frames):
        assert np.array_equal(pos[i], p) and np.array_equal(vel[i], v)


@pytest.mark.parametrize("argv,message", [
    (["--capture", "5"], "ROADMAP queue 1 item 18"),
    (["--first-person"], "ROADMAP queue 1 item 18"),
    (["--resume", "no/such/file.npz"], "checkpoint not found"),
    (["--backend", "cells"], "item 16"),
    (["--policy", "no/such/params.npz", "--vision-width", "8"], "policy params not found"),
    (["--policy", "x.npz"], "--policy needs vision"),
], ids=["capture", "first-person", "missing-resume", "cells", "missing-policy", "no-vision"])
def test_run_refusals(tmp_path, capsys, argv, message):
    if argv[-1] == "x.npz":
        argv = argv[:-1] + [jck.save_pytree(str(tmp_path / "x.npz"), {"a": jnp.zeros(1)})]
    assert cli.main(["run", "--device", "cpu", "--n", "8", "--steps", "2", *argv]) == 2
    out = capsys.readouterr()
    assert message in out.err and out.out == ""
