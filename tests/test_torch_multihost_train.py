"""The trainers' `mesh=` and Scene across processes: two OS processes
(tests/torch_multihost_train_worker.py), each with 2 CPU shards, join over
gloo into the 4-shard meshes {"agents": 4} (the agent reductions and the
ring cross the boundary), {"data": 2, "agents": 2} (the env reductions
do) and {"data": 4} (the data-only path). Every trainer's step across the
two processes is held against the
same step on one process on a mesh of the same shape, same seed: loss and
metrics at rtol 1e-4, every gradient at rtol 1e-4 / atol 1e-4 of its
largest component (test_torch_ring_train.py's tolerances: the same sums in
another order), and the two processes' parameters after the step are equal
bit for bit. The nets run in float32 there; in the *_bf16 cases (the
default bf16 nets) each process's partial weight gradient is rounded to
bfloat16 before the all-reduce, as one process rounds the whole product,
so those gradients are held at atol 2^-8 (a bf16 rounding) of their largest
component (measured: up to 1.0e-3). Scene's ring and gspmd rollouts of GlobalTensor states are
held against one process's at test_torch_ring_train.py's position
tolerance (rtol 3e-5 / atol 1e-6) and shade atol 1e-5. REINFORCE and APG
diff_vision across processes are also held against the JAX trainers' step
on shared numpy spawns and noise, here in the parent process (the worker
imports no JAX), as tests/test_torch_train.py holds one process's.
"""

import functools
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import state as jstate
from nenbody_tpu.rl import apg as japg
from nenbody_tpu.rl import train as jtrain
from nenbody_tpu.rl.policy import MLPPolicy as JMLPPolicy
from nenbody_tpu.rl.policy import gaussian_log_prob as jgaussian_log_prob

from nenbody_tpu_torch.rl.policy import flax_from_state_dict, init_mlp_policy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_multihost_train_worker as worker  # noqa: E402
from test_torch_train import _envs, _grad_recorder  # noqa: E402

DEADLINE_S = 240  # both processes, start to exit
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4, 1e-4
BF16_GRAD_ATOL = 2.0 ** -8
TRAINERS = [c for c in worker.CASES if not c.startswith("scene")]
SCENES = [c for c in worker.CASES if c.startswith("scene")]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both processes' results, merged (each wrote its own steps across the
    processes, under "dist", and its share of the one-process references,
    under "one"), after both exited 0."""
    tmp = tmp_path_factory.mktemp("multihost_train")
    port, nproc = _free_port(), 2
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    outs = [str(tmp / f"p{pid}.npz") for pid in range(nproc)]
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests",
                                                            "torch_multihost_train_worker.py"),
                               str(pid), str(nproc), str(port), outs[pid]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=ROOT, env=env)
             for pid in range(nproc)]
    deadline = time.monotonic() + DEADLINE_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {pid} failed:\n{log[-3000:]}"
        assert "torch multihost training OK" in log, log[-2000:]
    per_process = [dict(np.load(o)) for o in outs]
    refs = {k: v for r in per_process for k, v in r.items() if "/one/" in k}
    return per_process, refs


def _metrics(d: dict, prefix: str) -> dict:
    head = f"{prefix}/metric/"
    return {k[len(head):]: float(v) for k, v in d.items() if k.startswith(head)}


def _hold_grads(got, want, what: str, bf16: bool) -> None:
    assert np.abs(want).max() > 0, what
    tol = (dict(rtol=0, atol=BF16_GRAD_ATOL * np.abs(want).max()) if bf16 else
           dict(rtol=GRAD_RTOL, atol=GRAD_ATOL * np.abs(want).max()))
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


@pytest.mark.parametrize("case", TRAINERS)
@pytest.mark.parametrize("layout", list(worker.LAYOUTS))
def test_trainer_across_processes_matches_one_process(runs, layout, case):
    per_process, refs = runs
    one = f"{layout}/{case}/one"
    want = _metrics(refs, one)
    assert want, f"no reference for {one}"
    for pid, r in enumerate(per_process):
        got = _metrics(r, f"{layout}/{case}/dist")
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                       err_msg=f"p{pid} {k}")
        _hold_grads(r[f"{layout}/{case}/dist/grads"], refs[f"{one}/grads"], f"p{pid} grads",
                    case.endswith("_bf16"))
    # every replica took the same step
    a, b = (r[f"{layout}/{case}/dist/params"] for r in per_process)
    assert np.array_equal(a, b)
    if f"{one}/env_pos" in refs:  # each process kept its block of the envs
        spmd_rows = np.concatenate([r[f"{layout}/{case}/dist/env_pos"] for r in per_process],
                                   axis=0 if layout.startswith("data") else 1)
        np.testing.assert_allclose(spmd_rows, refs[f"{one}/env_pos"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", SCENES)
@pytest.mark.parametrize("layout", worker.RING_LAYOUTS)
def test_scene_rollout_of_global_states_matches_one_process(runs, layout, case):
    """Scene(backend='ring'/'gspmd') steps, observes and rolls out
    global_state states across the processes: each process's block of the
    final positions and of the recorded positions and shade rows equals
    one process's rollout there."""
    per_process, refs = runs
    one = f"{layout}/{case}/one"
    by_data = layout.startswith("data")
    for key, tol in (("pos", dict(rtol=3e-5, atol=1e-6)), ("traj_pos", dict(rtol=3e-5, atol=1e-6)),
                     ("traj_obs", dict(rtol=1e-5, atol=1e-5))):
        axis = (0 if by_data else 1) + (1 if key.startswith("traj") else 0)
        got = np.concatenate([r[f"{layout}/{case}/dist/{key}"] for r in per_process], axis=axis)
        np.testing.assert_allclose(got, refs[f"{one}/{key}"], err_msg=key, **tol)
    t = np.concatenate([r[f"{layout}/{case}/dist/t"] for r in per_process])
    assert (t == 3).all()


@functools.lru_cache(maxsize=None)
def _jax_step(case: str):
    """The JAX trainer's step on the worker's shared spawns and noise, from
    the port's float32 MLP of worker.SEED: (metrics, raw gradients as a flax
    tree)."""
    pos, vel, noise, env = worker.shared_inputs(case)
    reward_mode = "visibility"
    env_kw = {} if case.startswith("reinforce") else dict(max_accel=1.0, smooth_clip=True)
    jenv, _ = _envs(reward_mode, True, n=worker.N, w=worker.W, **env_kw)

    def jspawn(key, cfg, num_envs):
        return jstate.SceneState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                                 key=jax.random.split(jax.random.key(0), num_envs),
                                 t=jnp.zeros(num_envs, jnp.int32))

    def jsample(params, apply_fn, obs, key):
        mean, log_std = apply_fn(params, obs)
        action = mean + jnp.exp(log_std) * jnp.asarray(noise)
        return action, jgaussian_log_prob(action, mean, log_std)

    params = jax.tree_util.tree_map(jnp.asarray, flax_from_state_dict(
        init_mlp_policy(env.obs_width, worker.SEED, use_bf16=False)))
    opt = _grad_recorder()
    with pytest.MonkeyPatch.context() as mp:
        if case.startswith("reinforce"):
            mp.setattr(jtrain, "spawn_batch", jspawn)
            mp.setattr(jtrain, "sample_action", jsample)
            jts, apply_fn, _ = jtrain.init_train_state(jenv, worker.B, jax.random.key(0), opt,
                                                       policy=JMLPPolicy(use_bf16=False))
            jts = jts._replace(params=params, opt_state=opt.init(params))
            jts2, jm = jax.jit(jtrain.make_train_step(jenv, apply_fn, opt,
                                                      horizon=worker.H))(jts)
        else:
            mp.setattr(japg, "spawn_batch", jspawn)
            jts, apply_fn, _ = japg.init_apg_state(jenv, jax.random.key(0), opt,
                                                   policy=JMLPPolicy(use_bf16=False))
            jts = jts._replace(params=params, opt_state=opt.init(params))
            jts2, jm = jax.jit(japg.make_apg_step(jenv, apply_fn, opt, horizon=worker.H,
                                                  num_envs=worker.B, diff_vision=True))(jts)
    return {k: float(v) for k, v in jm.items()}, jts2.opt_state


@pytest.mark.parametrize("case", worker.JAX_CASES)
@pytest.mark.parametrize("layout", list(worker.LAYOUTS))
def test_trainer_across_processes_matches_jax(runs, layout, case):
    """Loss and metrics at rtol 1e-4 and every gradient at atol 1e-4 of its
    largest component (tests/test_torch_train.py's), each process's."""
    per_process, _ = runs
    jm, jgrads = _jax_step(case)
    policy = init_mlp_policy(worker.shared_inputs(case)[3].obs_width, worker.SEED,
                             use_bf16=False)
    from nenbody_tpu_torch.rl.policy import state_dict_from_flax

    want_sd = state_dict_from_flax(policy, jax.tree_util.tree_map(np.asarray, jgrads))
    want = np.concatenate([want_sd[name].reshape(-1).numpy()
                           for name, _ in policy.named_parameters()])
    for pid, r in enumerate(per_process):
        got = _metrics(r, f"{layout}/jax_{case}/dist")
        for k in ("loss", "reward_mean"):
            np.testing.assert_allclose(got[k], jm[k], rtol=LOSS_RTOL, err_msg=f"p{pid} {k}")
        np.testing.assert_allclose(r[f"{layout}/jax_{case}/dist/grads"], want, rtol=0,
                                   atol=GRAD_ATOL * np.abs(want).max(), err_msg=f"p{pid}")


def test_the_one_process_paths_stay_plain():
    """A mesh of one process's devices builds no process group: Spmd is
    off, and every reduction is the plain one (the one-process trainers run
    as before)."""
    from nenbody_tpu_torch.parallel import make_mesh
    from nenbody_tpu_torch.rl.spmd import Spmd

    mesh = make_mesh({"data": 2, "agents": 2}, devices=["cpu"] * 4)
    spmd = Spmd(mesh, 16)
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    assert not spmd.on and spmd.agent_sum is None and spmd.agent_mean is None
    assert mesh.process_group("agents") is None
    assert spmd.block(x) is x and spmd.lift(x) is x and spmd.total(x) is x
    assert torch.equal(spmd.share(x), x.mean()) and torch.equal(spmd.std(x), x.std(correction=0))
