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
import sys

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
from test_torch_multihost import ONE_SHARD, run_workers  # noqa: E402
from test_torch_train import _envs, _grad_recorder  # noqa: E402

LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4, 1e-4
BF16_GRAD_ATOL = 2.0 ** -8
TRAINERS = [c for c in worker.CASES if not c.startswith("scene")]
SCENES = [c for c in worker.CASES if c.startswith("scene")]


def _merged(outs) -> tuple:
    """Each process's results, and the one-process references merged (each
    wrote its own steps across the processes, under "dist", and its share
    of the references, under "one")."""
    per_process = [dict(np.load(o)) for o in outs]
    refs = {k: v for r in per_process for k, v in r.items() if "/one/" in k}
    return per_process, refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both processes' results (_merged), after both exited 0: 2 processes
    x 2 CPU shards."""
    return _merged(run_workers("torch_multihost_train_worker.py",
                               tmp_path_factory.mktemp("multihost_train"), 2,
                               marker="torch multihost training OK"))


@pytest.fixture(scope="module", params=list(ONE_SHARD))
def runs_one_shard(request, tmp_path_factory):
    """As `runs`, on NCCL's layout, 4 processes x 1 CPU shard, with the tags
    as written and with every tag forced to 0 (ONE_SHARD): the worker's
    ONE_SHARD_CASES."""
    return _merged(run_workers("torch_multihost_train_worker.py",
                               tmp_path_factory.mktemp("one_shard_train"), 4,
                               *ONE_SHARD[request.param], marker="torch multihost training OK"))


def _metrics(d: dict, prefix: str) -> dict:
    head = f"{prefix}/metric/"
    return {k[len(head):]: float(v) for k, v in d.items() if k.startswith(head)}


def _assemble(blocks, layout: str, env_axis: int):
    """The whole [.., B, N, ..] array from the processes' blocks, in rank
    order, of a `layout` mesh (rank-major): the envs over "data", the
    agents (the next axis) over "agents", a data2_agents2 process holding
    one or both agent blocks of its row."""
    if layout == "agents4":
        return np.concatenate(blocks, axis=env_axis + 1)
    if layout == "data4":
        return np.concatenate(blocks, axis=env_axis)
    k = len(blocks) // 2  # processes a mesh row
    return np.concatenate([np.concatenate(blocks[i:i + k], axis=env_axis + 1)
                           for i in range(0, len(blocks), k)], axis=env_axis)


def _hold_grads(got, want, what: str, bf16: bool) -> None:
    assert np.abs(want).max() > 0, what
    tol = (dict(rtol=0, atol=BF16_GRAD_ATOL * np.abs(want).max()) if bf16 else
           dict(rtol=GRAD_RTOL, atol=GRAD_ATOL * np.abs(want).max()))
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


@pytest.mark.parametrize("case", TRAINERS)
@pytest.mark.parametrize("layout", list(worker.LAYOUTS))
def test_trainer_across_processes_matches_one_process(runs, layout, case):
    hold_trainer(runs, layout, case)


def hold_trainer(runs, layout, case):
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
    first = per_process[0][f"{layout}/{case}/dist/params"]
    assert all(np.array_equal(r[f"{layout}/{case}/dist/params"], first) for r in per_process)
    if f"{one}/env_pos" in refs:  # each process kept its block of the envs
        spmd_rows = _assemble([r[f"{layout}/{case}/dist/env_pos"] for r in per_process],
                              layout, 0)
        np.testing.assert_allclose(spmd_rows, refs[f"{one}/env_pos"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", SCENES)
@pytest.mark.parametrize("layout", worker.RING_LAYOUTS)
def test_scene_rollout_of_global_states_matches_one_process(runs, layout, case):
    """Scene(backend='ring'/'gspmd') steps, observes and rolls out
    global_state states across the processes: each process's block of the
    final positions and of the recorded positions and shade rows equals
    one process's rollout there."""
    hold_scene(runs, layout, case)


def hold_scene(runs, layout, case):
    per_process, refs = runs
    one = f"{layout}/{case}/one"
    for key, tol in (("pos", dict(rtol=3e-5, atol=1e-6)), ("traj_pos", dict(rtol=3e-5, atol=1e-6)),
                     ("traj_obs", dict(rtol=1e-5, atol=1e-5))):
        got = _assemble([r[f"{layout}/{case}/dist/{key}"] for r in per_process], layout,
                        1 if key.startswith("traj") else 0)
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
    hold_jax(runs, layout, case)


def hold_jax(runs, layout, case):
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


ONE_SHARD_TRAINERS = [c for c in worker.ONE_SHARD_CASES if not c.startswith("scene")]
ONE_SHARD_SCENES = [c for c in worker.ONE_SHARD_CASES if c.startswith("scene")]


@pytest.mark.parametrize("case", ONE_SHARD_TRAINERS)
@pytest.mark.parametrize("layout", list(worker.LAYOUTS))
def test_trainer_one_shard_a_process_matches_one_process(runs_one_shard, layout, case):
    """NCCL's layout, 4 processes x 1 shard (ONE_SHARD): the step held
    against one process as above, all four replicas equal bit for bit; on
    data2_agents2 the rows' and columns' groups are two processes each."""
    hold_trainer(runs_one_shard, layout, case)


@pytest.mark.parametrize("case", ONE_SHARD_SCENES)
@pytest.mark.parametrize("layout", worker.RING_LAYOUTS)
def test_scene_one_shard_a_process_matches_one_process(runs_one_shard, layout, case):
    hold_scene(runs_one_shard, layout, case)


@pytest.mark.parametrize("case", worker.JAX_CASES)
@pytest.mark.parametrize("layout", list(worker.LAYOUTS))
def test_trainer_one_shard_a_process_matches_jax(runs_one_shard, layout, case):
    """REINFORCE and APG diff_vision in NCCL's layout against the JAX
    trainers' step, as above."""
    hold_jax(runs_one_shard, layout, case)


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
