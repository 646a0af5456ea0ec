"""Worker for tests/test_torch_multihost_train.py: one process of a
2-process CPU mesh of the port training across the process boundary.

Run as:  python tests/torch_multihost_train_worker.py <process_id> <num_processes> <port> <out.npz>
             [<shards a process> [tags0]]

Each process owns 2 CPU shards (or <shards a process> of them: with 1 on
4 processes, NCCL's layout, it runs ONE_SHARD_CASES only; `tags0` forces
every point-to-point tag to 0, as tests/torch_multihost_worker.py
describes); joined through
parallel.mesh.init_distributed on gloo they form the 4-shard meshes of
LAYOUTS: {"agents": 4}, where each process holds half the agents of every
env (the agent reductions and the ring cross the boundary),
{"data": 2, "agents": 2}, where each holds whole ring rows of half the
envs (the env reductions cross it), and the data-only {"data": 4}, where
each runs its envs through the env on each of its shards (the Scene cases
on the first two only). On each, every case of CASES runs one
step of its trainer with mesh= (or a Scene rollout of GlobalTensor
states) from one seed; the process writes its metrics, its gradients and
its parameters after the step (or its block of the rollout). Each process
also runs a share of the same steps on one process on a mesh of that
shape (4 CPU shards), the references, and the JAX_CASES: REINFORCE and
APG diff_vision on shared numpy spawns and noise (`shared_inputs`, which
the test feeds the JAX trainers in the parent process, since this worker
imports no JAX).
"""

import sys

import numpy as np
import torch

torch.set_num_threads(1)

from nenbody_tpu_torch import Scene, SceneState, SimConfig, VisionConfig  # noqa: E402
from nenbody_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from nenbody_tpu_torch.rl import ac, apg, es, ppo, train  # noqa: E402
from nenbody_tpu_torch.rl.env import VisionEnv  # noqa: E402
from nenbody_tpu_torch.rl.policy import CentralValueMLP, GRUPolicy, ValueMLP  # noqa: E402
from nenbody_tpu_torch.rl.policy import init_mlp_policy, seeded  # noqa: E402
from nenbody_tpu_torch.rl.spmd import Spmd  # noqa: E402
from torch_multihost_worker import set_p2p_tags_to_zero  # noqa: E402

N, W, B, H = 16, 16, 4, 2
FAR, LR, SEED = 200.0, 1e-3, 3
LAYOUTS = {"agents4": {"agents": 4}, "data2_agents2": {"data": 2, "agents": 2},
           "data4": {"data": 4}}
RING_LAYOUTS = ("agents4", "data2_agents2")  # the Scene cases' (the ring needs agents)
# The trainers' nets run in float32 but in the *_bf16 cases, whose default
# bf16 layers round each process's partial weight gradient to bfloat16 (the
# test holds those at a bf16 tolerance)
CASES = ("reinforce_visibility", "reinforce_cohesion", "reinforce_gru", "apg_semi_difference",
         "apg_diff_disc", "apg_diff_wireframe", "apg_remat", "ppo_agent_critic",
         "ppo_central_critic", "ac", "es", "reinforce_cohesion_bf16", "ppo_central_critic_bf16",
         "scene_ring_gravity", "scene_ring_boids", "scene_ring_random", "scene_gspmd_gravity")
JAX_CASES = ("reinforce_visibility", "apg_diff_visibility")
# NCCL's layout (one shard a process) runs these
ONE_SHARD_CASES = ("reinforce_visibility", "apg_diff_disc", "apg_diff_wireframe",
                   "ppo_central_critic", "scene_ring_gravity")


def env_of(reward_mode="cohesion", sprite="disc", antialias=True, far=FAR, spread=100.0, **kw):
    vcfg = VisionConfig(width=W, antialias=antialias, sprite_mode=sprite, far=far)
    return VisionEnv(SimConfig(n=N, controller="gravity", vision=vcfg,
                               spawn_pos_range=(-spread, spread)),
                     reward_mode=reward_mode, **kw)


def shared_inputs(case: str):
    """The JAX cases' numpy spawns [B, N, 2] (pos, vel) and action noise
    [B, N, 2] (the same at every step), and the port env of the case (the
    one tests/test_torch_train.py's _envs builds)."""
    rng = np.random.RandomState(11)
    pos = rng.uniform(-30, 30, (B, N, 2)).astype(np.float32)
    vel = rng.uniform(-0.5, 0.5, (B, N, 2)).astype(np.float32)
    noise = rng.randn(B, N, 2).astype(np.float32)
    if case == "reinforce_visibility":
        env = VisionEnv(SimConfig(n=N, controller="gravity",
                                  vision=VisionConfig(width=W, antialias=True)),
                        reward_mode="visibility")
    else:
        env = VisionEnv(SimConfig(n=N, controller="gravity",
                                  vision=VisionConfig(width=W, antialias=True)),
                        reward_mode="visibility", max_accel=1.0, smooth_clip=True)
    return pos, vel, noise, env


def _grads(module_params):
    return np.concatenate([p.grad.detach().reshape(-1).numpy() for p in module_params])


def _params(module_params):
    return np.concatenate([p.detach().reshape(-1).numpy() for p in module_params])


def _record(out: dict, prefix: str, metrics: dict, params) -> None:
    params = list(params)
    for k, v in metrics.items():
        out[f"{prefix}/metric/{k}"] = np.asarray(float(v))
    out[f"{prefix}/grads"] = _grads(params)
    out[f"{prefix}/params"] = _params(params)


def run_case(case: str, mesh, out: dict, prefix: str) -> None:
    """One step of `case` on `mesh` (across processes or one process's),
    its results into out[prefix/...]."""
    dev = "cpu"
    bf16 = case.endswith("_bf16")
    case = case.removesuffix("_bf16")

    def policy(obs_width):
        return init_mlp_policy(obs_width, SEED, use_bf16=bf16)

    def critic(env, cls):
        return seeded(SEED + 1, lambda: cls(env.obs_width, use_bf16=bf16))

    if case.startswith("reinforce"):
        if case == "reinforce_gru":
            env = env_of()
            gru = seeded(SEED, lambda: GRUPolicy(env.obs_width, use_bf16=bf16))
            ts = train.init_recurrent_train_state(env, B, seed=SEED, lr=LR, policy=gru,
                                                  device=dev, mesh=mesh)
            step = train.make_recurrent_train_step(env, horizon=H, mesh=mesh)
        else:
            env = env_of(case.split("_")[1], max_accel=1.0, smooth_clip=True)
            ts = train.init_train_state(env, B, seed=SEED, lr=LR, policy=policy(env.obs_width),
                                        device=dev, mesh=mesh)
            step = train.make_train_step(env, horizon=H, mesh=mesh)
        ts, m = step(ts)
        _record(out, prefix, m, ts.policy.parameters())
        out[f"{prefix}/env_pos"] = ts.env_states.pos.numpy()
    elif case.startswith("apg"):
        kw = dict(max_accel=1.0, smooth_clip=True)
        env, diff, remat = {
            "apg_semi_difference": (env_of("difference", **kw), False, False),
            "apg_diff_disc": (env_of("visibility", **kw), True, False),
            "apg_diff_wireframe": (env_of("visibility", "wireframe", **kw), True, False),
            "apg_remat": (env_of("team", **kw), True, True),
        }[case]
        ts = apg.init_apg_state(env, seed=SEED, lr=LR, policy=policy(env.obs_width), device=dev,
                                mesh=mesh)
        ts, m = apg.make_apg_step(env, horizon=H, num_envs=B, remat=remat, mesh=mesh,
                                  diff_vision=diff)(ts)
        _record(out, prefix, m, ts.policy.parameters())
    elif case.startswith("ppo"):
        env = env_of("cohesion")
        central = case == "ppo_central_critic"
        # SGD: each minibatch's step moves the parameters linearly in its
        # gradient, so the second minibatch's gradient is comparable
        ts = ppo.init_ppo_state(env, seed=SEED, lr=LR, policy=policy(env.obs_width),
                                value=critic(env, CentralValueMLP if central else ValueMLP),
                                optimizer=torch.optim.SGD, device=dev, mesh=mesh)
        ts, m = ppo.make_ppo_step(env, horizon=H, num_envs=B, epochs=1, num_minibatches=2,
                                  ent_coef=0.01, mesh=mesh, central_critic=central)(ts)
        _record(out, prefix, m, [*ts.policy.parameters(), *ts.value.parameters()])
    elif case == "ac":
        env = env_of("cohesion")
        ts = ac.init_ac_state(env, B, seed=SEED, lr=LR, policy=policy(env.obs_width),
                              value=critic(env, CentralValueMLP), device=dev, mesh=mesh)
        ts, m = ac.make_ac_step(env, horizon=H, mesh=mesh)(ts)
        _record(out, prefix, m, [*ts.policy.parameters(), *ts.value.parameters()])
    elif case == "es":
        # tests/test_torch_es.py's spawn spread, sigma and actions: the
        # members' fitness differences stand well above float32 rounding
        env = env_of("cohesion", spread=30.0, max_accel=1.0)
        ts = es.init_es_state(env, seed=SEED, lr=LR, policy=policy(env.obs_width), device=dev,
                              mesh=mesh)
        ts, m = es.make_es_step(env, horizon=H, population=2, num_envs=B, sigma=0.5,
                                mesh=mesh)(ts)
        _record(out, prefix, m, ts.policy.parameters())
    else:  # a Scene rollout of 3 steps
        _, backend, controller = case.split("_")
        cfg = SimConfig(n=N, controller=controller, backend=backend,
                        vision=VisionConfig(width=W, far=FAR))
        scene = Scene(cfg, device=dev, mesh=None if mesh.distributed else mesh)
        state = scene.spawn_envs(B, seed=SEED)
        data_axis = mesh_lib.data_axis_of(mesh)
        if mesh.distributed:
            state = mesh_lib.global_state(Spmd(mesh, N).block_state(state), mesh, batch=True,
                                          data_axis=data_axis)
        final, traj = scene.rollout(state, 3, record=("pos", "obs"))
        local = mesh_lib.local_blocks(final)
        out[f"{prefix}/pos"] = local.pos.numpy()
        out[f"{prefix}/t"] = local.t.numpy()
        for k in ("pos", "obs"):
            out[f"{prefix}/traj_{k}"] = Spmd.local(traj[k]).numpy()


def run_jax_case(case: str, mesh, out: dict, prefix: str) -> None:
    """`case` across processes on the shared numpy spawns and noise: the
    spawn and the noise draw patched to return them (this process keeps its
    block), the policy the float32 MLP from SEED."""
    pos, vel, noise, env = shared_inputs(case)

    def spawn(cfg, generator, num_envs, device="cpu"):
        return SceneState(pos=torch.from_numpy(pos), vel=torch.from_numpy(vel),
                          t=torch.zeros(num_envs, dtype=torch.int32))

    module = train if case.startswith("reinforce") else apg
    saved = module.spawn_batch, Spmd.noise
    module.spawn_batch = spawn
    Spmd.noise = lambda self, generator, like: self.block(torch.from_numpy(noise))
    try:
        policy = init_mlp_policy(env.obs_width, SEED, use_bf16=False)
        if case.startswith("reinforce"):
            ts = train.init_train_state(env, B, seed=0, lr=LR, policy=policy, device="cpu",
                                        mesh=mesh)
            ts, m = train.make_train_step(env, horizon=H, mesh=mesh)(ts)
        else:
            ts = apg.init_apg_state(env, seed=0, lr=LR, policy=policy, device="cpu", mesh=mesh)
            ts, m = apg.make_apg_step(env, horizon=H, num_envs=B, mesh=mesh,
                                      diff_vision=True)(ts)
    finally:
        module.spawn_batch, Spmd.noise = saved
    _record(out, prefix, m, ts.policy.parameters())


def main() -> None:
    pid, nproc, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    shards = int(sys.argv[5]) if len(sys.argv) > 5 else 2
    if sys.argv[6:] == ["tags0"]:
        set_p2p_tags_to_zero()
    mesh_lib.init_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid,
                              local_device_ids=["cpu"] * shards)
    out = {}
    cases = ONE_SHARD_CASES if shards == 1 else CASES
    jobs = [(name, case) for name in LAYOUTS for case in cases
            if name in RING_LAYOUTS or not case.startswith("scene")]
    for name, axes in LAYOUTS.items():
        mesh = mesh_lib.make_mesh(axes)
        assert mesh.distributed, mesh
        for case in cases:
            if (name, case) in jobs:
                run_case(case, mesh, out, f"{name}/{case}/dist")
        for case in JAX_CASES:
            run_jax_case(case, mesh, out, f"{name}/jax_{case}/dist")
    torch.distributed.destroy_process_group()
    # the references, on one process: this process's share of them
    for name, case in jobs[pid::nproc]:
        one = mesh_lib.make_mesh(LAYOUTS[name], devices=["cpu"] * 4)
        run_case(case, one, out, f"{name}/{case}/one")
    np.savez(path, **out)
    print(f"[p{pid}] torch multihost training OK: {len(jobs)} cases on {nproc} processes",
          flush=True)


if __name__ == "__main__":
    main()
