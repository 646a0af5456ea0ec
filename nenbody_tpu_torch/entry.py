"""The port's whole-step entry points (the twins of __graft_entry__.py's).

entry():            the flagship step: perception (the disc eye kernel) ->
                    policy (the shared MLP over eye lines) -> dynamics (the
                    gravity kernel), one step at BASELINE config 2 (N=1,024
                    agents, 64-px eyes).
dryrun_multichip(n): one step of each trainer on an n-device (data x
                    agents) mesh at tiny shapes: DP over envs, the
                    agent-axis ring over agents, the policy on the envs'
                    device; a mesh repeats a device where fewer are visible.

    fn, args = entry("cuda")
    pos, vel, obs, reward = fn(*args)
    dryrun_multichip(8)
"""

from __future__ import annotations

import torch

from typing import Dict, List, Optional, Tuple

from .config import SimConfig, VisionConfig
from .parallel.mesh import Mesh, make_mesh, visible_devices
from .rl import apg, ppo, train
from .rl.env import VisionEnv
from .rl.policy import CentralValueMLP, MLPPolicy, seeded
from .state import SceneState, spawn

CONFIG_2 = SimConfig(n=1024, controller="gravity", vision=VisionConfig(width=64))


def make_entry_fn(env: VisionEnv):
    """`fn(policy, pos, vel) -> (pos, vel, obs, reward)`: observe, the
    policy's deterministic mean action, then `env.step`. Runs without
    autograd (inference: the forward-only launches, no residuals saved)."""

    @torch.no_grad()
    def fn(policy: MLPPolicy, pos: torch.Tensor, vel: torch.Tensor):
        t = torch.zeros(pos.shape[:-2], dtype=torch.int32, device=pos.device)
        state = SceneState(pos=pos, vel=vel, t=t)
        obs = env.observe(state)
        action, _ = policy(obs)
        next_state, next_obs, reward = env.step(state, action)
        return next_state.pos, next_state.vel, next_obs, reward

    return fn


def entry(
    device: str | torch.device = "cuda",
    cfg: SimConfig = CONFIG_2,
    seed: int = 0,
    use_bf16: bool = True,
):
    """Returns (fn, (policy, pos, vel)) for one perception-control-dynamics
    step of `cfg` (config 2 by default) on `device`, with a seeded random
    spawn and a seeded random policy."""
    device = torch.device(device)
    env = VisionEnv(cfg)
    torch.manual_seed(seed)
    policy = MLPPolicy(env.obs_width, use_bf16=use_bf16).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = spawn(cfg, gen, device)
    return make_entry_fn(env), (policy, state.pos, state.vel)


def _mesh_devices(n_devices: int, device: str | torch.device = "cuda") -> List[torch.device]:
    """n_devices mesh entries on `device`'s type: the visible cards in turn
    (a card repeats where fewer are visible), or the CPU n_devices times."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_devices
    cards = visible_devices()
    return [cards[i % len(cards)] for i in range(n_devices)]


def dryrun_steps(mesh: Optional[Mesh], mesh_dp: Optional[Mesh], device: torch.device,
                 n_agents: int, num_envs: int, wf_envs: int) -> Dict[str, Tuple[dict, list]]:
    """One step of each of dryrun_multichip's five trainers: {name:
    (metrics, the policy's parameter gradients after the step)}. `mesh`
    carries REINFORCE, APG (diff_vision, antialiased eyes), PPO (2 epochs x
    2 minibatches) and PPO with the MAPPO central critic; `mesh_dp` the
    wireframe REINFORCE with `wf_envs` envs. None runs a trainer on one
    device."""
    env = VisionEnv(SimConfig(n=n_agents, controller="gravity", vision=VisionConfig(width=16)))
    env_d = VisionEnv(SimConfig(n=n_agents, controller="gravity",
                                vision=VisionConfig(width=16, antialias=True)), smooth_clip=True)
    env_wf = VisionEnv(SimConfig(n=8, controller="gravity", vision=VisionConfig(
        width=16, sprite_mode="wireframe", antialias=True)))
    out = {}

    def run(name, ts, step, policies):
        ts, metrics = step(ts)
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     [p.grad.clone() for pol in policies(ts) for p in pol.parameters()])

    ts = train.init_train_state(env, num_envs, seed=0, lr=1e-3, device=device, mesh=mesh)
    run("reinforce", ts, train.make_train_step(env, horizon=2, mesh=mesh), lambda t: [t.policy])
    ts = apg.init_apg_state(env_d, seed=1, lr=1e-3, device=device)
    run("apg", ts, apg.make_apg_step(env_d, horizon=2, num_envs=num_envs, mesh=mesh,
                                     diff_vision=True), lambda t: [t.policy])
    for name, seed, central in (("ppo", 2, False), ("mappo", 3, True)):
        value = seeded(seed + 1, lambda: CentralValueMLP(env.obs_width)) if central else None
        ts = ppo.init_ppo_state(env, seed=seed, lr=1e-3, value=value, device=device)
        run(name, ts, ppo.make_ppo_step(env, horizon=2, num_envs=num_envs, epochs=2,
                                        num_minibatches=2, mesh=mesh, central_critic=central),
            lambda t: [t.policy, t.value])
    ts = train.init_train_state(env_wf, wf_envs, seed=4, lr=1e-3, device=device, mesh=mesh_dp)
    run("dp_wireframe", ts, train.make_train_step(env_wf, horizon=2, mesh=mesh_dp),
        lambda t: [t.policy])
    return out


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda"):
    """One full step of each trainer on an n_devices mesh (tiny shapes),
    the twin of __graft_entry__.py's: mesh ("data", "agents") = (2, n/2)
    when n is even, else (1, n); d_agents * max(2, ceil(8 / d_agents))
    agents (the diff-vision ring needs N divisible by the agent axis), 16-px
    eyes, 2 * d_data envs; REINFORCE, APG with diff_vision, PPO and the
    MAPPO central critic on that mesh, then the wireframe REINFORCE on a
    data-only mesh of n_devices with 2 * n_devices envs. Prints the JAX
    summary line and returns dryrun_steps' results."""
    device = torch.device(device)
    d_data = 2 if n_devices % 2 == 0 else 1
    d_agents = n_devices // d_data
    devices = _mesh_devices(n_devices, device)
    mesh = make_mesh({"data": d_data, "agents": d_agents}, devices=devices)
    mesh_dp = make_mesh({"data": n_devices}, devices=devices)
    n_agents = d_agents * max(2, -(-8 // d_agents))
    num_envs = 2 * d_data
    out = dryrun_steps(mesh, mesh_dp, device, n_agents, num_envs, 2 * n_devices)
    m = {name: metrics for name, (metrics, _) in out.items()}
    print(
        f"dryrun_multichip ok: mesh=(data={d_data}, agents={d_agents}), "
        f"envs={num_envs}, agents/env={n_agents}, "
        f"reinforce_loss={m['reinforce']['loss']:.4f}, "
        f"reward_mean={m['reinforce']['reward_mean']:.4f}, "
        f"apg_grad_norm={m['apg']['grad_norm']:.2e}, "
        f"ppo_loss={m['ppo']['loss']:.4f}, "
        f"mappo_central_loss={m['mappo']['loss']:.4f}, "
        f"dp_mesh_wireframe_loss={m['dp_wireframe']['loss']:.4f} "
        f"(data-only mesh x{n_devices}, batched-wireframe router)", flush=True)
    return out
