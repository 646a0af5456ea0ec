"""The port's flagship step (the twin of __graft_entry__.py's `entry()`):
perception (the disc eye kernel) -> policy (the shared MLP over eye lines)
-> dynamics (the gravity kernel), one step at BASELINE config 2 (N=1,024
agents, 64-px eyes).

    fn, args = entry("cuda")
    pos, vel, obs, reward = fn(*args)
"""

from __future__ import annotations

import torch

from .config import SimConfig, VisionConfig
from .rl.env import VisionEnv
from .rl.policy import MLPPolicy
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
