"""REINFORCE with a learned value baseline: actor-critic (counterpart of
nenbody_tpu/rl/ac.py).

The rollout is REINFORCE's (rl/train.py's sampled_rollout, no grad); the
advantage is the returns-to-go minus V(obs), held constant in the policy
term, and the value head regresses on the returns, which cuts the
score-function estimator's variance without changing its bias. The value
head is a ValueMLP by default; a CentralValueMLP drops in unchanged (the
loss takes the whole [T, B, N, W] trajectory). `mesh=` as rl/train.py's,
across processes too (rl/spmd.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..state import SceneState
from .env import VisionEnv
from .policy import ValueMLP, gaussian_log_prob, init_mlp_policy, seeded
from .spmd import Spmd
from .train import (batched_env_fns, discounted_returns, sampled_rollout, spawn_envs,
                    start_states)


@dataclasses.dataclass
class ACState:
    policy: nn.Module
    value: nn.Module
    optimizer: torch.optim.Optimizer  # over both
    env_states: SceneState  # batched [B, ...]
    generator: torch.Generator  # spawns and action noise, on the envs' device


def make_ac_step(
    env: VisionEnv,
    horizon: int = 8,
    gamma: float = 0.99,
    value_coef: float = 0.5,
    mesh=None,
    episodic: bool = True,
):
    """Build the step `ts -> (ts, metrics)`: rollout -> returns -> loss
    pg + value_coef * mse -> optimizer step. episodic=True respawns the
    envs each iteration (rl/train.py's make_train_step)."""
    spmd = Spmd(mesh, env.cfg.n)
    observe_b, step_b = batched_env_fns(env, mesh)

    def ac_step(ts: ACState) -> Tuple[ACState, dict]:
        with torch.no_grad():
            env_states, traj = sampled_rollout(ts.policy, observe_b, step_b,
                                               start_states(env, ts, episodic, spmd),
                                               ts.generator, horizon, spmd)
            rets = discounted_returns(traj.reward, gamma)
        mean, log_std = ts.policy(traj.obs)
        logp = gaussian_log_prob(traj.action, mean, log_std)
        v = spmd.value(ts.value, traj.obs)  # [T, B, N]
        pg = -spmd.share(logp * (rets - v).detach())
        v_loss = spmd.share((v - rets) ** 2)
        loss = pg + value_coef * v_loss
        ts.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        spmd.sync_grads(p for group in ts.optimizer.param_groups for p in group["params"])
        ts.optimizer.step()
        pg, v_loss, loss = spmd.total(torch.stack([pg.detach(), v_loss.detach(),
                                                   loss.detach()]))
        metrics = {
            "loss": loss,
            "pg_loss": pg,
            "value_loss": v_loss,
            "reward_mean": spmd.mean(traj.reward),
        }
        return dataclasses.replace(ts, env_states=env_states), metrics

    return ac_step


def init_ac_state(
    env: VisionEnv,
    num_envs: int,
    seed: int = 0,
    lr: float = 1e-3,
    policy: Optional[nn.Module] = None,
    value: Optional[nn.Module] = None,
    device: str | torch.device = "cuda",
    mesh=None,
) -> ACState:
    """Spawn `num_envs` envs, a policy (the MLP by default) and a value head
    (a ValueMLP by default; weights from `seed` and `seed + 1`) with one
    Adam optimizer over both, on `device`; the random stream is a generator
    seeded with `seed`. With a mesh the env batch must divide its data
    axis; across processes the state holds this process's block of the
    envs and rank 0's modules."""
    env_states, generator = spawn_envs(env, num_envs, seed, device, mesh)
    policy = (policy or init_mlp_policy(env.obs_width, seed)).to(device)
    value = (value or seeded(seed + 1, lambda: ValueMLP(env.obs_width))).to(device)
    Spmd(mesh, env.cfg.n).broadcast(policy, value)
    optimizer = torch.optim.Adam([*policy.parameters(), *value.parameters()], lr=lr)
    return ACState(policy, value, optimizer, env_states, generator)
