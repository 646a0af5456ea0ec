"""REINFORCE over batched vision envs (counterpart of nenbody_tpu/rl/train.py:
`Trajectory`, `TrainState`, `discounted_returns`, `make_train_step`,
`init_train_state`; the recurrent form waits, ROADMAP queue 1 item 13, and
`mesh=` waits for the ring, item 17).

The rollout steps the batch of env states directly (the env takes leading
batch dims; no vmap) under torch.no_grad(): as in the JAX trainer the
actions are detached and gradients flow only through the policy log-probs
of the recorded trajectory, so the sim runs the forward-only kernel
launches. The policy and its optimizer live in the train state; a step
updates them in place and returns the state with the new env states.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..state import SceneState, spawn_batch
from .env import VisionEnv
from .policy import gaussian_log_prob, init_mlp_policy, sample_action


class Trajectory(NamedTuple):
    obs: torch.Tensor  # [T, B, N, W+2]
    action: torch.Tensor  # [T, B, N, 2]
    reward: torch.Tensor  # [T, B, N]


@dataclasses.dataclass
class TrainState:
    policy: nn.Module
    optimizer: torch.optim.Optimizer
    env_states: SceneState  # batched [B, ...]
    generator: torch.Generator  # spawns and action noise, on the envs' device


def check_no_mesh(mesh) -> None:
    """The trainers run on one device until the ring is ported."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet: the multi-device trainers wait for the "
            "agent-axis ring (ROADMAP queue 1 item 17)"
        )


def discounted_returns(rewards: torch.Tensor, gamma: float) -> torch.Tensor:
    """Returns-to-go along the leading time axis."""
    rets = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[0])
    for t in reversed(range(rewards.shape[0])):
        carry = rewards[t] + gamma * carry
        rets[t] = carry
    return rets


def make_train_step(
    env: VisionEnv,
    horizon: int = 8,
    gamma: float = 0.99,
    mesh=None,
    episodic: bool = True,
    standardize_adv: bool = True,
):
    """Build the training step `ts -> (ts, metrics)`: rollout -> returns and
    advantages -> REINFORCE gradient -> optimizer step.

    episodic=True respawns the env batch each iteration (as the JAX trainer
    does: persistent states drift away from the spawn distribution); set
    False for deliberate continuing-task training."""
    check_no_mesh(mesh)

    def rollout(policy, env_states: SceneState, generator) -> Tuple[SceneState, Trajectory]:
        obs = env.observe(env_states)
        obs_t, act_t, rew_t = [], [], []
        for _ in range(horizon):
            action, _ = sample_action(policy, obs, generator)
            env_states, next_obs, reward = env.step(env_states, action)
            obs_t.append(obs)
            act_t.append(action)
            rew_t.append(reward)
            obs = next_obs
        return env_states, Trajectory(torch.stack(obs_t), torch.stack(act_t), torch.stack(rew_t))

    def train_step(ts: TrainState) -> Tuple[TrainState, dict]:
        start = ts.env_states
        if episodic:
            start = spawn_batch(env.cfg, ts.generator, start.pos.shape[0], start.pos.device)
        with torch.no_grad():
            env_states, traj = rollout(ts.policy, start, ts.generator)
            rets = discounted_returns(traj.reward, gamma)
            adv = rets - rets.mean()
            if standardize_adv:
                # jnp.std's ddof 0: torch.std's default (ddof 1) would change the loss
                adv = adv / (adv.std(correction=0) + 1e-6)
        mean, log_std = ts.policy(traj.obs)
        loss = -(gaussian_log_prob(traj.action, mean, log_std) * adv).mean()
        ts.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ts.optimizer.step()
        metrics = {
            "loss": loss.detach(),
            "reward_mean": traj.reward.mean(),
            "return_mean": rets.mean(),
        }
        return dataclasses.replace(ts, env_states=env_states), metrics

    return train_step


def init_train_state(
    env: VisionEnv,
    num_envs: int,
    seed: int = 0,
    lr: float = 1e-3,
    policy: Optional[nn.Module] = None,
    device: str | torch.device = "cuda",
    mesh=None,
) -> TrainState:
    """Spawn `num_envs` envs and a policy (the MLP by default, weights from
    `seed`) with an Adam optimizer (default eps: optax.adam's update) on
    `device`; the random stream is a generator seeded with `seed`."""
    check_no_mesh(mesh)
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    env_states = spawn_batch(env.cfg, generator, num_envs, device)
    policy = (policy or init_mlp_policy(env.obs_width, seed)).to(device)
    optimizer = torch.optim.Adam(policy.parameters(), lr=lr)
    return TrainState(policy, optimizer, env_states, generator)
