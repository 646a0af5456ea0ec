"""PPO with GAE, the trainer built for the multi-agent cohesion task
(counterpart of nenbody_tpu/rl/ppo.py).

Per-agent advantages from a value baseline V(obs_i) (or MAPPO's pooled
V(s), policy.CentralValueMLP, with central_critic=True), GAE(lambda) over
the horizon, advantages standardized per update, then epochs of clipped
surrogate updates over minibatches of the rollout. The rollout runs under
no grad and records the sampled actions, their log-probs and the values.

One device: the samples are the flattened (T, B, N) axes ((T, B) with a
central critic, whose samples are whole [N, W] rows). With a mesh the sim
runs on it (rl/train.py's batched_env_fns) and the minibatches are drawn
along the time axis, as the JAX trainer draws them there (its (B, N)
shardings pass through the loss whole). The random draws go through
module-level helpers (`_permutation`, policy.sample_action) that a test can
replace. Across processes (rl/spmd.py) each process rolls out its block,
the advantages are normalized and the losses averaged over the whole
batch, the minibatch order comes from the shared generator (the same on
every process) and the gradients are all-reduced before each step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..state import SceneState, spawn_batch
from .env import VisionEnv
from .policy import ValueMLP, gaussian_log_prob, init_mlp_policy, sample_action, seeded
from .spmd import Spmd
from .train import batched_env_fns, check_mesh_envs


@dataclasses.dataclass
class PPOState:
    policy: nn.Module
    value: nn.Module
    optimizer: torch.optim.Optimizer  # over both
    generator: torch.Generator  # spawns, action noise and minibatch order
    iteration: int = 0
    # the env states carried across iterations with episodic=False (spawned
    # on the first step); None under the episodic default
    env_states: Optional[SceneState] = None


def gae(rewards: torch.Tensor, values: torch.Tensor, last_value: torch.Tensor,
        gamma: float, lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation along the leading time axis.

    rewards [T, ...], values [T, ...], last_value [...] (the bootstrap).
    Returns (advantages [T, ...], returns [T, ...])."""
    advs = torch.empty_like(rewards)
    next_value, next_adv = last_value, torch.zeros_like(last_value)
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * next_value - values[t]
        next_adv = delta + gamma * lam * next_adv
        next_value = values[t]
        advs[t] = next_adv
    return advs, advs + values


def _permutation(n: int, generator: torch.Generator) -> torch.Tensor:
    """A random order of n samples, drawn from `generator` on its device."""
    return torch.randperm(n, generator=generator, device=generator.device)


def make_ppo_step(
    env: VisionEnv,
    horizon: int = 32,
    num_envs: int = 8,
    epochs: int = 4,
    num_minibatches: int = 4,
    clip_eps: float = 0.2,
    gamma: float = 0.99,
    lam: float = 0.95,
    vf_coef: float = 0.5,
    ent_coef: float = 0.0,
    episodic: bool = True,
    mesh=None,
    central_critic: bool = False,
):
    """Build the PPO step `ts -> (ts, metrics)`: rollout -> GAE -> epochs x
    minibatches of clipped surrogate + value regression. episodic=True
    spawns fresh envs each iteration; episodic=False carries them in
    PPOState.env_states (spawned on the first step). With a mesh, horizon
    must divide into num_minibatches; without, the samples must fill every
    minibatch (ValueError otherwise, as the JAX step raises)."""
    if mesh is not None and horizon % num_minibatches:
        raise ValueError(
            f"mesh-mode PPO draws minibatches along the time axis: horizon "
            f"{horizon} must divide into num_minibatches {num_minibatches}"
        )
    n_samples = horizon * num_envs * (1 if central_critic else env.cfg.n)
    if mesh is None and n_samples < num_minibatches:
        raise ValueError(
            f"num_minibatches {num_minibatches} exceeds the {n_samples} "
            f"samples per update (horizon x envs"
            f"{'' if central_critic else ' x agents'}; a central critic's "
            f"samples are whole agent rows) — minibatches would be empty "
            f"and every loss NaN"
        )
    if mesh is not None:
        check_mesh_envs(mesh, num_envs)
    spmd = Spmd(mesh, env.cfg.n)
    observe_b, step_b = batched_env_fns(env, mesh)

    def sample(ts: PPOState, obs):
        if spmd.on:
            return spmd.sample_action(ts.policy, obs, ts.generator)
        return sample_action(ts.policy, obs, ts.generator)

    def rollout(ts: PPOState, env_states: SceneState):
        obs = observe_b(env_states)
        steps = []
        for _ in range(horizon):
            action, logp = sample(ts, obs)
            value = spmd.value(ts.value, obs)
            env_states, next_obs, reward = step_b(env_states, action)
            steps.append((obs, action, logp, value, reward))
            obs = next_obs
        traj = [torch.stack(x) for x in zip(*steps)]
        return env_states, traj, spmd.value(ts.value, obs)

    def loss_fn(ts: PPOState, obs, action, logp_old, adv, ret) -> torch.Tensor:
        mean, log_std = ts.policy(obs)
        ratio = torch.exp(gaussian_log_prob(action, mean, log_std) - logp_old)
        clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
        pg_loss = -spmd.share(torch.minimum(ratio * adv, clipped))
        v_loss = spmd.share((spmd.value(ts.value, obs) - ret) ** 2)
        # the diagonal Gaussian's entropy: sum(log_std) + const
        return pg_loss + vf_coef * v_loss - ent_coef * spmd.replicated(log_std.sum())

    def ppo_step(ts: PPOState) -> Tuple[PPOState, dict]:
        start = ts.env_states
        if episodic or start is None:
            start = spmd.block_state(spawn_batch(env.cfg, ts.generator, num_envs,
                                                 ts.generator.device))
        with torch.no_grad():
            env_states, (obs, action, logp_old, value, reward), last_value = rollout(ts, start)
            adv, ret = gae(reward, value, last_value, gamma, lam)
            batch = [obs, action, logp_old, adv, ret]
            if mesh is None:
                # flatten (T, B, N) into samples; a central critic's are
                # whole [N, ...] rows, so it flattens (T, B) only
                keep = 2 if central_critic else 3
                batch = [x.reshape(-1, *x.shape[keep:]) for x in batch]
            n_perm = batch[0].shape[0]
            mb = n_perm // num_minibatches
            adv_f = batch[3]
            batch[3] = (adv_f - spmd.mean(adv_f)) / (spmd.std(adv_f) + 1e-8)
        params = [p for group in ts.optimizer.param_groups for p in group["params"]]
        losses = []
        for _ in range(epochs):
            perm = _permutation(n_perm, ts.generator)
            for i in range(num_minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                loss = loss_fn(ts, *(x[idx] for x in batch))
                ts.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                spmd.sync_grads(params)
                ts.optimizer.step()
                losses.append(loss.detach())
        metrics = {
            "loss": spmd.total(torch.stack(losses)).mean(),
            "reward_mean": spmd.mean(reward),
            "return_mean": spmd.mean(ret),
            "value_mean": spmd.mean(value),
        }
        return dataclasses.replace(ts, iteration=ts.iteration + 1,
                                   env_states=None if episodic else env_states), metrics

    return ppo_step


def init_ppo_state(
    env: VisionEnv,
    seed: int = 0,
    lr: float = 1e-3,
    policy: Optional[nn.Module] = None,
    value: Optional[nn.Module] = None,
    optimizer: type = torch.optim.Adam,
    device: str | torch.device = "cuda",
    mesh=None,
) -> PPOState:
    """A policy (the MLP by default) and a value head (a ValueMLP by
    default; weights from `seed` and `seed + 1`) on `device` with one
    `optimizer(params, lr=lr)` over both, and the generator seeded with
    `seed`. The env batch is make_ppo_step's. Across processes (`mesh`)
    rank 0's modules in every replica."""
    device = torch.device(device)
    policy = (policy or init_mlp_policy(env.obs_width, seed)).to(device)
    value = (value or seeded(seed + 1, lambda: ValueMLP(env.obs_width))).to(device)
    Spmd(mesh, env.cfg.n).broadcast(policy, value)
    params = [*policy.parameters(), *value.parameters()]
    return PPOState(policy, value, optimizer(params, lr=lr),
                    torch.Generator(device=device).manual_seed(seed))
