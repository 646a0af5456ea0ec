"""Analytic policy gradients (APG) through the differentiable dynamics
(counterpart of nenbody_tpu/rl/apg.py; `mesh=` waits for the ring, ROADMAP
queue 1 item 17).

APG backpropagates the reward through the physics: on the kernel backend
the gravity force is an autograd Function whose backward is the VJP kernel
(ops/pairwise.py), so d reward / d action flows through every rollout step.

Perception has two modes. Default ("semi-APG"): the observation is rendered
from detached states under torch.no_grad() (the JAX stop_gradient, which
also keeps the eye's residuals out of memory), so gradients reach the policy
only through the actions it emitted. diff_vision=True keeps the observation
inside the gradient: the eye's autograd Function (ops/raycast.py, the
disc's backward kernel; ops/wireframe.py, the wireframe's winner pullback)
carries d reward / d perception back into positions and headings; pair it
with cfg.vision.antialias=True, which makes the eye lines piecewise linear
in positions.

Deterministic (mean-action) policy; short horizons recommended. remat=True
recomputes each dynamics step in the backward pass
(torch.utils.checkpoint) instead of keeping its intermediates.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..state import SceneState, spawn_batch
from .env import VisionEnv
from .policy import init_mlp_policy
from .train import check_no_mesh


@dataclasses.dataclass
class APGState:
    policy: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # fresh env spawns, on the envs' device
    iteration: int = 0


def make_apg_step(
    env: VisionEnv,
    horizon: int = 8,
    num_envs: int = 8,
    remat: bool = False,
    mesh=None,
    diff_vision: bool = False,
):
    """Build the APG step `ts -> (ts, metrics)`: rollout -> -mean reward ->
    grad through the dynamics (and perception with diff_vision) -> optimizer
    step. Fresh envs each iteration (episodic)."""
    check_no_mesh(mesh)
    from_obs = env.reward_mode == "visibility"

    def see(states: SceneState) -> torch.Tensor:
        if diff_vision:
            return env.observe(states)
        with torch.no_grad():
            return env.observe(states)

    def dyn(states: SceneState, action: torch.Tensor) -> SceneState:
        if not remat:
            return env.dynamics(states, action)

        def pos_vel(pos, vel, act):
            nxt = env.dynamics(states.replace(pos=pos, vel=vel), act)
            return nxt.pos, nxt.vel

        pos, vel = checkpoint(pos_vel, states.pos, states.vel, action, use_reentrant=False)
        return states.replace(pos=pos, vel=vel, t=states.t + 1)

    def loss_fn(policy, states: SceneState) -> torch.Tensor:
        rewards = []
        if from_obs:
            # the reward reads the post-step observation: horizon + 1 renders
            obs = see(states)
            for _ in range(horizon):
                action, _ = policy(obs)
                states = dyn(states, action)
                obs = see(states)
                rewards.append(env.reward_obs(obs).mean())
        else:
            # state reward: render at each iteration's start, horizon renders
            for _ in range(horizon):
                action, _ = policy(see(states))
                states = dyn(states, action)
                rewards.append(env.reward(states).mean())
        return -torch.stack(rewards).mean()

    def apg_step(ts: APGState) -> Tuple[APGState, dict]:
        states = spawn_batch(env.cfg, ts.generator, num_envs, ts.generator.device)
        loss = loss_fn(ts.policy, states)
        ts.optimizer.zero_grad(set_to_none=True)
        if loss.requires_grad:  # not so for semi-APG with a visibility reward
            loss.backward()
        params = [p for group in ts.optimizer.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:  # a zero gradient, as jax.grad gives it
                p.grad = torch.zeros_like(p)
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad) for p in params]))
        ts.optimizer.step()
        loss = loss.detach()
        metrics = {"loss": loss, "reward_mean": -loss, "grad_norm": grad_norm}
        return dataclasses.replace(ts, iteration=ts.iteration + 1), metrics

    return apg_step


def init_apg_state(
    env: VisionEnv,
    seed: int = 0,
    lr: float = 1e-3,
    policy: Optional[nn.Module] = None,
    device: str | torch.device = "cuda",
) -> APGState:
    """A policy (the MLP by default, weights from `seed`) with an Adam
    optimizer on `device`, and the spawn generator seeded with `seed`."""
    device = torch.device(device)
    policy = (policy or init_mlp_policy(env.obs_width, seed)).to(device)
    optimizer = torch.optim.Adam(policy.parameters(), lr=lr)
    return APGState(policy, optimizer, torch.Generator(device=device).manual_seed(seed))
