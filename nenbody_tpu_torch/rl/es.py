"""Antithetic evolution strategies (OpenAI-ES style) on the vision env
(counterpart of nenbody_tpu/rl/es.py), entirely without autograd.

Fitness is the mean reward of the deterministic (mean-action) policy over
`horizon` steps, and the update is the antithetic estimator

    g = 1/(P sigma) sum_i 0.5 (f(theta + sigma eps_i) - f(theta - sigma eps_i)) eps_i

fed (negated, for descent) to the optimizer. All 2P members share one env
spawn (common random numbers), which cancels most fitness variance.

The population is a loop over the 2P members, each a functional_call of the
policy with its perturbed parameters over the whole env batch. Folding the
members into one env batch would launch each kernel once a step instead of
2P times, but at the sizes the trainers run (config-5 width: 4,096 envs x
256 agents a member) one member's batch already fills the card, and the
fold multiplies the working set by 2P; the loop is also what the JAX
trainer does under a mesh (lax.map), so one path serves both. The noise is
drawn through the module-level `_noise`, which a test can replace.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..state import SceneState, spawn_batch
from .env import VisionEnv
from .policy import init_mlp_policy
from .train import batched_env_fns, check_mesh_envs


@dataclasses.dataclass
class ESState:
    policy: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # spawns and noise, on the policy's device
    generation: int = 0


def _noise(params: List[torch.Tensor], population: int,
           generator: torch.Generator) -> List[torch.Tensor]:
    """Standard normal noise [population, *p.shape] for each parameter."""
    return [torch.randn((population, *p.shape), generator=generator, device=p.device,
                        dtype=p.dtype) for p in params]


def make_es_step(
    env: VisionEnv,
    horizon: int = 16,
    population: int = 8,  # antithetic pairs: 2 * population rollouts a generation
    num_envs: int = 4,
    sigma: float = 0.02,
    mesh=None,
):
    """Build the ES generation step `es -> (es, metrics)`. With a mesh each
    member's rollout runs on it (rl/train.py's batched_env_fns)."""
    if mesh is not None:
        check_mesh_envs(mesh, num_envs)
    observe_b, step_b = batched_env_fns(env, mesh)

    def fitness(policy: nn.Module, params: Dict[str, torch.Tensor],
                env_states: SceneState) -> torch.Tensor:
        obs = observe_b(env_states)
        rewards = []
        for _ in range(horizon):
            action, _ = functional_call(policy, params, (obs,))
            env_states, obs, reward = step_b(env_states, action)
            rewards.append(reward.mean())
        return torch.stack(rewards).mean()

    @torch.no_grad()
    def es_step(es: ESState) -> Tuple[ESState, dict]:
        env_states = spawn_batch(env.cfg, es.generator, num_envs, es.generator.device)
        names, params = zip(*es.policy.named_parameters())
        eps = _noise(list(params), population, es.generator)

        def member(i: int, sign: float) -> Dict[str, torch.Tensor]:
            return {n: p + sign * sigma * e[i] for n, p, e in zip(names, params, eps)}

        f_plus = torch.stack([fitness(es.policy, member(i, 1.0), env_states)
                              for i in range(population)])
        f_minus = torch.stack([fitness(es.policy, member(i, -1.0), env_states)
                               for i in range(population)])
        weights = 0.5 * (f_plus - f_minus) / (population * sigma)  # [P]
        for p, e in zip(params, eps):
            p.grad = -torch.tensordot(weights, e, dims=1).to(p.dtype)
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad) for p in params]))
        es.optimizer.step()
        metrics = {
            "fitness_mean": torch.cat([f_plus, f_minus]).mean(),
            "fitness_best": torch.maximum(f_plus, f_minus).max(),
            "grad_norm": grad_norm,
        }
        return dataclasses.replace(es, generation=es.generation + 1), metrics

    return es_step


def init_es_state(
    env: VisionEnv,
    seed: int = 0,
    lr: float = 1e-3,
    policy: Optional[nn.Module] = None,
    device: str | torch.device = "cuda",
) -> ESState:
    """A policy (the MLP by default, weights from `seed`) with an Adam
    optimizer on `device`, and the generator seeded with `seed`. The env
    batch is make_es_step's."""
    device = torch.device(device)
    policy = (policy or init_mlp_policy(env.obs_width, seed)).to(device)
    return ESState(policy, torch.optim.Adam(policy.parameters(), lr=lr),
                   torch.Generator(device=device).manual_seed(seed))
