"""REINFORCE over batched vision envs (counterpart of nenbody_tpu/rl/train.py:
`Trajectory`, `TrainState`, `discounted_returns`, `make_train_step`,
`init_train_state`, the recurrent `make_recurrent_train_step` and
`init_recurrent_train_state`, and `mesh=`).

The rollout steps the batch of env states directly (the env takes leading
batch dims; no vmap) under torch.no_grad(): as in the JAX trainer the
actions are detached and gradients flow only through the policy log-probs
of the recorded trajectory, so the sim runs the forward-only kernel
launches. The policy and its optimizer live in the train state; a step
updates them in place and returns the state with the new env states.

With a mesh (parallel.mesh.Mesh) the sim runs on it. A mesh with an agent
axis runs physics and vision on the agent-axis ring (parallel/ring.py),
with the env batch split over its data axis when it has one; a data-only
mesh splits the env batch over its devices and runs each block through the
env on its device. The controller keeps the env states and the policy on
their device (single-controller, as the JAX trainers): the ring moves the
blocks to the mesh's devices and gathers the results back.

On a mesh across processes (parallel.mesh.init_distributed, then
make_mesh()) every process runs the same step on its block of the env
states and a replica of the policy (rl/spmd.py): spawns and action noise
drawn whole from the shared generator, the reductions and the loss's
means global, the gradients all-reduced after backward(), so every
process ends the step with the same loss, metrics and policy.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..state import SceneState, spawn_batch
from .env import VisionEnv
from .policy import (GRUPolicy, gaussian_log_prob, init_mlp_policy, sample_action,
                     sample_gaussian, seeded)
from .spmd import Spmd


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


def start_states(env: VisionEnv, ts, episodic: bool, spmd: Spmd) -> SceneState:
    """The env states an iteration starts from: fresh spawns from the
    state's generator (as many as it holds; across processes the whole
    batch, of which this process keeps its block) when `episodic`, else its
    own."""
    if not episodic:
        return ts.env_states
    pos = ts.env_states.pos
    return spmd.block_state(spawn_batch(env.cfg, ts.generator, spmd.num_envs(pos.shape[0]),
                                        pos.device))


def _reinforce_advantages(rets: torch.Tensor, standardize: bool, spmd: Spmd) -> torch.Tensor:
    """Returns-to-go minus their mean, over their std when `standardize`
    (jnp.std's ddof 0: torch.std's default ddof 1 would change the loss);
    both of the whole batch."""
    adv = rets - spmd.mean(rets)
    return adv / (spmd.std(adv) + 1e-6) if standardize else adv


def _sample(policy, obs, generator, spmd: Spmd):
    """sample_action; across processes with the whole batch's noise."""
    if spmd.on:
        return spmd.sample_action(policy, obs, generator)
    return sample_action(policy, obs, generator)


def check_mesh_envs(mesh, num_envs: int) -> None:
    """The ring pads the agent axis to any N, but the env batch must divide
    the mesh's data axis: raise that before any rollout."""
    from ..parallel.mesh import data_axis_of

    da = data_axis_of(mesh)
    if da is not None and num_envs % mesh.shape[da]:
        raise ValueError(
            f"env batch {num_envs} must divide evenly over mesh axis {da!r} "
            f"(size {mesh.shape[da]})"
        )


def _on_data_shards(mesh, fn, states: SceneState, *tensors):
    """fn(state block, *tensor blocks) on each of this process's devices of
    a data-only mesh, its env batch split over them; its outputs (a state,
    then tensors) gathered back to the states' device."""
    from ..parallel.mesh import DATA_AXIS, gather_blocks, on_device, split_blocks

    if DATA_AXIS not in mesh.axis_names:
        raise ValueError(
            "a mesh without an agent axis needs a data axis to split envs "
            f"over; got axes {mesh.axis_names}"
        )
    rows, _ = mesh.own(DATA_AXIS, None)
    grid = [mesh.grid(DATA_AXIS, None)[r] for r in rows]
    if states.pos.shape[0] % len(grid):
        raise ValueError(f"env batch {states.pos.shape[0]} must divide evenly over this "
                         f"process's {len(grid)} devices of mesh axis {DATA_AXIS!r}")
    names = ("pos", "vel", "t")
    blocks = [split_blocks(x, grid, 0, agent_dim=None)
              for x in (*(getattr(states, k) for k in names), *tensors)]
    outs = []
    for r, (dev,) in enumerate(grid):
        with on_device(dev):
            state = SceneState(**{k: b[r][0] for k, b in zip(names, blocks)})
            outs.append(fn(state, *(b[r][0] for b in blocks[len(names):])))
    home = states.pos.device

    def gather(parts):
        return gather_blocks([[p] for p in parts], home, 0, agent_dim=None)

    state = SceneState(**{k: gather([getattr(o[0], k) for o in outs]) for k in names})
    return (state, *(gather([o[i] for o in outs]) for i in range(1, len(outs[0]))))


def ring_dynamics(env: VisionEnv, mesh, spmd: Spmd):
    """`(states, action) -> states`: env.dynamics with the forces on the
    agent-axis ring (differentiable: each hop's gravity Function, and
    across processes each hop's exchange)."""
    from ..parallel import ring
    from ..parallel.mesh import data_axis_of

    data_axis = data_axis_of(mesh)

    def dynamics(states: SceneState, action: torch.Tensor) -> SceneState:
        g = ring.ring_gravity_forces(spmd.lift(states.pos), env.cfg, mesh=mesh,
                                     data_axis=data_axis)
        return env.integrate(states, action, spmd.local(g))

    return dynamics


def ring_observe(env: VisionEnv, mesh, spmd: Spmd, diff: bool = False):
    """`states -> obs [B, N, W+2]`: env.observe with the eye on the
    agent-axis ring (ring_render_rows_diff with `diff`)."""
    from ..parallel import ring
    from ..parallel.mesh import data_axis_of

    render_ring = ring.ring_render_rows_diff if diff else ring.ring_render_rows
    vcfg, data_axis = env.cfg.vision, data_axis_of(mesh)

    def observe(states: SceneState) -> torch.Tensor:
        lines = render_ring(spmd.lift(states.pos), spmd.lift(states.vel), vcfg, mesh=mesh,
                            data_axis=data_axis)[0]
        return torch.cat([spmd.local(lines), states.vel], dim=-1)

    return observe


def mesh_env_fns(env: VisionEnv, mesh, diff: bool = False):
    """(observe, dynamics) over batched states [B, N, 2]: the env's own
    without a mesh; with an agent axis the ring's (the JAX
    `_batched_env_fns`; the eye through ring_render_rows_diff with `diff`);
    on a data-only mesh the env's on each data shard (`_dp_mesh_env_fns`).
    Across processes the states are this process's block (rl/spmd.py)."""
    from ..parallel.mesh import agent_axis_of

    if mesh is None:
        return env.observe, env.dynamics
    if agent_axis_of(mesh) is None:
        return (lambda s: _on_data_shards(mesh, lambda b: (b, env.observe(b)), s)[1],
                lambda s, a: _on_data_shards(mesh, lambda b, x: (env.dynamics(b, x),),
                                             s, a)[0])
    spmd = Spmd(mesh, env.cfg.n)
    return ring_observe(env, mesh, spmd, diff), ring_dynamics(env, mesh, spmd)


def batched_env_fns(env: VisionEnv, mesh):
    """(observe, step) over batched states [B, N, 2] on `mesh`
    (mesh_env_fns). Visibility rewards read the observation the step
    rendered; the state rewards reduce over the global agent axis."""
    if mesh is None:
        return env.observe, env.step
    agent_sum = Spmd(mesh, env.cfg.n).agent_sum
    observe, dynamics = mesh_env_fns(env, mesh)

    def step(states, action):
        nxt = dynamics(states, action)
        obs = observe(nxt)
        reward = (env.reward_obs(obs) if env.reward_mode == "visibility"
                  else env.reward(nxt, agent_sum))
        return nxt, obs, reward

    return observe, step


def discounted_returns(rewards: torch.Tensor, gamma: float) -> torch.Tensor:
    """Returns-to-go along the leading time axis."""
    rets = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[0])
    for t in reversed(range(rewards.shape[0])):
        carry = rewards[t] + gamma * carry
        rets[t] = carry
    return rets


def sampled_rollout(policy, observe_b, step_b, env_states: SceneState, generator,
                    horizon: int, spmd: Spmd) -> Tuple[SceneState, Trajectory]:
    """`horizon` steps of actions sampled from `policy` (call under
    torch.no_grad(): the actions are the data the loss scores): (the last
    env states, the trajectory)."""
    obs = observe_b(env_states)
    obs_t, act_t, rew_t = [], [], []
    for _ in range(horizon):
        action, _ = _sample(policy, obs, generator, spmd)
        env_states, next_obs, reward = step_b(env_states, action)
        obs_t.append(obs)
        act_t.append(action)
        rew_t.append(reward)
        obs = next_obs
    return env_states, Trajectory(torch.stack(obs_t), torch.stack(act_t), torch.stack(rew_t))


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
    False for deliberate continuing-task training. With `mesh` the sim runs
    on it (module docstring)."""
    spmd = Spmd(mesh, env.cfg.n)
    observe_b, step_b = batched_env_fns(env, mesh)

    def train_step(ts: TrainState) -> Tuple[TrainState, dict]:
        with torch.no_grad():
            env_states, traj = sampled_rollout(ts.policy, observe_b, step_b,
                                               start_states(env, ts, episodic, spmd),
                                               ts.generator, horizon, spmd)
            rets = discounted_returns(traj.reward, gamma)
            adv = _reinforce_advantages(rets, standardize_adv, spmd)
        mean, log_std = ts.policy(traj.obs)
        loss = -spmd.share(gaussian_log_prob(traj.action, mean, log_std) * adv)
        return _reinforce_update(ts, loss, env_states, traj, rets, spmd)

    return train_step


def _reinforce_update(ts: TrainState, loss: torch.Tensor, env_states: SceneState,
                      traj: Trajectory, rets: torch.Tensor,
                      spmd: Spmd) -> Tuple[TrainState, dict]:
    """One optimizer step on `loss` (this process's share; the gradients
    summed over the processes); the REINFORCE metrics."""
    ts.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    spmd.sync_grads(ts.policy.parameters())
    ts.optimizer.step()
    metrics = {
        "loss": spmd.total(loss.detach()),
        "reward_mean": spmd.mean(traj.reward),
        "return_mean": spmd.mean(rets),
    }
    return dataclasses.replace(ts, env_states=env_states), metrics


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
    `device`; the random stream is a generator seeded with `seed`. With a
    mesh the env batch must divide its data axis; states and policy stay on
    `device`, the controller's (module docstring). Across processes the
    state holds this process's block of the envs and rank 0's policy."""
    policy = policy or init_mlp_policy(env.obs_width, seed)
    return _train_state(env, num_envs, seed, lr, policy, device, mesh)


def spawn_envs(env: VisionEnv, num_envs: int, seed: int, device: str | torch.device,
               mesh=None) -> Tuple[SceneState, torch.Generator]:
    """`num_envs` envs spawned on `device` from a generator seeded with
    `seed` there, and that generator; with a mesh the env batch must divide
    its data axis, and across processes this process keeps its block."""
    if mesh is not None:
        check_mesh_envs(mesh, num_envs)
    generator = torch.Generator(device=device).manual_seed(seed)
    states = spawn_batch(env.cfg, generator, num_envs, device)
    return Spmd(mesh, env.cfg.n).block_state(states), generator


def _train_state(env, num_envs, seed, lr, policy, device, mesh) -> TrainState:
    env_states, generator = spawn_envs(env, num_envs, seed, device, mesh)
    policy = policy.to(device)
    Spmd(mesh, env.cfg.n).broadcast(policy)
    return TrainState(policy, torch.optim.Adam(policy.parameters(), lr=lr), env_states, generator)


def make_recurrent_train_step(
    env: VisionEnv,
    horizon: int = 8,
    gamma: float = 0.99,
    mesh=None,
    episodic: bool = True,
    standardize_adv: bool = True,
):
    """REINFORCE with a recurrent policy (GRUPolicy): the rollout threads
    the hidden state beside the env state (no grad, actions detached), and
    the loss re-runs the recurrence over the recorded observations and
    actions from a zero carry, so the log-prob gradient flows through it:
    backpropagation through time over the horizon. The carry starts at
    zero each iteration (with episodic=False: truncated BPTT, the envs
    persist and the memory does not). `mesh` as make_train_step's."""
    spmd = Spmd(mesh, env.cfg.n)
    observe_b, step_b = batched_env_fns(env, mesh)

    def gaussian(mean, log_std, generator):
        if spmd.on:
            return mean + torch.exp(log_std) * spmd.noise(generator, mean)
        return sample_gaussian(mean, log_std, generator)

    def rollout(policy, env_states: SceneState, generator) -> Tuple[SceneState, Trajectory]:
        obs = observe_b(env_states)
        h = policy.initial_carry(env_states.pos.shape[:-1], obs.device)
        obs_t, act_t, rew_t = [], [], []
        for _ in range(horizon):
            h, (mean, log_std) = policy(h, obs)
            action = gaussian(mean, log_std, generator)
            env_states, next_obs, reward = step_b(env_states, action)
            obs_t.append(obs)
            act_t.append(action)
            rew_t.append(reward)
            obs = next_obs
        return env_states, Trajectory(torch.stack(obs_t), torch.stack(act_t), torch.stack(rew_t))

    def train_step(ts: TrainState) -> Tuple[TrainState, dict]:
        start = start_states(env, ts, episodic, spmd)
        with torch.no_grad():
            env_states, traj = rollout(ts.policy, start, ts.generator)
            rets = discounted_returns(traj.reward, gamma)
            adv = _reinforce_advantages(rets, standardize_adv, spmd)
        h = ts.policy.initial_carry(start.pos.shape[:-1], start.pos.device)
        logp = []
        for obs, action in zip(traj.obs, traj.action):
            h, (mean, log_std) = ts.policy(h, obs)
            logp.append(gaussian_log_prob(action, mean, log_std))
        loss = -spmd.share(torch.stack(logp) * adv)
        return _reinforce_update(ts, loss, env_states, traj, rets, spmd)

    return train_step


def init_recurrent_train_state(
    env: VisionEnv,
    num_envs: int,
    seed: int = 0,
    lr: float = 1e-3,
    policy: Optional[GRUPolicy] = None,
    device: str | torch.device = "cuda",
    mesh=None,
) -> TrainState:
    """init_train_state for a recurrent policy (a GRUPolicy, weights from
    `seed`, by default)."""
    policy = policy or seeded(seed, lambda: GRUPolicy(env.obs_width))
    return _train_state(env, num_envs, seed, lr, policy, device, mesh)
