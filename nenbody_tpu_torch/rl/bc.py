"""Behavior cloning: fit a policy to recorded (obs, action) datasets
(counterpart of nenbody_tpu/rl/bc.py).

Closes the datagen loop: `rl/datagen.py` exports batched rollout shards;
this trains a Gaussian policy on them by maximizing the action log-density.
Recordings are a data source too: `dataset_from_trajectory` reads a
`.nentraj` file (`run --record`, utils/native.py) and recovers the
demonstrator's actions by inverse dynamics: the gravity world's transition
is v' = v + (g(x) + a) dt, so a = (v' - v)/dt - g(x), frame to frame, with
the observations re-rendered from the recorded states. `distill` and
`fit_streaming` clone without any host export: a teacher function, or the
datagen collector's chunks, feed the updates on the device.

The BC state holds the policy, its Adam optimizer and the generator that
draws the minibatches (through the module-level `_minibatch`, which a test
can replace).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import local_mesh
from ..state import spawn_batch
from .env import VisionEnv
from .policy import gaussian_log_prob, init_mlp_policy
from .train import batched_env_fns, check_mesh_envs


@dataclasses.dataclass
class BCState:
    policy: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # minibatch draws, on the data's device
    step: int = 0


def flatten_dataset(data: dict) -> Tuple[np.ndarray, np.ndarray]:
    """{obs [T,B,N,W], action [T,B,N,2]} -> (obs [M,W], action [M,2])."""
    obs = np.asarray(data["obs"], np.float32)
    act = np.asarray(data["action"], np.float32)
    return obs.reshape(-1, obs.shape[-1]), act.reshape(-1, act.shape[-1])


@torch.no_grad()
def dataset_from_trajectory(path: str, env: VisionEnv, chunk: int = 64,
                            device: str | torch.device = "cuda") -> dict:
    """.nentraj recording -> {obs [T-1,1,N,W+2], action [T-1,1,N,2]} numpy.

    Observations re-render on `device` from the recorded (pos, vel);
    actions come from exact inverse dynamics (module docstring). Requires a
    stride-1 recording (`run --record ... --log-every 1`): with missing
    intermediate frames the inverse is ill-posed."""
    from ..utils import native

    ts, pos, vel = native.read_trajectory(path)
    if len(ts) < 2:
        raise ValueError(f"{path}: need >= 2 frames for inverse dynamics")
    dt_frames = np.diff(ts)
    if not (dt_frames == 1).all():
        raise ValueError(
            f"{path}: inverse dynamics needs consecutive frames (stride 1); "
            f"got t deltas {sorted(set(dt_frames.tolist()))} — record with "
            f"--log-every 1"
        )
    if pos.shape[1] != env.cfg.n:
        raise ValueError(
            f"{path}: recording has {pos.shape[1]} agents, env expects "
            f"{env.cfg.n}"
        )
    pos_t = torch.as_tensor(pos, device=device)
    vel_t = torch.as_tensor(vel, device=device)
    dt = env.cfg.gravity.dt
    obs_chunks, act_chunks = [], []
    for i in range(0, len(ts) - 1, chunk):
        j = min(i + chunk, len(ts) - 1)
        p, v = pos_t[i:j], vel_t[i:j]
        action = (vel_t[i + 1:j + 1] - v) / dt - env._forces(p)
        obs = torch.cat([env._render(p, v)[0], v], dim=-1)
        obs_chunks.append(obs.cpu().numpy())
        act_chunks.append(action.cpu().numpy())
    obs = np.concatenate(obs_chunks)[:, None]  # [T-1, B=1, N, W+2]
    act = np.concatenate(act_chunks)[:, None]
    return {"obs": obs, "action": act}


def _minibatch(n: int, size: int, generator: torch.Generator) -> torch.Tensor:
    """`size` sample indices in [0, n), drawn with replacement."""
    return torch.randint(0, n, (size,), generator=generator, device=generator.device)


def make_bc_step(batch_size: int = 4096, time_minibatch: bool = False):
    """The minibatch step `(ts, obs, act) -> (ts, loss)` over
    device-resident arrays: the negative log-density of the minibatch's
    actions, one optimizer step.

    time_minibatch: obs/act arrive unflattened [T, B, N, F] and minibatches
    are whole time rows (ceil(batch_size / B*N) of them), as the JAX step
    draws them on a mesh."""

    def bc_step(ts: BCState, obs: torch.Tensor, act: torch.Tensor):
        if time_minibatch:
            rows = max(1, -(-batch_size // int(np.prod(obs.shape[1:-1]))))
            idx = _minibatch(obs.shape[0], rows, ts.generator)
        else:
            idx = _minibatch(obs.shape[0], batch_size, ts.generator)
        mean, log_std = ts.policy(obs[idx])
        loss = -gaussian_log_prob(act[idx], mean, log_std).mean()
        ts.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ts.optimizer.step()
        return dataclasses.replace(ts, step=ts.step + 1), loss.detach()

    return bc_step


def _bc_state(env: VisionEnv, seed: int, lr: float, policy: Optional[nn.Module],
              device) -> BCState:
    policy = (policy or init_mlp_policy(env.obs_width, seed)).to(device)
    return BCState(policy, torch.optim.Adam(policy.parameters(), lr=lr),
                   torch.Generator(device=device).manual_seed(seed))


def distill(
    env: VisionEnv,
    teacher_fn: Callable[[torch.Tensor], torch.Tensor],
    seed: int = 0,
    iters: int = 20,
    num_envs: int = 16,
    horizon: int = 8,
    bc_steps_per_iter: int = 16,
    batch_size: int = 2048,
    lr: float = 1e-3,
    policy: Optional[nn.Module] = None,
    episodic: bool = True,
    mesh=None,
    device: str | torch.device = "cuda",
) -> Tuple[nn.Module, np.ndarray]:
    """On-device distillation, with no host export: each iteration (a)
    respawns the envs (episodic), (b) rolls them `horizon` steps under the
    teacher (any obs -> action function, e.g. rl.scripted's controllers),
    keeping the (obs, action) shard on the device, and (c) runs
    `bc_steps_per_iter` minibatch updates on it. With `mesh` the rollouts
    run on it and minibatches are whole time rows. Returns (policy, losses
    [iters * bc_steps_per_iter])."""
    device = torch.device(device)
    if mesh is not None:
        local_mesh(mesh, "BC")
        check_mesh_envs(mesh, num_envs)
    observe_b, step_b = batched_env_fns(env, mesh)
    ts = _bc_state(env, seed, lr, policy, device)
    states = spawn_batch(env.cfg, ts.generator, num_envs, device)
    shard = num_envs * horizon * env.cfg.n
    step = make_bc_step(min(batch_size, shard), time_minibatch=mesh is not None)
    losses = []
    for _ in range(iters):
        with torch.no_grad():
            if episodic:
                states = spawn_batch(env.cfg, ts.generator, num_envs, device)
            obs = observe_b(states)
            obs_sh, act_sh = [], []
            for _ in range(horizon):
                act = teacher_fn(obs)
                obs_sh.append(obs)
                act_sh.append(act)
                states, obs, _ = step_b(states, act)
            obs_sh, act_sh = torch.stack(obs_sh), torch.stack(act_sh)
            if mesh is None:
                obs_sh = obs_sh.reshape(-1, obs_sh.shape[-1])
                act_sh = act_sh.reshape(-1, act_sh.shape[-1])
        for _ in range(bc_steps_per_iter):
            ts, loss = step(ts, obs_sh, act_sh)
            losses.append(loss)
    return ts.policy, torch.stack(losses).cpu().numpy()


def fit_streaming(
    env: VisionEnv,
    seed: int = 0,
    total_steps: int = 256,
    num_envs: int = 16,
    horizon: int = 16,
    behavior: Optional[nn.Module] = None,
    bc_steps_per_shard: int = 8,
    batch_size: int = 2048,
    lr: float = 1e-3,
    policy: Optional[nn.Module] = None,
    episodic: bool = True,
    mesh=None,
    device: str | torch.device = "cuda",
) -> Tuple[nn.Module, np.ndarray]:
    """BC directly from device-resident datagen chunks: the collector of
    rl.datagen (the one the npz path uses) generates shards under the
    `behavior` policy (uniform exploration with None) that feed the BC
    steps as device tensors, never reaching the host. Shards respawn
    episodically by default. With `mesh` the chunks are generated on it and
    minibatches are whole time rows. Returns (policy, losses [num_chunks *
    bc_steps_per_shard])."""
    from .datagen import make_collect_fn

    device = torch.device(device)
    if mesh is not None:
        local_mesh(mesh, "BC")
        check_mesh_envs(mesh, num_envs)
    collect_fn = make_collect_fn(env, behavior, horizon=horizon, mesh=mesh)
    ts = _bc_state(env, seed, lr, policy, device)
    states = spawn_batch(env.cfg, ts.generator, num_envs, device)
    step = make_bc_step(min(batch_size, num_envs * horizon * env.cfg.n),
                        time_minibatch=mesh is not None)
    losses = []
    for _ in range(-(-total_steps // horizon)):
        if episodic:
            states = spawn_batch(env.cfg, ts.generator, num_envs, device)
        states, traj = collect_fn(states, ts.generator)
        obs, act = traj["obs"], traj["action"]
        if mesh is None:
            obs = obs.reshape(-1, obs.shape[-1])
            act = act.reshape(-1, act.shape[-1])
        for _ in range(bc_steps_per_shard):
            ts, loss = step(ts, obs, act)
            losses.append(loss)
    return ts.policy, torch.stack(losses).cpu().numpy()


def fit(
    env: VisionEnv,
    data: dict,
    seed: int = 0,
    steps: int = 1000,
    batch_size: int = 4096,
    lr: float = 1e-3,
    policy: Optional[nn.Module] = None,
    log_every: int = 0,
    device: str | torch.device = "cuda",
) -> Tuple[nn.Module, float]:
    """Train a policy (the MLP by default, weights from `seed`) on a dataset
    dict (from datagen.load_shards or dataset_from_trajectory), the data on
    `device`. Returns (policy, final_loss)."""
    if steps <= 0:
        raise ValueError(f"steps must be positive, got {steps}")
    obs_np, act_np = flatten_dataset(data)
    if obs_np.shape[-1] != env.obs_width:
        raise ValueError(
            f"dataset obs width {obs_np.shape[-1]} != env obs width {env.obs_width}"
        )
    device = torch.device(device)
    obs = torch.as_tensor(obs_np, device=device)
    act = torch.as_tensor(act_np, device=device)
    ts = _bc_state(env, seed, lr, policy, device)
    step = make_bc_step(batch_size=min(batch_size, obs.shape[0]))
    loss = None
    for i in range(steps):
        ts, loss = step(ts, obs, act)
        if log_every and i % log_every == 0:
            print(f"bc step {i}: loss {float(loss):.4f}", flush=True)
    return ts.policy, float(loss)
