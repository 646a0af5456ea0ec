"""RL-style datagen (BASELINE.json config 5; counterpart of
nenbody_tpu/rl/datagen.py): batched vision+control rollouts exported as
training datasets.

`collect` drives B parallel envs under a policy (or random actions) for T
steps and yields/persists (obs, action, reward) chunks as npz shards in the
JAX package's format: shard_{i:05d}.npz with obs [T, B, N, W+2] (float32,
or the obs_dtype asked for), action [T, B, N, 2] and reward [T, B, N]
float32, so either package's `load_shards` reads the other's.

Overlap of compute and IO. On the card, chunk k+1's kernels are enqueued
before chunk k reaches the host. A host copy on the compute stream would
wait for chunk k+1, so chunk k is copied into pinned host buffers on a side
stream that waits only for an event recorded at chunk k's end; the host
waits for that copy alone and writes the shard while the card computes.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import local_mesh
from ..state import SceneState, spawn_batch
from .env import VisionEnv
from .policy import sample_action
from .train import batched_env_fns, check_mesh_envs


def _random_action(shape, max_accel: float, generator: torch.Generator) -> torch.Tensor:
    """Uniform actions in [-max_accel, max_accel] from `generator`."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (2.0 * max_accel) - max_accel


def make_collect_fn(
    env: VisionEnv,
    policy=None,
    horizon: int = 32,
    obs_dtype: torch.dtype = torch.float32,
    mesh=None,
):
    """Chunk collector: (states, generator) -> (next_states, {obs, action,
    reward}), without autograd. With policy=None, actions are uniform
    random in [-max_accel, max_accel] (pure exploration data); otherwise
    sampled from the policy with the generator's noise. `mesh` runs the sim
    on it (rl/train.py's batched_env_fns), one process's: each chunk
    reaches the host whole, which a batch split across processes cannot
    (the JAX `_drain` fetches its chunks so too)."""
    if mesh is not None:
        local_mesh(mesh, "datagen")
    observe_b, step_b = batched_env_fns(env, mesh)

    @torch.no_grad()
    def chunk(states: SceneState, generator: torch.Generator):
        obs = observe_b(states)
        out = None
        for t in range(horizon):
            if policy is None:
                action = _random_action(obs.shape[:-1] + (2,), env.max_accel, generator)
            else:
                action, _ = sample_action(policy, obs, generator)
            states, next_obs, reward = step_b(states, action)
            if out is None:
                out = {k: v.new_empty((horizon, *v.shape), dtype=dt) for k, v, dt in
                       (("obs", obs, obs_dtype), ("action", action, torch.float32),
                        ("reward", reward, torch.float32))}
            out["obs"][t] = obs
            out["action"][t] = action
            out["reward"][t] = reward
            obs = next_obs
        return states, out

    return chunk


def collect(
    env: VisionEnv,
    num_envs: int,
    total_steps: int,
    seed: int = 0,
    policy=None,
    horizon: int = 32,
    out_dir: Optional[str] = None,
    obs_dtype: torch.dtype = torch.float32,
    mesh=None,
    device: str | torch.device = "cuda",
    stats: Optional[List[dict]] = None,
) -> Iterator[Tuple[int, dict]]:
    """Generate ceil(total_steps/horizon) chunks of batched trajectories from
    envs spawned on `device` by a generator seeded with `seed` (which also
    draws the actions).

    Yields (chunk_index, {obs, action, reward} numpy arrays); with out_dir
    set, each chunk is also written as shard_{i:05d}.npz. Chunk k+1 is
    enqueued before chunk k is copied out (module docstring). With `stats`
    (a list) each chunk appends its timeline on the card, in ms from the
    first chunk's start: `compute` and `copy` (start, end), and `write_s`,
    the host seconds its shard took to write."""
    device = torch.device(device)
    if mesh is not None:
        check_mesh_envs(mesh, num_envs)
    fn = make_collect_fn(env, policy, horizon=horizon, obs_dtype=obs_dtype, mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(seed)
    states = spawn_batch(env.cfg, generator, num_envs, device)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    origin = None
    num_chunks = -(-total_steps // horizon)
    pending = None
    for i in range(num_chunks):
        begin = _event(copy_stream)
        origin = origin or begin
        states, traj = fn(states, generator)
        nxt = _start_copy(i, traj, copy_stream, begin)
        if pending is not None:
            yield _drain(pending, out_dir, stats, origin)
        pending = nxt
    if pending is not None:
        yield _drain(pending, out_dir, stats, origin)


def _event(copy_stream) -> Optional[torch.cuda.Event]:
    """A timing event recorded on the current stream (None on the CPU)."""
    if copy_stream is None:
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _start_copy(i: int, traj: dict, copy_stream, begin):
    """Enqueue chunk i's copy into fresh pinned host buffers on the side
    stream, after an event at the chunk's end on the compute stream."""
    if copy_stream is None:
        return i, traj, None
    done = _event(copy_stream)
    host = {}
    with torch.cuda.stream(copy_stream):
        copy_stream.wait_event(done)
        for k, v in traj.items():
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            v.record_stream(copy_stream)  # keep v's memory until the copy ran
            host[k] = h
        copied = _event(copy_stream)
    return i, host, (begin, done, copied)


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: ml_dtypes' (as jax saves it)
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _drain(pending, out_dir: Optional[str], stats, origin):
    """Wait for chunk i's host copy (not for the compute after it), write
    its shard, return (i, numpy chunk)."""
    i, host, events = pending
    if events is not None:
        events[2].synchronize()
    chunk = {k: _numpy(v) for k, v in host.items()}
    t0 = time.perf_counter()
    if out_dir:
        np.savez(os.path.join(out_dir, f"shard_{i:05d}.npz"), **chunk)
    if stats is not None:
        row = {"chunk": i, "write_s": time.perf_counter() - t0}
        if events is not None:
            begin, done, copied = events
            row.update(compute=(origin.elapsed_time(begin), origin.elapsed_time(done)),
                       copy=(origin.elapsed_time(done), origin.elapsed_time(copied)))
        stats.append(row)
    return i, chunk


def load_shards(out_dir: str) -> dict:
    """Concatenate all shards along time: {obs, action, reward}."""
    files = sorted(
        f for f in os.listdir(out_dir)
        if f.startswith("shard_") and f.endswith(".npz")
    )
    if not files:
        raise FileNotFoundError(f"no shard_*.npz in {out_dir}")
    parts = [np.load(os.path.join(out_dir, f)) for f in files]
    return {
        k: np.concatenate([p[k] for p in parts], axis=0)
        for k in ("obs", "action", "reward")
    }
