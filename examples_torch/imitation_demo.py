"""Imitation from vision (the port's twin of examples/imitation_demo.py):
distill a scripted seek controller into an MLP.

expert (scripted phototaxis) --datagen--> (obs, action) chunks --BC--> MLP,
then closed-loop evaluation of expert vs clone vs no-op on fresh envs.

    python examples_torch/imitation_demo.py [--device cuda]
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np
import torch

from nenbody_tpu_torch import SimConfig, VisionConfig
from nenbody_tpu_torch.rl import bc, datagen, scripted
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.state import spawn_batch


@torch.no_grad()
def closed_loop_reward(env, act, seed, device, num_envs=16, horizon=64):
    """Mean reward of `act(obs) -> action` over fresh envs (deterministic)."""
    states = spawn_batch(env.cfg, torch.Generator(device=device).manual_seed(seed), num_envs,
                         device)
    obs = env.observe(states)
    rewards = []
    for _ in range(horizon):
        states, obs, reward = env.step(states, act(obs))
        rewards.append(reward.mean())
    return float(torch.stack(rewards).mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=32)
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--bc-steps", type=int, default=1500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    env = VisionEnv(
        SimConfig(n=args.agents, controller="gravity", vision=VisionConfig(width=32)),
        max_accel=0.5,
        speed_penalty=0.02,
    )
    expert = scripted.ScriptedPolicy(scripted.seek_brightest, gain=0.3)

    print("collecting expert dataset...", flush=True)
    chunks = [c for _, c in datagen.collect(env, num_envs=args.envs, total_steps=64, seed=0,
                                            policy=expert, horizon=16, device=device)]
    data = {k: np.concatenate([c[k] for c in chunks], axis=0)
            for k in ("obs", "action", "reward")}
    print(f"dataset: obs {data['obs'].shape}", flush=True)

    print("behavior cloning...", flush=True)
    clone, loss = bc.fit(env, data, seed=1, steps=args.bc_steps, batch_size=8192, lr=2e-3,
                         device=device)
    print(f"final BC loss: {loss:.4f}", flush=True)

    r_expert = closed_loop_reward(env, lambda o: expert(o)[0], 2, device)
    r_clone = closed_loop_reward(env, lambda o: clone(o)[0], 2, device)
    r_zero = closed_loop_reward(env, lambda o: torch.zeros(o.shape[:-1] + (2,), device=device),
                                2, device)
    print(f"closed-loop mean reward: expert {r_expert:.4f} | "
          f"clone {r_clone:.4f} | no-op {r_zero:.4f}")
    gap = (r_clone - r_zero) / max(abs(r_expert - r_zero), 1e-9)
    print(f"clone recovers {100*gap:.0f}% of the expert's improvement over no-op")


if __name__ == "__main__":
    main()
