"""PPO at production scale on one card (the port's twin of
examples/ppo_scale.py): thousands of parallel envs, per-agent advantages
over a long horizon, agent-frames per second through the full train step
(rollout + vision + GAE + epochs of minibatched updates). Difference
rewards (reward_mode="difference", the closed-form counterfactual
D_i = G - G_without_i) sharpen credit assignment at scale. The port's PPO
step takes plain Adam: the JAX example's global-norm clip (optax.chain) has
no counterpart in rl/ppo.py.

    python examples_torch/ppo_scale.py --envs 4096 --agents 64 --iters 20 [--device cuda]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from nenbody_tpu_torch.config import SimConfig, VisionConfig
from nenbody_tpu_torch.rl import ppo
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.rl.policy import MLPPolicy, ValueMLP, seeded
from nenbody_tpu_torch.state import spawn_batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reward", default="difference",
                    choices=["cohesion", "team", "difference"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--max-accel", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    cfg = SimConfig(n=args.agents, controller="gravity", vision=VisionConfig(width=args.width))
    env = VisionEnv(cfg, max_accel=args.max_accel, reward_mode=args.reward)
    # evaluation always reads the GLOBAL cohesion objective: difference/team
    # rewards are per-agent counterfactual shares whose mean is ~0 by
    # construction and unreadable as a progress metric
    eval_env = VisionEnv(cfg, max_accel=args.max_accel, reward_mode="cohesion")
    ts = ppo.init_ppo_state(
        env, seed=0, lr=args.lr, device=device,
        policy=seeded(0, lambda: MLPPolicy(env.obs_width, use_bf16=False)),
        value=seeded(1, lambda: ValueMLP(env.obs_width)),
    )
    step = ppo.make_ppo_step(env, horizon=args.horizon, num_envs=args.envs)

    # fixed eval set: fresh training spawns mask the learning trend
    eval_envs = spawn_batch(cfg, torch.Generator(device=device).manual_seed(999),
                            min(args.envs, 256), device)

    @torch.no_grad()
    def evaluate(policy):
        states, rewards = eval_envs, []
        for _ in range(args.horizon):
            action, _ = policy(eval_env.observe(states))
            states = eval_env.dynamics(states, action)
            rewards.append(eval_env.reward(states).mean())
        return float(torch.stack(rewards).mean())

    frames = args.envs * args.agents * args.horizon
    r0 = evaluate(ts.policy)
    print(f"eval reward before: {r0:.4f}", flush=True)

    t_first = time.time()
    ts, metrics = step(ts)
    sync()
    print(f"first step (kernel build and warm-up): {time.time()-t_first:.1f}s", flush=True)

    t0 = time.time()
    for i in range(args.iters):
        ts, metrics = step(ts)
        if (i + 1) % 5 == 0:
            dt = (time.time() - t0) / (i + 1)
            print(f"iter {i+1}: reward {float(metrics['reward_mean']):.4f} "
                  f"| {dt:.2f}s/iter = {frames/dt/1e6:.2f}M agent-steps/s", flush=True)
    sync()
    total = time.time() - t0
    r1 = evaluate(ts.policy)
    print(f"eval reward after: {r1:.4f} (delta {r1-r0:+.4f}) | {args.iters} iters, "
          f"{total/max(args.iters, 1):.2f}s/iter, "
          f"{frames*args.iters/total/1e6:.2f}M agent-steps/s sustained", flush=True)


if __name__ == "__main__":
    main()
