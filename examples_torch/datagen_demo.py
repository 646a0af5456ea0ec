"""Batched-env datagen demo (the port's twin of examples/datagen_demo.py,
BASELINE config 5): 4,096 envs x 256 agents rolling out with vision
observations. Prints agent-frames/s and the trajectory tensor shapes.

    python examples_torch/datagen_demo.py [--envs 4096] [--agents 256] [--device cuda]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import torch

from nenbody_tpu_torch import Scene, SimConfig, VisionConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--agents", type=int, default=256)
    ap.add_argument("--horizon", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = SimConfig(n=args.agents, controller="gravity", vision=VisionConfig(width=64))
    scene = Scene(cfg, device=args.device)
    batch = scene.spawn_envs(args.envs, seed=0)
    sync = torch.cuda.synchronize if scene.device.type == "cuda" else (lambda: None)

    with torch.no_grad():
        scene.rollout(batch, args.horizon, record=("obs",))  # warm-up (kernel build)
        sync()
        t0 = time.perf_counter()
        _, traj = scene.rollout(batch, args.horizon, record=("obs",))
        sync()
        dt = time.perf_counter() - t0

    frames = args.envs * args.agents * args.horizon
    print(f"obs tensor: {tuple(traj['obs'].shape)}  ({traj['obs'].dtype}) on {scene.device}")
    print(f"{frames} agent-frames in {dt:.3f}s -> {frames/dt:.3e} agent-frames/s")


if __name__ == "__main__":
    main()
