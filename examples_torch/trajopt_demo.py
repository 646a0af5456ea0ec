"""Trajectory optimization through the differentiable physics (the port's
twin of examples/trajopt_demo.py): find initial velocities that minimize
the swarm's final spread after a gravity rollout. Autograd flows through
every force evaluation via the gravity VJP kernel (gravity_vjp.cu on the
card; ops/pairwise.py's GravityForcesDiff).

    python examples_torch/trajopt_demo.py [--n 256] [--horizon 20] [--iters 30] [--device cuda]
"""

import argparse
import sys

sys.path.insert(0, ".")

import torch

from nenbody_tpu_torch import SimConfig, spawn
from nenbody_tpu_torch.ops import tiled


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = SimConfig(n=args.n, controller="gravity", backend="pallas")
    state0 = spawn(cfg, torch.Generator(device=args.device).manual_seed(0), args.device)

    def final_spread(vel0):
        s = state0.replace(vel=vel0)
        for _ in range(args.horizon):
            s = tiled.gravity_step(s, cfg=cfg)
        centroid = s.pos.mean(dim=0)
        return ((s.pos - centroid) ** 2).sum(dim=-1).mean()

    vel = state0.vel.clone().requires_grad_(True)
    opt = torch.optim.Adam([vel], lr=args.lr)
    for i in range(args.iters):
        opt.zero_grad()
        loss = final_spread(vel)
        loss.backward()
        opt.step()
        if i % 5 == 0 or i == args.iters - 1:
            print(f"iter {i:3d}: final spread = {loss.item():10.2f}")


if __name__ == "__main__":
    main()
