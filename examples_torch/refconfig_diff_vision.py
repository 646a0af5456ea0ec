"""Differentiable perception at the reference's EXACT observation config
(the port's twin of examples/refconfig_diff_vision.py): N=100 agents
(src/main.rs:654), 1024-px antialiased WIREFRAME eye lines (main.rs:694 +
130-139). Gradient-ASCEND agent positions on the swarm's mutual visibility
(mean eye-row brightness over the background, smooth in the positions
through the AA coverage term).

Autograd flows through the wireframe eye's kernel pair (wireframe_eye.cu
forward, wireframe_eye_bwd.cu backward on the card; one kernel each at
every width, where the JAX package picks a compact or a streaming route).

    python examples_torch/refconfig_diff_vision.py [--n 100] [--width 1024] [--device cuda]
"""

import argparse
import sys

sys.path.insert(0, ".")

import torch

from nenbody_tpu_torch.config import VisionConfig
from nenbody_tpu_torch.ops import wireframe


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = VisionConfig(width=args.width, sprite_mode="wireframe", antialias=True, far=200.0)
    print(f"n={args.n} width={cfg.width} wireframe+AA -> wireframe_eye fwd/bwd pair")

    g = torch.Generator(device=args.device).manual_seed(0)
    pos = (torch.rand((args.n, 2), generator=g, device=args.device) * 200 - 100)
    vel = torch.rand((args.n, 2), generator=g, device=args.device) * 2 - 1
    pos.requires_grad_(True)

    def visibility(pos):
        shade, _ = wireframe.render_rows_wireframe_diff(pos, vel, cfg)
        # sprites render brighter than the clear color; AA coverage makes
        # this smooth as sprites approach/expand in view
        return (shade - cfg.background).mean()

    opt = torch.optim.Adam([pos], lr=args.lr)
    for i in range(args.iters):
        opt.zero_grad()
        v = visibility(pos)
        (-v).backward()
        opt.step()
        if i % 5 == 0 or i == args.iters - 1:
            print(f"iter {i:3d}: mean visibility = {v.item():.5f}")


if __name__ == "__main__":
    main()
