"""Flocking demo (the port's twin of examples/flocking_demo.py): the analog
of the reference's flocking-vision video (README.md:18-21). Boids form
moving flocks under the three reference rules (boids.cu on the card).

    python examples_torch/flocking_demo.py [--n 4096] [--steps 600] [--device cuda]
"""

import argparse
import sys

sys.path.insert(0, ".")

from nenbody_tpu_torch import Scene, SimConfig, VisionConfig
from nenbody_tpu_torch.viz.viewer import record_rollout_gif


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--out", default="out/flocking_demo.gif")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = SimConfig(n=args.n, controller="boids", vision=VisionConfig(width=128))
    scene = Scene(cfg, device=args.device)
    state = scene.spawn(seed=0)
    path = record_rollout_gif(
        scene, state, num_steps=args.steps, path=args.out, stride=8,
        half_extent=120.0,
    )
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
