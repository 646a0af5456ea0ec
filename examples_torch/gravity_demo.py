"""Gravity + vision demo (the port's twin of examples/gravity_demo.py): the
analog of the reference's gravity-vision video (README.md:14-17). N bodies
collapse under the 1/(r^2+bias) force law while each streams a 1D eye line;
writes a GIF (gravity.cu and disc_eye.cu on the card).

    python examples_torch/gravity_demo.py [--n 1024] [--steps 400] [--device cuda]
"""

import argparse
import sys

sys.path.insert(0, ".")

from nenbody_tpu_torch import Scene, SimConfig, VisionConfig
from nenbody_tpu_torch.viz.viewer import record_rollout_gif


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--out", default="out/gravity_demo.gif")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = SimConfig(n=args.n, controller="gravity", vision=VisionConfig(width=64))
    scene = Scene(cfg, device=args.device)
    state = scene.spawn(seed=0)
    path = record_rollout_gif(
        scene, state, num_steps=args.steps, path=args.out, stride=4,
        half_extent=150.0,
    )
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
