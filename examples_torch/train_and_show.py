"""Train a cohesion policy with APG (gradients through the physics) and
render untrained-vs-trained behaviour side by side (the port's twin of
examples/train_and_show.py; the GIF through viz.image, no imageio).

    python examples_torch/train_and_show.py [--iters 300] [--out out/trained_policy.gif] [--device cuda]
"""

import argparse
import copy
import os
import sys

sys.path.insert(0, ".")

import numpy as np
import torch

from nenbody_tpu_torch import SimConfig, VisionConfig
from nenbody_tpu_torch.rl import apg as apg_lib
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.rl.policy import MLPPolicy, seeded
from nenbody_tpu_torch.state import spawn
from nenbody_tpu_torch.viz import frame as frame_lib
from nenbody_tpu_torch.viz import image


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--stride", type=int, default=6)
    ap.add_argument("--out", default="out/trained_policy.gif")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    env = VisionEnv(
        SimConfig(n=args.agents, controller="gravity", vision=VisionConfig(width=32)),
        max_accel=1.0,
        speed_penalty=0.05,  # teach braking, not just seeking
    )
    policy = seeded(0, lambda: MLPPolicy(env.obs_width, use_bf16=False))
    ts = apg_lib.init_apg_state(env, seed=0, lr=1e-2, policy=policy, device=args.device)
    untrained = copy.deepcopy(ts.policy)
    step = apg_lib.make_apg_step(env, horizon=32, num_envs=32)
    for i in range(args.iters):
        ts, m = step(ts)
        if i % 50 == 0:
            print(f"iter {i:4d}: reward {float(m['reward_mean']):.4f}", flush=True)

    @torch.no_grad()
    def advance(pol, state, k):
        for _ in range(k):
            action, _ = pol(env.observe(state))
            state = env.dynamics(state, action)
        return state

    def view(s):
        p, v = s.pos.cpu().numpy(), s.vel.cpu().numpy()
        return frame_lib.render_topdown(p, v, size=(270, 270), center=p.mean(0),
                                        half_extent=160.0)

    # roll both policies from the SAME spawn and render side by side
    s_raw = spawn(env.cfg, torch.Generator(device=args.device).manual_seed(7), args.device)
    s_tr = s_raw
    frames = []
    for _ in range(args.steps // args.stride):
        s_raw = advance(untrained, s_raw, args.stride)
        s_tr = advance(ts.policy, s_tr, args.stride)
        sep = np.ones((270, 4, 3), np.float32)
        frames.append(frame_lib.to_uint8(np.concatenate([view(s_raw), sep, view(s_tr)], axis=1)))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    image.write_gif(args.out, frames, duration_ms=40, loop=0)
    print(f"wrote {args.out}  (left: untrained, right: APG-trained cohesion)")

    def spread(s):
        p = s.pos.cpu().numpy()
        return float(((p - p.mean(0)) ** 2).sum(1).mean())

    print(f"final spread: untrained {spread(s_raw):.0f} vs trained {spread(s_tr):.0f}")


if __name__ == "__main__":
    main()
