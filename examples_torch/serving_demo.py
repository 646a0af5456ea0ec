"""Serving artifacts end to end (the port's twin of examples/serving_demo.py):
train, export with torch.export, then deploy-and-drive the `.pt2` program
as a black box.

train (REINFORCE, tiny) --export--> .pt2 program (weights inside)
    --load--> step fleet rollouts with NO checkpoint / net / env config:
the serving site needs torch, this package (`import nenbody_tpu_torch`
registers the kernels' custom ops the program calls) and the file.

    python examples_torch/serving_demo.py [--device cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, ".")

import torch

from nenbody_tpu_torch import SimConfig, VisionConfig
from nenbody_tpu_torch.rl import train as train_lib
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.state import spawn_batch
from nenbody_tpu_torch.utils import export as export_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="out/nenbody_policy_step.pt2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    env = VisionEnv(SimConfig(n=64, controller="gravity", vision=VisionConfig(width=32)))
    ts = train_lib.init_train_state(env, num_envs=16, seed=0, lr=1e-3, device=device)
    step = train_lib.make_train_step(env, horizon=8)
    for _ in range(10):
        ts, metrics = step(ts)
    print(f"trained 10 iters, reward_mean={float(metrics['reward_mean']):.4f}")

    # one artifact per serving shape: a 32-env fleet, 8 sim steps per call
    blob = export_lib.export_policy_step(env, ts.policy, num_envs=32, steps=8)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"exported {len(blob)} bytes -> {args.out}")

    # ---- the serving site: only the file crosses this line ----
    serve = export_lib.load_policy_step(args.out)
    st = spawn_batch(env.cfg, torch.Generator(device=device).manual_seed(7), 32, device)
    pos, vel = st.pos, st.vel
    for _ in range(4):
        pos, vel, action = serve(pos, vel)  # 8 baked steps per call
    spread = float(((pos - pos.mean(1, keepdim=True)) ** 2).sum(-1).mean())
    print(f"served 32 envs x 32 steps in 4 calls; final spread {spread:.2f}")


if __name__ == "__main__":
    main()
