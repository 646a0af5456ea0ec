"""Multi-device walkthrough (the port's twin of examples/multichip_demo.py):
the agent-axis ring and DP x ring training, on meshes that repeat one
device (8 shards of one card, or of the CPU with --device cpu), as the
port's tests do; on a host with several cards, make_mesh() with no devices
takes every visible card.

    python examples_torch/multichip_demo.py [--device cuda]
"""

import argparse
import sys

sys.path.insert(0, ".")

import torch

from nenbody_tpu_torch import SimConfig, VisionConfig, spawn
from nenbody_tpu_torch.parallel import mesh as mesh_lib, ring
from nenbody_tpu_torch.physics import dense
from nenbody_tpu_torch.rl import train as train_lib
from nenbody_tpu_torch.rl.env import VisionEnv


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    print(f"mesh devices: 8 x {device}")

    # -- 1. agent-axis ring: N agents sharded over 8 shards ------------------
    mesh = mesh_lib.make_mesh({"agents": 8}, devices=[device] * 8)
    cfg = SimConfig(n=args.n, controller="gravity", backend="ring")
    st = spawn(cfg, torch.Generator(device=device).manual_seed(0), device)
    with torch.no_grad():
        g_ring = ring.ring_gravity_forces(st.pos, cfg, mesh=mesh)
        g_dense = dense.gravity_forces(st.pos, cfg.gravity)
        err = float((g_ring - g_dense).abs().max())
        print(f"ring gravity over 8 shards: max |err| vs dense = {err:.2e}")
        shade, depth = ring.ring_render_rows(st.pos, st.vel, VisionConfig(width=32), mesh=mesh)
    print(f"ring vision: obs {tuple(shade.shape)} on {shade.device}")

    # -- 2. DP x ring: envs over 'data', agents over 'agents' ----------------
    mesh2 = mesh_lib.make_mesh({"data": 2, "agents": 4}, devices=[device] * 8)
    env = VisionEnv(SimConfig(n=64, controller="gravity", vision=VisionConfig(width=16)))
    ts = train_lib.init_train_state(env, num_envs=4, seed=0, lr=1e-3, device=device,
                                    mesh=mesh2)
    step = train_lib.make_train_step(env, horizon=2, mesh=mesh2)
    ts, metrics = step(ts)
    print(f"train step on (data=2, agents=4): loss={float(metrics['loss']):.4f} "
          f"reward={float(metrics['reward_mean']):.4f}")
    print(f"env states: {tuple(ts.env_states.pos.shape)} on {ts.env_states.pos.device}")


if __name__ == "__main__":
    main()
