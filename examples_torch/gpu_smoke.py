"""Quick kernel smoke + timing on the card (the port's twin of
examples/tpu_smoke.py, a dev utility): gravity, boids and the disc eye
held against their plain PyTorch versions at N=512, then chained-call
throughput (utils.profiling.scan_throughput, CUDA events on the card).
chip_smoke.py is the full check of every kernel and path.

    python examples_torch/gpu_smoke.py [--n 65536] [--device cuda]
"""

import argparse
import sys

sys.path.insert(0, ".")

import torch

from nenbody_tpu_torch import SimConfig, VisionConfig, spawn
from nenbody_tpu_torch.config import BoidsConfig, GravityConfig
from nenbody_tpu_torch.ops import boids as boids_ops
from nenbody_tpu_torch.ops import common, pairwise, raycast
from nenbody_tpu_torch.physics import dense
from nenbody_tpu_torch.utils.profiling import scan_throughput
from nenbody_tpu_torch.vision import render


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    launch = common.use_kernel(torch.zeros(1, device=device))
    print(f"device: {device} ({name}); the kernels launch: {launch}")

    # -- correctness at small N against the plain versions -------------------
    with torch.no_grad():
        st = spawn(SimConfig(n=512, controller="gravity"),
                   torch.Generator(device=device).manual_seed(0), device)
        err = float((pairwise.gravity_forces_tiled(st.pos, GravityConfig())
                     - dense.gravity_forces(st.pos, GravityConfig())).abs().max())
        print(f"gravity kernel max err vs plain @512: {err:.3e}")
        errb = float((boids_ops.boids_velocity_tiled(st.pos, st.vel, BoidsConfig())
                      - dense.boids_accels(st.pos, st.vel, BoidsConfig())).abs().max())
        print(f"boids kernel max err vs plain @512: {errb:.3e}")
        vcfg = VisionConfig(width=128)
        gs, _ = raycast.render_rows_tiled(st.pos, st.vel, vcfg)
        ws, _ = render.render_rows(st.pos, st.vel, vcfg)
        print(f"disc eye shade max err @512: {float((gs - ws).abs().max()):.3e}")

        # -- throughput of chained calls ---------------------------------------
        n = args.n
        g = torch.Generator(device=device).manual_seed(1)
        pos = torch.rand((n, 2), generator=g, device=device) * 200 - 100
        vel = torch.rand((n, 2), generator=g, device=device)

        gcfg, bcfg = GravityConfig(), BoidsConfig()
        dt = scan_throughput(
            lambda c: (c[0] + c[1], c[1] + 0.1 * pairwise.gravity_forces_tiled(c[0], gcfg)),
            (pos, vel), 10)
        print(f"gravity N={n}: {dt*1e3:.2f} ms/step -> {n*n/dt:.3e} pair-evals/s")
        dt = scan_throughput(
            lambda c: (c[0] + 0.04 * c[1], boids_ops.boids_velocity_tiled(c[0], c[1], bcfg)),
            (pos, vel), 10)
        print(f"boids   N={n}: {dt*1e3:.2f} ms/step -> {n*n/dt:.3e} pair-evals/s")
        for nn, w in [(min(1024, n), 64), (min(4096, n), 256)]:
            p, v = pos[:nn], vel[:nn]
            cfg = VisionConfig(width=w)
            dt = scan_throughput(
                lambda q: q + 1e-7 * raycast.render_rows_tiled(q, v, cfg)[0][:, :2], p, 10)
            print(f"vision N={nn} W={w}: {dt*1e3:.3f} ms -> {nn/dt:.3e} agent-frames/s")


if __name__ == "__main__":
    main()
