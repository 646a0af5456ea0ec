"""Worker for tests/test_torch_multihost.py: one process of a 2-process CPU
mesh of the port (the twin of tests/multihost_worker.py).

Run as:  python tests/torch_multihost_worker.py <process_id> <num_processes> <port> <out.npz>

Each process owns 2 CPU shards; joined through
parallel.mesh.init_distributed on gloo, they form a 4-shard "agents" ring
that crosses the process boundary. Both processes build the SAME inputs
from one numpy seed, lift their local agent block to global tensors
(parallel.mesh.global_state), run ring gravity (one env and a batch of 2),
ring boids, the disc and wireframe eye rings and gspmd gravity across the
boundary, and write their local blocks of the results to <out.npz>, which
the test holds against the JAX package's dense functions, with whether a
distributed input that requires grad, blocks of 31 and 32 agents, plain
tensors on the mesh across processes, and Scene and a trainer on it were
refused. Exit code 0 = every step ran and the round trip
host_local_state(global_state(x)) gave x bit for bit.
"""

import sys

import numpy as np
import torch

torch.set_num_threads(1)

from nenbody_tpu_torch import Scene, SceneState, SimConfig, VisionConfig
from nenbody_tpu_torch.parallel import auto, ring
from nenbody_tpu_torch.parallel import mesh as mesh_lib
from nenbody_tpu_torch.rl import train
from nenbody_tpu_torch.rl.env import VisionEnv

N, WIDTH, FAR, SEED = 64, 32, 200.0, 0


def inputs(n=N, seed=SEED):
    """pos, vel [n, 2] and a batch of 2 envs' positions [2, n, 2] (float32)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-20, 20, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    pos_b = rng.uniform(-20, 20, (2, n, 2)).astype(np.float32)
    return pos, vel, pos_b


def main() -> None:
    pid, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    mesh_lib.init_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid,
                              local_device_ids=["cpu", "cpu"])
    assert mesh_lib.is_distributed()
    mesh = mesh_lib.make_mesh({"agents": 2 * nproc})
    assert mesh.ranks == [r for r in range(nproc) for _ in range(2)], mesh

    cfg = SimConfig(n=N, controller="boids", backend="ring",
                    vision=VisionConfig(width=WIDTH, far=FAR))
    pos, vel, pos_b = inputs()
    lo, hi = pid * N // nproc, (pid + 1) * N // nproc
    local = SceneState(pos=torch.from_numpy(pos[lo:hi]), vel=torch.from_numpy(vel[lo:hi]),
                       t=torch.zeros((), dtype=torch.int32))
    gstate = mesh_lib.global_state(local, mesh)
    assert tuple(gstate.pos.shape) == (N, 2) and gstate.pos.local.shape == (hi - lo, 2)

    results = {"lo": lo, "hi": hi}
    with torch.no_grad():
        results["gravity"] = ring.ring_gravity_forces(gstate.pos, cfg, mesh=mesh).local
        results["boids"] = ring.ring_boids_velocity(gstate.pos, gstate.vel, cfg, mesh=mesh).local
        for sprite in ("disc", "wireframe"):
            vcfg = VisionConfig(width=WIDTH, far=FAR, sprite_mode=sprite)
            shade, depth = ring.ring_render_rows(gstate.pos, gstate.vel, vcfg, mesh=mesh)
            results[f"{sprite}_shade"], results[f"{sprite}_depth"] = shade.local, depth.local
        results["gspmd_gravity"] = auto.auto_gravity_forces(gstate.pos, cfg, mesh=mesh).local
        # a batch of envs kept whole on every shard (spec (None, agents, None))
        batch = mesh_lib.lift(torch.from_numpy(pos_b[:, lo:hi]), mesh, (None, "agents", None))
        results["gravity_batch"] = ring.ring_gravity_forces(batch, cfg, mesh=mesh).local

    back = mesh_lib.host_local_state(gstate, mesh)
    for name in ("pos", "vel", "t"):
        assert torch.equal(getattr(back, name), getattr(local, name)), name

    # refusals: autograd across the boundary, and N that does not divide
    try:
        ring.ring_gravity_forces(gstate.pos.with_local(local.pos.clone().requires_grad_()), cfg,
                                 mesh=mesh)
        results["refused_grad"] = False
    except NotImplementedError:
        results["refused_grad"] = True
    pos63 = inputs(n=63)[0]
    lo63, hi63 = pid * 63 // nproc, (pid + 1) * 63 // nproc
    try:
        mesh_lib.lift(torch.from_numpy(pos63[lo63:hi63]), mesh, ("agents", None))
        results["refused_uneven"] = False
    except ValueError as e:
        results["refused_uneven"] = "divide evenly" in str(e)

    # a mesh across processes takes GlobalTensors only: a plain tensor, with
    # or without grad, would be cut into this process's shards whole
    def refused(fn, match):
        try:
            fn()
        except ValueError as e:
            return match in str(e)
        return False

    whole = torch.from_numpy(pos)
    results["refused_plain"] = all([
        refused(lambda: ring.ring_gravity_forces(whole, cfg, mesh=mesh), "GlobalTensors"),
        refused(lambda: ring.ring_boids_velocity(whole, torch.from_numpy(vel), cfg, mesh=mesh),
                "GlobalTensors"),
        refused(lambda: ring.ring_render_rows_diff(whole.clone().requires_grad_(),
                                                   torch.from_numpy(vel), cfg.vision, mesh=mesh),
                "GlobalTensors"),
        refused(lambda: auto.auto_gravity_forces(whole, cfg, mesh=mesh), "GlobalTensors"),
    ])
    # Scene (the default mesh spans the processes now) and the trainers run
    # on one process
    gcfg = SimConfig(n=N, controller="gravity", backend="ring",
                     vision=VisionConfig(width=WIDTH, far=FAR))
    scene = Scene(gcfg, device="cpu")
    env = VisionEnv(gcfg)
    results["refused_one_process"] = all([
        refused(lambda: scene.step(scene.spawn(0)), "runs on one process"),
        refused(lambda: scene.observe(scene.spawn(0)), "runs on one process"),
        refused(lambda: train.init_train_state(env, 2, device="cpu", mesh=mesh),
                "runs on one process"),
        refused(lambda: train.make_train_step(env, mesh=mesh), "runs on one process"),
    ])

    np.savez(out, **{k: np.asarray(v) for k, v in results.items()})
    torch.distributed.destroy_process_group()
    print(f"[p{pid}] torch multihost ring OK over {len(mesh.devices)} shards / {nproc} "
          f"processes", flush=True)


if __name__ == "__main__":
    main()
