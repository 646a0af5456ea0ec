"""Worker for tests/test_torch_multihost.py: one process of a 2-process CPU
mesh of the port (the twin of tests/multihost_worker.py).

Run as:  python tests/torch_multihost_worker.py <process_id> <num_processes> <port> <out.npz>
             [<shards a process> [tags0]]

Each process owns 2 CPU shards (or <shards a process>: 1 is the layout
NCCL runs, one card a process); joined through
parallel.mesh.init_distributed on gloo, they form an "agents" ring that
crosses the process boundary. With `tags0` every point-to-point tag is
forced to 0 (set_p2p_tags_to_zero), so gloo matches messages by their
order within each pair of ranks, as NCCL does. Both processes build the SAME inputs
from one numpy seed, lift their local agent block to global tensors
(parallel.mesh.global_state), run ring gravity (one env and a batch of 2),
ring boids, the disc and wireframe eye rings and gspmd gravity across the
boundary, and write their local blocks of the results to <out.npz>, which
the test holds against the JAX package's dense functions. It also writes
the gradients of ring gravity and of the differentiable disc eye ring
across the boundary beside one process's on a 4-shard CPU mesh, and
whether blocks of 31 and 32 agents, plain tensors on the mesh across
processes (the ring, gspmd, and Scene's plain states) and datagen and BC on
it were refused. Exit code 0 = every step ran and the round trip
host_local_state(global_state(x)) gave x bit for bit.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from nenbody_tpu_torch import Scene, SceneState, SimConfig, VisionConfig
from nenbody_tpu_torch.parallel import auto, ring
from nenbody_tpu_torch.parallel import mesh as mesh_lib
from nenbody_tpu_torch.rl import bc, datagen
from nenbody_tpu_torch.rl.env import VisionEnv

N, WIDTH, FAR, SEED = 64, 32, 200.0, 0


def set_p2p_tags_to_zero() -> None:
    """Every dist.P2POp this process builds gets tag 0: gloo then matches a
    pair's messages by their order, as NCCL does (it drops the tag), so
    blocks sent in another order than they are received come out swapped."""
    p2p_op = dist.P2POp

    def untagged(op, tensor, peer=None, group=None, tag=0, **kw):
        return p2p_op(op, tensor, peer, group, 0, **kw)

    dist.P2POp = untagged


def inputs(n=N, seed=SEED):
    """pos, vel [n, 2] and a batch of 2 envs' positions [2, n, 2] (float32)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-20, 20, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    pos_b = rng.uniform(-20, 20, (2, n, 2)).astype(np.float32)
    return pos, vel, pos_b


def main() -> None:
    pid, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    shards = int(sys.argv[5]) if len(sys.argv) > 5 else 2
    if sys.argv[6:] == ["tags0"]:
        set_p2p_tags_to_zero()
    mesh_lib.init_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid,
                              local_device_ids=["cpu"] * shards)
    assert mesh_lib.is_distributed()
    mesh = mesh_lib.make_mesh({"agents": shards * nproc})
    assert mesh.ranks == [r for r in range(nproc) for _ in range(shards)], mesh

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

    # gradients across the boundary: of sum(w * forces) and of sum(w * shade)
    # (the antialiased disc eye), against one process on as many CPU shards
    one = mesh_lib.make_mesh({"agents": shards * nproc}, devices=["cpu"] * (shards * nproc))
    aa = VisionConfig(width=WIDTH, far=FAR, antialias=True)
    w_g = torch.from_numpy(np.random.RandomState(7).randn(N, 2).astype(np.float32))
    w_s = torch.from_numpy(np.random.RandomState(8).randn(N, WIDTH).astype(np.float32))
    for label, grads in (("dist", None), ("one", None)):
        p = torch.from_numpy(pos if label == "one" else pos[lo:hi]).requires_grad_()
        v = torch.from_numpy(vel if label == "one" else vel[lo:hi]).requires_grad_()
        m = one if label == "one" else mesh
        lift = (lambda x: x) if label == "one" else (
            lambda x: mesh_lib.GlobalTensor(x, mesh, ("agents", None), torch.Size((N, 2))))
        local = (lambda x: x) if label == "one" else (lambda x: x.local)
        rows = slice(None) if label == "one" else slice(lo, hi)
        g = local(ring.ring_gravity_forces(lift(p), cfg, mesh=m))
        (g * w_g[rows]).sum().backward()
        results[f"grad_gravity_{label}"] = p.grad[lo:hi] if label == "one" else p.grad
        p.grad = None
        shade = local(ring.ring_render_rows_diff(lift(p), lift(v), aa, mesh=m)[0])
        (shade * w_s[rows]).sum().backward()
        for name, x in (("pos", p), ("vel", v)):
            results[f"grad_eye_{name}_{label}"] = x.grad[lo:hi] if label == "one" else x.grad

    # refusals: N that does not divide
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
    # Scene's plain states: the default mesh spans the processes now
    gcfg = SimConfig(n=N, controller="gravity", backend="ring",
                     vision=VisionConfig(width=WIDTH, far=FAR))
    scene = Scene(gcfg, device="cpu")
    results["refused_plain"] = all([
        refused(lambda: ring.ring_gravity_forces(whole, cfg, mesh=mesh), "GlobalTensors"),
        refused(lambda: ring.ring_boids_velocity(whole, torch.from_numpy(vel), cfg, mesh=mesh),
                "GlobalTensors"),
        refused(lambda: ring.ring_render_rows_diff(whole.clone().requires_grad_(),
                                                   torch.from_numpy(vel), cfg.vision, mesh=mesh),
                "GlobalTensors"),
        refused(lambda: auto.auto_gravity_forces(whole, cfg, mesh=mesh), "GlobalTensors"),
        refused(lambda: scene.step(scene.spawn(0)), "runs on one process"),
        refused(lambda: scene.observe(scene.spawn(0)), "runs on one process"),
    ])
    # datagen and BC run on one process: their chunks reach the host whole
    env = VisionEnv(gcfg)
    results["refused_one_process"] = all([
        refused(lambda: datagen.make_collect_fn(env, mesh=mesh), "runs on one process"),
        refused(lambda: bc.distill(env, lambda obs: obs[..., -2:], num_envs=2, device="cpu",
                                   mesh=mesh), "runs on one process"),
        refused(lambda: bc.fit_streaming(env, num_envs=2, device="cpu", mesh=mesh),
                "runs on one process"),
    ])

    np.savez(out, **{k: np.asarray(v) for k, v in results.items()})
    torch.distributed.destroy_process_group()
    print(f"[p{pid}] torch multihost ring OK over {len(mesh.devices)} shards / {nproc} "
          f"processes", flush=True)


if __name__ == "__main__":
    main()
