"""The port's mesh across processes (parallel.mesh.init_distributed,
global_state, host_local_state; the ring and gspmd backends on global
tensors), the twin of tests/test_multihost.py.

Two OS processes (tests/torch_multihost_worker.py), each with 2 CPU
shards, join over gloo at a free port into one 4-shard "agents" ring that
crosses the process boundary. Each runs ring gravity (one env and a batch),
ring boids, the disc and wireframe eye rings and gspmd gravity on the same
numpy inputs, and writes its local blocks; here they are held against the
JAX package's dense functions on those inputs. Tolerances: the JAX
worker's, gravity and boids rtol 3e-5 / atol 1e-6, the disc eye atol
3e-5; the wireframe eye test_torch_ring_train.py's shade atol 2e-4; the
gradients through the ring across the boundary against one process's
test_torch_ring_train.py's, rtol 1e-4 / atol 1e-4 of the largest
component. The trainers across processes:
tests/test_torch_multihost_train.py.
"""

import os
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu.physics import dense as jdense
from nenbody_tpu.vision import render as jrender

from nenbody_tpu_torch.parallel import make_mesh
from nenbody_tpu_torch.parallel import mesh as mesh_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_multihost_worker as worker  # noqa: E402

PHYSICS_TOL = dict(rtol=3e-5, atol=1e-6)
EYE_TOL = {"disc": dict(rtol=3e-5, atol=3e-5), "wireframe": dict(rtol=1e-5, atol=2e-4)}
DEADLINE_S = 240  # the whole test: both processes, start to exit


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    """Each process's .npz of local results, after both exited 0."""
    tmp = tmp_path_factory.mktemp("multihost")
    port, nproc = _free_port(), 2
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    outs = [str(tmp / f"p{pid}.npz") for pid in range(nproc)]
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests",
                                                            "torch_multihost_worker.py"),
                               str(pid), str(nproc), str(port), outs[pid]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=ROOT, env=env)
             for pid in range(nproc)]
    deadline = time.monotonic() + DEADLINE_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {pid} failed:\n{log[-3000:]}"
        assert "torch multihost ring OK" in log, log[-2000:]
    return [dict(np.load(o)) for o in outs]


def _cfgs():
    kw = dict(width=worker.WIDTH, far=worker.FAR)
    return JSimConfig(n=worker.N, controller="boids", vision=JVisionConfig(**kw)), kw


def test_ring_physics_across_processes_matches_jax_dense(blocks):
    jcfg, _ = _cfgs()
    pos, vel, pos_b = (jnp.asarray(x) for x in worker.inputs())
    want = {"gravity": np.asarray(jdense.gravity_forces(pos, jcfg.gravity)),
            "gspmd_gravity": np.asarray(jdense.gravity_forces(pos, jcfg.gravity)),
            "boids": np.asarray(jdense.boids_accels(pos, vel, jcfg.boids)),
            "gravity_batch": np.asarray(jdense.gravity_forces(pos_b, jcfg.gravity))}
    for b in blocks:
        lo, hi = int(b["lo"]), int(b["hi"])
        for name, w in want.items():
            np.testing.assert_allclose(b[name], w[..., lo:hi, :], err_msg=name, **PHYSICS_TOL)
    assert np.abs(want["boids"]).max() > 0


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_eye_ring_across_processes_matches_jax_dense(blocks, sprite):
    _, kw = _cfgs()
    pos, vel, _ = (jnp.asarray(x) for x in worker.inputs())
    shade, depth = (np.asarray(x) for x in jrender.render_rows(
        pos, vel, JVisionConfig(sprite_mode=sprite, **kw)))
    for b in blocks:
        lo, hi = int(b["lo"]), int(b["hi"])
        np.testing.assert_allclose(b[f"{sprite}_depth"], depth[lo:hi], **EYE_TOL[sprite])
        np.testing.assert_allclose(b[f"{sprite}_shade"], shade[lo:hi], **EYE_TOL[sprite])
    assert (depth < worker.FAR).mean() > 0.02  # sprites are seen


def test_blocks_cover_the_agents(blocks):
    """The two processes' blocks are the two halves of the agent axis (the
    round trip through global_state and host_local_state is checked bit for
    bit in each worker)."""
    assert [(int(b["lo"]), int(b["hi"])) for b in blocks] == [(0, 32), (32, 64)]


def test_autograd_and_uneven_blocks_are_refused(blocks):
    """Autograd crosses the boundary: each process's gradients of ring
    gravity and of the differentiable disc eye ring (positions and
    velocities) equal one process's on 4 shards; and each process refused
    blocks of 31 and 32 agents (N=63 does not divide over the processes)."""
    for b in blocks:
        assert bool(b["refused_uneven"])
        for name in ("grad_gravity", "grad_eye_pos", "grad_eye_vel"):
            got, want = b[f"{name}_dist"], b[f"{name}_one"]
            assert np.abs(want).max() > 0, name
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                       err_msg=name)


def test_a_one_process_mesh_makes_no_global_tensor():
    mesh = make_mesh({"agents": 4}, devices=["cpu"] * 4)
    assert mesh.ranks is None and not mesh.distributed and not mesh_lib.is_distributed()
    with pytest.raises(ValueError, match="spans processes"):
        mesh_lib.lift(torch.zeros(8, 2), mesh, ("agents", None))


def test_plain_tensors_and_one_process_paths_are_refused(blocks):
    """On the mesh across processes each process refused plain tensors
    (the ring's gravity, boids and differentiable eye, gspmd gravity, and
    Scene's ring backend on plain states over its default mesh), and
    datagen and BC (make_collect_fn, distill, fit_streaming): they run on
    one process, their chunks reaching the host whole."""
    for b in blocks:
        assert bool(b["refused_plain"]) and bool(b["refused_one_process"])


@pytest.mark.parametrize("backend", [None, "nccl"])
def test_nccl_takes_one_card_a_process(backend):
    """Two cards in one process under NCCL raise before the group forms."""
    with pytest.raises(ValueError, match="takes one card"):
        mesh_lib.init_distributed("127.0.0.1:1", num_processes=1, process_id=0,
                                  local_device_ids=[0, 1], backend=backend)
    assert not mesh_lib.is_distributed()
