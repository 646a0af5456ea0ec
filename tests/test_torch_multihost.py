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
component. The same runs on NCCL's layout, 4 processes x 1 CPU shard
(ONE_SHARD), once with the tags as written and once with every tag forced
to 0, so that gloo matches messages by their order as NCCL does. Then
init_distributed's device resolution (torchrun's LOCAL_RANK), without a
GPU. The trainers across processes: tests/test_torch_multihost_train.py.
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


def run_workers(script: str, tmp, nproc: int, *args: str, marker: str) -> list:
    """Start `nproc` processes of tests/`script` (pid, nproc, port, out,
    *args) on a free port; after each exited 0 with `marker` in its log,
    their outputs' paths."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    outs = [str(tmp / f"p{pid}.npz") for pid in range(nproc)]
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", script),
                               str(pid), str(nproc), str(port), outs[pid], *args],
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
        assert marker in log, log[-2000:]
    return outs


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    """Each process's .npz of local results, after both exited 0: 2
    processes x 2 CPU shards."""
    outs = run_workers("torch_multihost_worker.py", tmp_path_factory.mktemp("multihost"), 2,
                       marker="torch multihost ring OK")
    return [dict(np.load(o)) for o in outs]


# NCCL's layout, one card a process: 4 processes x 1 CPU shard, with the
# tags as the program writes them and with every tag forced to 0 (gloo
# then matches by order within a pair of ranks, as NCCL does)
ONE_SHARD = {"4x1": ("1",), "4x1 tags 0": ("1", "tags0")}


@pytest.fixture(scope="module", params=list(ONE_SHARD))
def blocks_one_shard(request, tmp_path_factory):
    """As `blocks`, on 4 processes x 1 CPU shard (ONE_SHARD)."""
    outs = run_workers("torch_multihost_worker.py", tmp_path_factory.mktemp("one_shard"), 4,
                       *ONE_SHARD[request.param], marker="torch multihost ring OK")
    return [dict(np.load(o)) for o in outs]


def _cfgs():
    kw = dict(width=worker.WIDTH, far=worker.FAR)
    return JSimConfig(n=worker.N, controller="boids", vision=JVisionConfig(**kw)), kw


def test_ring_physics_across_processes_matches_jax_dense(blocks):
    hold_ring_physics(blocks)


def hold_ring_physics(blocks):
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
    hold_eye_ring(blocks, sprite)


def hold_eye_ring(blocks, sprite):
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
    hold_autograd(blocks)


def hold_autograd(blocks):
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


def test_ring_physics_one_shard_a_process(blocks_one_shard):
    """NCCL's layout (ONE_SHARD): ring gravity (one env and a batch), boids
    and gspmd gravity against JAX dense; each process's blocks are its
    quarter of the agents."""
    hold_ring_physics(blocks_one_shard)
    assert [(int(b["lo"]), int(b["hi"])) for b in blocks_one_shard] == [
        (0, 16), (16, 32), (32, 48), (48, 64)]


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_eye_ring_one_shard_a_process(blocks_one_shard, sprite):
    """Both eye rings in NCCL's layout against JAX dense: the wireframe
    ring sends two blocks of one shape a hop, which come out swapped where
    a pair's messages are matched out of order."""
    hold_eye_ring(blocks_one_shard, sprite)


def test_autograd_one_shard_a_process(blocks_one_shard):
    """The gradients through the ring in NCCL's layout against one process
    on 4 shards (the backward exchange keeps the forward's order), and the
    uneven and plain inputs refused."""
    hold_autograd(blocks_one_shard)
    for b in blocks_one_shard:
        assert bool(b["refused_plain"]) and bool(b["refused_one_process"])


@pytest.mark.parametrize("backend", [None, "nccl"])
def test_nccl_takes_one_card_a_process(backend):
    """Two cards in one process under NCCL raise before the group forms."""
    with pytest.raises(ValueError, match="takes one card"):
        mesh_lib.init_distributed("127.0.0.1:1", num_processes=1, process_id=0,
                                  local_device_ids=[0, 1], backend=backend)
    assert not mesh_lib.is_distributed()


def _cards(monkeypatch, count: int, local_rank=None) -> None:
    """`count` visible cards, and torchrun's LOCAL_RANK (unset for None),
    without a GPU: init_distributed's device resolution only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", str(local_rank))


@pytest.mark.parametrize("backend", [None, "nccl"])
def test_local_rank_picks_the_card(monkeypatch, backend):
    """Under torchrun (LOCAL_RANK set) the default is that one card, and
    NCCL the default backend: `torchrun --nproc-per-node 4` and a bare
    init_distributed() on a 4-card node."""
    _cards(monkeypatch, 4, local_rank=2)
    assert mesh_lib._local_devices(None, backend) == ([torch.device("cuda", 2)], "nccl")
    # explicit devices win over LOCAL_RANK; a LOCAL_RANK without its card raises
    assert mesh_lib._local_devices([0, 0], "gloo") == ([torch.device("cuda", 0)] * 2, "gloo")
    _cards(monkeypatch, 2, local_rank=2)
    with pytest.raises(ValueError, match="LOCAL_RANK=2"):
        mesh_lib._local_devices()


def test_gloo_keeps_every_card_under_local_rank(monkeypatch):
    """LOCAL_RANK picks a card under NCCL only: gloo's default stays every
    visible card, as without torchrun."""
    _cards(monkeypatch, 4, local_rank=2)
    assert mesh_lib._local_devices(None, "gloo") == (
        [torch.device("cuda", i) for i in range(4)], "gloo")


@pytest.mark.parametrize("backend", [None, "nccl"])
def test_several_cards_without_local_rank_raise_under_nccl(monkeypatch, backend):
    """Every visible card in one process under NCCL still raises before the
    group forms, and the message names LOCAL_RANK."""
    _cards(monkeypatch, 4)
    with pytest.raises(ValueError, match="takes one card.*LOCAL_RANK"):
        mesh_lib._local_devices(None, backend)
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        mesh_lib.init_distributed("127.0.0.1:1", num_processes=1, process_id=0, backend=backend)
    assert not mesh_lib.is_distributed()


def test_one_card_and_gloo_resolve_as_before(monkeypatch):
    """Without LOCAL_RANK: one card is that card on NCCL; under gloo a
    process takes every visible card; CPU shards default to gloo."""
    _cards(monkeypatch, 1)
    assert mesh_lib._local_devices() == ([torch.device("cuda", 0)], "nccl")
    _cards(monkeypatch, 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert mesh_lib._local_devices(None, "gloo") == (cards, "gloo")
    assert mesh_lib._local_devices(["cpu", "cpu"]) == ([torch.device("cpu")] * 2, "gloo")
    _cards(monkeypatch, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib._local_devices()
