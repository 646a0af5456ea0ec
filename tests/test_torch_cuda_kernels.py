"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test asks the `cuda` fixture for the device, which skips
the test when no GPU is present (the CPU suite collects and skips them).
Run them on a machine with a GPU (no jax needed there, hence --noconftest):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances are the JAX suite's between its Pallas kernels and its dense
oracle (tests/test_kernels.py), with the reason beside each.
"""

import dataclasses

import pytest
import torch

from nenbody_tpu_torch import Scene, SimConfig, VisionConfig
from nenbody_tpu_torch.config import BoidsConfig, GravityConfig
from nenbody_tpu_torch.ops import boids as boids_ops
from nenbody_tpu_torch.ops import common, pairwise, raycast
from nenbody_tpu_torch.physics import dense
from nenbody_tpu_torch.vision import camera

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _uniform(shape, lo, hi, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def _close(got, want, rtol, atol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [1, 16, 257, 1000])
def test_gravity_kernel_matches_plain(cuda, n):
    # per-pair weights differ by one rounding (1/d2 then a product, against
    # one divide) and the sums run in another order: test_kernels.py:28
    pos = _uniform((n, 2), -100, 100, n, cuda)
    cfg = GravityConfig()
    _close(pairwise.gravity_forces_tiled(pos, cfg), pairwise.gravity_forces_plain(pos, cfg),
           3e-5, 1e-7)


def test_gravity_kernel_batched_cross(cuda):
    pos = _uniform((4, 300, 2), -100, 100, 1, cuda)
    pos_j = _uniform((4, 513, 2), -100, 100, 2, cuda)
    cfg = GravityConfig()
    _close(pairwise.gravity_forces_tiled(pos, cfg, pos_j),
           pairwise.gravity_forces_plain(pos, cfg, pos_j), 3e-5, 1e-7)


def test_gravity_kernel_approx_mode(cuda):
    # the approximate reciprocal's bound (test_kernels.py:31)
    pos = _uniform((300, 2), -100, 100, 6, cuda)
    want = pairwise.gravity_forces_plain(pos, GravityConfig())
    got = pairwise.gravity_forces_tiled(pos, GravityConfig(approx_reciprocal=True))
    torch.cuda.synchronize()
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-2


@pytest.mark.parametrize("n,lo", [(16, -100), (300, -100), (4096, -100), (128, -8)])
def test_boids_kernel_matches_plain(cuda, n, lo):
    # sums in another order; counts are exact (test_kernels.py:60)
    pos = _uniform((n, 2), lo, -lo, n, cuda)
    vel = _uniform((n, 2), -1, 1, n + 1, cuda)
    cfg = BoidsConfig()
    _close(boids_ops.boids_velocity_tiled(pos, vel, cfg),
           boids_ops.boids_velocity_plain(pos, vel, cfg), 3e-5, 1e-6)


def test_boids_kernel_batched_and_global_alignment(cuda):
    pos = _uniform((3, 333, 2), -20, 20, 3, cuda)
    vel = _uniform((3, 333, 2), -1, 1, 4, cuda)
    cfg = BoidsConfig()
    _close(boids_ops.boids_velocity_tiled(pos, vel, cfg),
           boids_ops.boids_velocity_plain(pos, vel, cfg), 3e-5, 1e-6)
    # |v| < alignment_dist/2, so the global mean equals the masked fold
    _close(boids_ops.boids_velocity_tiled(pos, vel, BoidsConfig(global_alignment=True)),
           dense.boids_accels(pos, vel, cfg), 3e-5, 1e-6)


@pytest.mark.parametrize("b,n,w", [
    (1, 24, 64), (1, 100, 128), (1, 60, 32), (1, 20, 512), (1, 100, 1024),
    (1, 77, 100), (3, 72, 512), (5, 33, 17),
])
@pytest.mark.parametrize("aa", [False, True])
def test_disc_eye_kernel_matches_plain(cuda, b, n, w, aa):
    # the kernel follows the plain arithmetic op for op (built with
    # -fmad=false); tolerances of test_kernels.py:209-210
    shape = (b, n, 2) if b > 1 else (n, 2)
    pos = _uniform(shape, -100, 100, n, cuda)
    dirs = camera.unit_heading(_uniform(shape, -1, 1, n + 1, cuda))
    cfg = VisionConfig(width=w, antialias=aa)
    gs, gd = raycast.disc_eye(pos, dirs, pos, cfg)
    ws, wd = raycast.disc_eye_plain(pos, dirs, pos, cfg)
    _close(gd, wd, 1e-5, 1e-4)
    _close(gs, ws, 1e-5, 1e-5)


def test_launch_counts_and_grad_guard(cuda):
    common.reset_launch_counts()
    cfg = SimConfig(n=64, controller="gravity", vision=VisionConfig(width=32))
    scene = Scene(cfg, device=cuda)
    scene.observe(scene.step(scene.spawn(0)))
    counts = common.launch_counts()
    assert counts["gravity"] == 1 and counts["disc_eye"] == 1
    pos = _uniform((64, 2), -100, 100, 0, cuda).requires_grad_()
    with pytest.raises(NotImplementedError):
        pairwise.gravity_forces_tiled(pos, GravityConfig())


@pytest.mark.parametrize("controller", ["gravity", "boids"])
def test_scene_rollout_matches_dense_cpu(cuda, controller):
    cfg = SimConfig(n=96, controller=controller, vision=VisionConfig(width=48))
    ref = Scene(dataclasses.replace(cfg, backend="dense"))
    s0 = ref.spawn_envs(2, seed=3)
    _, want = ref.rollout(s0, 4, record=("pos", "obs"))
    ker = Scene(cfg, device=cuda)
    s0c = dataclasses.replace(s0, pos=s0.pos.to(cuda), vel=s0.vel.to(cuda), t=s0.t.to(cuda))
    _, got = ker.rollout(s0c, 4, record=("pos", "obs"))
    torch.cuda.synchronize()
    torch.testing.assert_close(got["pos"].cpu(), want["pos"], rtol=1e-5, atol=1e-4)
    # last-bit position differences may flip an eye-edge pixel
    flips = ((got["obs"].cpu() - want["obs"]).abs() > 1e-3).double().mean().item()
    assert flips < 1e-3
