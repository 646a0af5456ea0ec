"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test asks the `cuda` fixture for the device, which skips
the test when no GPU is present (the CPU suite collects and skips them).
Run them on a machine with a GPU (no jax needed there, hence --noconftest):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances are the JAX suite's between its Pallas kernels and its dense
oracle (tests/test_kernels.py, tests/test_diff_vision.py), with the reason
beside each.
"""

import dataclasses

import pytest
import torch

from nenbody_tpu_torch import Scene, SimConfig, VisionConfig
from nenbody_tpu_torch.config import BoidsConfig, GravityConfig
from nenbody_tpu_torch.ops import boids as boids_ops
from nenbody_tpu_torch.ops import common, pairwise, raycast, wireframe
from nenbody_tpu_torch.physics import dense
from nenbody_tpu_torch.vision import camera, render

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
    """Without grad the forward-only launches run; a tensor that requires
    grad goes through the autograd Functions, whose backward launches the
    backward kernels once each."""
    common.reset_launch_counts()
    cfg = SimConfig(n=64, controller="gravity", vision=VisionConfig(width=32))
    scene = Scene(cfg, device=cuda)
    scene.observe(scene.step(scene.spawn(0)))
    counts = common.launch_counts()
    assert counts["gravity"] == 1 and counts["disc_eye"] == 1
    assert counts["gravity_vjp"] == 0 and counts["disc_eye_bwd"] == 0
    pos = _uniform((64, 2), -100, 100, 0, cuda).requires_grad_()
    vel = _uniform((64, 2), -1, 1, 1, cuda).requires_grad_()
    g = pairwise.gravity_forces_tiled(pos, GravityConfig())
    shade, _ = raycast.render_rows_tiled(pos, vel, VisionConfig(width=32, antialias=True))
    assert common.launch_counts()["gravity"] == 2 and common.launch_counts()["disc_eye"] == 2
    ((g * g).sum() + shade.sum()).backward()
    torch.cuda.synchronize()
    counts = common.launch_counts()
    assert counts["gravity_vjp"] == 1 and counts["disc_eye_bwd"] == 1
    assert torch.isfinite(pos.grad).all() and torch.isfinite(vel.grad).all()
    with pytest.raises(NotImplementedError):
        pairwise.gravity_forces_tiled(pos, GravityConfig(), pos.detach())
    with pytest.raises(ValueError, match="winner"):
        raycast.render_rows_vjp_cross(pos.detach(), vel.detach(), None, shade.detach(),
                                      shade.detach(), VisionConfig(width=32))


def _scaled_close(got, want, tol):
    """|got - want| / max|want| < tol (the pair sums cancel)."""
    torch.cuda.synchronize()
    scale = want.abs().max()
    assert scale > 0
    assert ((got - want).abs().max() / scale).item() < tol


@pytest.mark.parametrize("shape", [(1, 2), (16, 2), (257, 2), (1000, 2), (3, 300, 2), (2, 77, 2),
                                   (4096, 256, 2)])  # the last: the trainers' (config 5)
def test_gravity_vjp_kernel_matches_plain(cuda, shape):
    # the closed form in another summation order: test_kernels.py:141-155's
    # normalized bound
    pos = _uniform(shape, -100, 100, shape[-2], cuda)
    u = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    cfg = GravityConfig()
    got = pairwise.gravity_vjp_tiled(pos, u, cfg)
    want = pairwise.gravity_vjp_plain(pos, u, cfg)
    if shape[-2] == 1:  # the self-pair alone: exactly 0
        assert torch.equal(got, torch.zeros_like(got))
    else:
        _scaled_close(got, want, 3e-5)
    # the backward is exact whatever the forward's approx_reciprocal
    torch.testing.assert_close(
        pairwise.gravity_vjp_tiled(pos, u, GravityConfig(approx_reciprocal=True)), got,
        rtol=0, atol=0)


@pytest.mark.parametrize("b,n,w", [(1, 1024, 64), (1, 100, 1024), (1, 60, 32), (64, 256, 64),
                                   (5, 33, 17), (4096, 256, 64)])  # the last: the trainers'
@pytest.mark.parametrize("aa", [False, True])
def test_disc_eye_bwd_kernel_matches_plain(cuda, b, n, w, aa):
    # test_diff_vision.py:31-57's tolerances: per-pixel terms round apart
    # and the target sums run in atomic (run-to-run) order
    shape = (b, n, 2) if b > 1 else (n, 2)
    pos = _uniform(shape, -100, 100, n, cuda)
    dirs = camera.unit_heading(_uniform(shape, -1, 1, n + 1, cuda))
    cfg = VisionConfig(width=w, antialias=aa)
    gen = torch.Generator(device=cuda).manual_seed(2)
    us = torch.randn(shape[:-1] + (w,), generator=gen, device=cuda)
    ud = torch.randn(shape[:-1] + (w,), generator=gen, device=cuda) * 1e-3
    shade, depth, winner = raycast.disc_eye_with_winner(pos, dirs, pos, cfg)
    ws, wd = raycast.disc_eye_plain(pos, dirs, pos, cfg)
    # bit for bit at power-of-two widths; at others the plain pixel centres
    # divide by W through a reciprocal on the card (the forward's tolerances)
    _close(depth, wd, 1e-5, 1e-4)
    _close(shade, ws, 1e-5, 1e-5)
    got = raycast.render_rows_vjp_cross(pos, dirs, winner, us, ud, cfg)
    want = raycast.render_rows_vjp_cross_plain(pos, dirs, us, ud, cfg)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert x.abs().max() > 0
        torch.testing.assert_close(g, x, rtol=2e-4, atol=2e-4 * x.abs().max().item())


@pytest.mark.parametrize("aa", [False, True])
def test_autograd_functions_on_cuda_match_dense_cpu(cuda, aa):
    """The Functions' gradients on the card against plain autograd of the
    dense backend on the CPU, on the same inputs: gravity against float64,
    because float32 autograd through the dense force cancels (it is the less
    exact side, DESIGN.md section 4b; test_kernels.py:141-155's normalized
    bound); the eye against float32 (the same forward arithmetic;
    test_diff_vision.py's tolerances)."""
    pos0 = _uniform((2, 48, 2), -30, 30, 5, "cpu")
    vel0 = _uniform((2, 48, 2), -1, 1, 6, "cpu")
    us = _uniform((2, 48, 40), -1, 1, 7, "cpu")
    cfg, gcfg = VisionConfig(width=40, antialias=aa), GravityConfig()

    def grads(loss_fn, device, dtype=torch.float32):
        p = pos0.to(device, dtype, copy=True).requires_grad_()
        v = vel0.to(device, dtype, copy=True).requires_grad_()
        loss_fn(p, v).backward()
        return [None if x.grad is None else x.grad.cpu().double() for x in (p, v)]

    got = grads(lambda p, v: (pairwise.gravity_forces_diff(p, gcfg) ** 2).sum(), cuda)[0]
    want = grads(lambda p, v: (dense.gravity_forces(p, gcfg) ** 2).sum(), "cpu",
                 torch.float64)[0]
    assert ((got - want).abs().max() / want.abs().max()).item() < 3e-5
    got = grads(lambda p, v: (raycast.render_rows_diff(p, v, cfg)[0] * us.to(cuda)).sum(), cuda)
    want = grads(lambda p, v: (render.render_rows(p, v, cfg)[0] * us).sum(), "cpu")
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, rtol=2e-4, atol=2e-4 * x.abs().max().item())


@pytest.mark.parametrize("controller", ["gravity", "boids"])
def test_scene_rollout_matches_dense_cpu(cuda, controller):
    cfg = SimConfig(n=96, controller=controller, vision=VisionConfig(width=48))
    ref = Scene(dataclasses.replace(cfg, backend="dense"), device="cpu")
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


@pytest.mark.parametrize("b,n,w", [
    (1, 24, 64), (1, 100, 1024), (1, 60, 32), (3, 72, 512), (64, 256, 64),
    (1, 77, 100), (5, 33, 17),
])
@pytest.mark.parametrize("aa", [False, True])
def test_wireframe_eye_kernel_matches_plain(cuda, b, n, w, aa):
    # the kernel follows the plain division route op for op (built with
    # -fmad=false): at power-of-two widths no pixel flips and the winners
    # agree; at others the plain pixel centres divide by W through a
    # reciprocal on the card, so values hold tests/test_wireframe_kernel.py's
    # tolerance and at most 1e-3 of the pixels may flip
    shape = (b, n, 2) if b > 1 else (n, 2)
    pos = _uniform(shape, -40, 40, n, cuda)
    dirs = camera.unit_heading(_uniform(shape, -1, 1, n + 1, cuda))
    cfg = VisionConfig(width=w, antialias=aa, sprite_mode="wireframe", far=200.0)
    gs, gd, gw = wireframe.wireframe_eye_with_winner(pos, dirs, pos, dirs, cfg)
    ws, wd, ww = wireframe.wireframe_eye_plain(pos, dirs, pos, dirs, cfg)
    torch.cuda.synchronize()
    flips = (gd < cfg.far) != (wd < cfg.far)
    if w & (w - 1) == 0:
        assert not flips.any() and torch.equal(gw.long(), ww)
        _close(gd, wd, 1e-5, 2e-4)
        _close(gs, ws, 1e-5, 2e-4)
    else:
        beyond = flips | ((gd - wd).abs() > 2e-4 + 1e-5 * wd.abs())
        beyond |= (gs - ws).abs() > 2e-4 + 1e-5 * ws.abs()
        assert beyond.double().mean().item() <= 1e-3
    s2, d2 = wireframe.wireframe_eye(pos, dirs, pos, dirs, cfg)  # without the winner
    assert torch.equal(s2, gs) and torch.equal(d2, gd)


def test_wireframe_eye_kernel_tie_goes_to_the_lower_edge(cuda):
    """tests/test_torch_wireframe.py's tie scene on the card: at the centre
    pixel of an odd width (u = 0 in the kernel's arithmetic) target 0's edge
    2 and target 1's edge 0 lie at depth 9; edge-major, target 1 wins."""
    cfg = VisionConfig(width=17, sprite_mode="wireframe", far=200.0)
    eye = torch.tensor([[0.0, 0.0]], device=cuda)
    eye_dir = torch.tensor([[1.0, 0.0]], device=cuda)
    tgt = torch.tensor([[10.0, 0.0], [10.0, 0.0]], device=cuda)
    hdg = torch.tensor([[1.0, 0.0], [-1.0, 0.0]], device=cuda)
    shade, depth, winner = wireframe.wireframe_eye_with_winner(eye, eye_dir, tgt, hdg, cfg)
    torch.cuda.synchronize()
    assert depth[0, 8].item() == 9.0 and winner[0, 8].item() == 1 and shade[0, 8].item() == 0.5


@pytest.mark.parametrize("aa", [False, True])
def test_wireframe_diff_on_cuda_matches_plain_autograd(cuda, aa):
    """RenderRowsWireframeDiff on the card (the kernel's forward with its
    winner index, the winner pullback) against autograd through the plain
    renderer on the card; its launches: one forward, no backward kernel."""
    pos0 = _uniform((4, 64, 2), -30, 30, 5, cuda)
    vel0 = _uniform((4, 64, 2), -1, 1, 6, cuda)
    us = _uniform((4, 64, 64), -1, 1, 7, cuda)
    ud = _uniform((4, 64, 64), -1e-3, 1e-3, 8, cuda)
    cfg = VisionConfig(width=64, antialias=aa, sprite_mode="wireframe")
    grads, launches = [], []
    for fn in (lambda p, v: wireframe.render_rows_wireframe_tiled(p, v, cfg),
               lambda p, v: render.render_rows(p, v, cfg)):
        common.reset_launch_counts()
        p, v = pos0.clone().requires_grad_(), vel0.clone().requires_grad_()
        shade, depth = fn(p, v)
        ((shade * us).sum() + (depth * ud).sum()).backward()
        grads.append((p.grad, v.grad))
        launches.append(common.launch_counts())
    assert launches[0] == {**{k: 0 for k in common.KERNELS}, "wireframe_eye": 1}
    assert all(c == 0 for c in launches[1].values())  # the plain route
    torch.cuda.synchronize()
    for g, x in zip(*grads):
        assert x.abs().max() > 0
        torch.testing.assert_close(g, x, rtol=2e-4, atol=2e-4 * x.abs().max().item())
    common.reset_launch_counts()
    cfg_sim = SimConfig(n=64, controller="gravity", vision=cfg)
    scene = Scene(cfg_sim, device=cuda)
    scene.observe(scene.step(scene.spawn(0)))
    assert common.launch_counts()["wireframe_eye"] == 1 and common.launch_counts()["disc_eye"] == 0
