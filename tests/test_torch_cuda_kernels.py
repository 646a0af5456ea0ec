"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test asks the `cuda` fixture for the device, which skips
the test when no GPU is present (the CPU suite collects and skips them).
Run them on a machine with a GPU (no jax needed there, hence --noconftest):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances are the JAX suite's between its Pallas kernels and its dense
oracle (tests/test_kernels.py, tests/test_diff_vision.py), with the reason
beside each.
"""

import ctypes
import dataclasses
import math

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
    # the cross form goes through its Function, whose backward is the VJP
    # source's cross entry point: one more gravity_vjp launch
    other = _uniform((40, 2), -100, 100, 2, cuda).requires_grad_()
    g = pairwise.gravity_forces_tiled(pos, GravityConfig(), other)
    assert type(g.grad_fn).__name__ == "GravityForcesCrossDiffBackward"
    g.sum().backward()
    assert common.launch_counts()["gravity_vjp"] == 2 and other.grad.abs().max() > 0
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
    winner index, the backward kernel) against autograd through the plain
    renderer on the card; its launches: one forward, one backward."""
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
    assert launches[0] == {**{k: 0 for k in common.KERNELS}, "wireframe_eye": 1,
                           "wireframe_eye_bwd": 1}
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


@pytest.mark.parametrize("b,n,m", [(1, 16, 16), (1, 300, 77), (3, 256, 513), (1, 4096, 4096)])
@pytest.mark.parametrize("exclude_diagonal", [True, False])
def test_boids_partials_kernel_matches_plain(cuda, b, n, m, exclude_diagonal):
    # the counts are exact; the sums run in another order (test_kernels.py:60's
    # tolerances, atol scaled by the largest sum: the repel sum cancels)
    shape_i, shape_j = ((b,) if b > 1 else ()) + (n, 2), ((b,) if b > 1 else ()) + (m, 2)
    pos_i = _uniform(shape_i, -30, 30, n, cuda)
    vel_i = _uniform(shape_i, -1, 1, n + 1, cuda)
    pos_j = pos_i if exclude_diagonal and n == m else _uniform(shape_j, -30, 30, m, cuda)
    vel_j = vel_i if exclude_diagonal and n == m else _uniform(shape_j, -1, 1, m + 1, cuda)
    cfg = BoidsConfig()
    got = boids_ops.boids_partials_tiled(pos_i, vel_i, pos_j, vel_j, cfg, exclude_diagonal)
    want = boids_ops.boids_partials_plain(pos_i, vel_i, pos_j, vel_j, cfg, exclude_diagonal)
    torch.cuda.synchronize()
    for k, (g, x) in enumerate(zip(got, want)):
        if k in (1, 4):
            assert torch.equal(g, x)
        else:
            _close(g, x, 3e-5, 1e-6 * max(1.0, x.abs().max().item()))


def test_boids_partials_kernel_sentinels_stay_inert(cuda):
    """The ring's far sentinels (1e17): their squared distance 1e34 fits in
    fp32 and fails every threshold, so a padded j-block adds nothing and a
    padded i-row sees no real agent."""
    pos = _uniform((100, 2), -30, 30, 1, cuda)
    vel = _uniform((100, 2), -1, 1, 2, cuda)
    pad = torch.full((28, 2), 1e17, device=cuda)
    cfg = BoidsConfig()
    got = boids_ops.boids_partials_tiled(pos, vel, torch.cat([pos, pad]), torch.cat([vel, pad]),
                                         cfg, exclude_diagonal=False)
    want = boids_ops.boids_partials_tiled(pos, vel, pos, vel, cfg, exclude_diagonal=False)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    far = boids_ops.boids_partials_tiled(pad, pad, pos, vel, cfg, exclude_diagonal=False)
    assert all(not t.any() for t in far)


@pytest.mark.parametrize("b,n,m", [(1, 1, 1), (1, 64, 300), (3, 257, 77), (4096, 64, 64)])
def test_gravity_vjp_cross_kernel_matches_float64(cuda, b, n, m):
    # both outputs against the plain version in float64, normalized by
    # their largest component (ROADMAP queue 3's allowance for gravity
    # gradients: test_kernels.py:141-155's bound)
    lead = (b,) if b > 1 else ()
    pos_i = _uniform(lead + (n, 2), -100, 100, n, cuda)
    pos_j = _uniform(lead + (m, 2), -100, 100, m, cuda)
    u = torch.randn(lead + (n, 2), generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda)
    cfg = GravityConfig()
    got = pairwise.gravity_vjp_cross_tiled(pos_i, pos_j, u, cfg)
    want = pairwise.gravity_vjp_cross_plain(pos_i.double(), pos_j.double(), u.double(), cfg)
    for g, x in zip(got, want):
        _scaled_close(g.double(), x, 3e-5)


@pytest.mark.parametrize("b,n,w", [(1, 1024, 64), (1, 100, 1024), (1, 60, 32), (64, 256, 64),
                                   (5, 33, 17), (1, 16, 512)])
@pytest.mark.parametrize("aa", [False, True])
def test_wireframe_eye_bwd_kernel_matches_winner_pullback(cuda, b, n, w, aa):
    # the written-out reverse sweep against autograd through the same
    # expressions: per-pixel terms round apart, and the target sums run in
    # atomic (run-to-run) order (the disc backward's tolerances)
    shape = (b, n, 2) if b > 1 else (n, 2)
    pos = _uniform(shape, -40, 40, n, cuda)
    dirs = camera.unit_heading(_uniform(shape, -1, 1, n + 1, cuda))
    cfg = VisionConfig(width=w, antialias=aa, sprite_mode="wireframe", far=200.0)
    gen = torch.Generator(device=cuda).manual_seed(2)
    us = torch.randn(shape[:-1] + (w,), generator=gen, device=cuda)
    ud = torch.randn(shape[:-1] + (w,), generator=gen, device=cuda) * 1e-2
    _, _, winner = wireframe.wireframe_eye_with_winner(pos, dirs, pos, dirs, cfg)
    common.reset_launch_counts()
    got = wireframe.wireframe_eye_vjp(pos, dirs, pos, dirs, winner, us, ud, cfg)
    assert common.launch_counts()["wireframe_eye_bwd"] == 1
    want = wireframe.winner_pullback(pos, dirs, pos, dirs, winner, us, ud, cfg)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert x.abs().max() > 0
        torch.testing.assert_close(g, x, rtol=2e-4, atol=2e-4 * x.abs().max().item())


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_ring_on_cuda_matches_one_device(cuda, sprite):
    """The ring on a mesh that repeats the card 4 times, against the one-
    device kernels: forces, boids, rows and their gradients (the per-hop
    backward kernels through autograd); the launch counts show the hops."""
    from nenbody_tpu_torch.parallel import make_mesh, ring

    mesh = make_mesh({"data": 2, "agents": 2}, devices=[cuda] * 4)
    pos0 = _uniform((4, 64, 2), -30, 30, 8, cuda)
    vel0 = _uniform((4, 64, 2), -1, 1, 9, cuda)
    cfg = SimConfig(n=64, controller="gravity")
    vcfg = VisionConfig(width=64, antialias=True, sprite_mode=sprite, far=200.0)
    us = _uniform((4, 64, 64), -1, 1, 10, cuda)
    common.reset_launch_counts()
    b = ring.ring_boids_velocity(pos0, vel0, cfg, mesh=mesh, data_axis="data")
    assert common.launch_counts()["boids_partials"] == 2 * 2 * 2  # data x agents x hops
    _close(b, boids_ops.boids_velocity_tiled(pos0, vel0, cfg.boids), 3e-5, 1e-6)
    grads = []
    for one_device in (False, True):
        p, v = pos0.clone().requires_grad_(), vel0.clone().requires_grad_()
        if one_device:
            g = pairwise.gravity_forces_tiled(p, cfg.gravity)
            shade, _ = (wireframe.render_rows_wireframe_tiled(p, v, vcfg) if sprite == "wireframe"
                        else raycast.render_rows_tiled(p, v, vcfg))
        else:
            g = ring.ring_gravity_forces(p, cfg, mesh=mesh, data_axis="data")
            shade, _ = ring.ring_render_rows_diff(p, v, vcfg, mesh=mesh, data_axis="data")
        ((g * g).sum() * 1e3 + (shade * us).sum()).backward()
        grads.append((g.detach(), shade.detach(), p.grad, v.grad))
    torch.cuda.synchronize()
    (g_r, s_r, *gr), (g_1, s_1, *g1) = grads
    _scaled_close(g_r, g_1, 3e-5)
    _close(s_r, s_1, 1e-5, 2e-4)
    for a, x in zip(gr, g1):
        torch.testing.assert_close(a, x, rtol=2e-4, atol=2e-4 * x.abs().max().item())


def _rdma_case(kind, d, shape, cuda):
    """(the RDMA function's output, its plain version's) on a mesh that names
    the card d times; the plain version runs on the card too."""
    from nenbody_tpu_torch.parallel import make_mesh, rdma

    mesh = make_mesh({"agents": d}, devices=[cuda] * d)
    n = shape[-1]
    lead = shape[:-1]
    spread = 100.0 if kind == "rows" else 20.0  # clustered: every boids rule fires
    pos = _uniform(lead + (n, 2), -spread, spread, n, cuda)
    vel = _uniform(lead + (n, 2), -1, 1, n + 1, cuda)
    if kind == "gravity":
        cfg = SimConfig(n=n, controller="gravity")
        call = lambda f: f(pos, cfg, mesh=mesh)
        fns = rdma.rdma_ring_gravity_forces, rdma.rdma_ring_gravity_forces_plain
    elif kind == "boids":
        cfg = SimConfig(n=n, controller="boids")
        call = lambda f: f(pos, vel, cfg, mesh=mesh)
        fns = rdma.rdma_ring_boids_velocity, rdma.rdma_ring_boids_velocity_plain
    else:
        vcfg = VisionConfig(width=48)
        call = lambda f: f(pos, vel, vcfg, mesh=mesh)
        fns = rdma.rdma_ring_render_rows, rdma.rdma_ring_render_rows_plain
    return (lambda: call(fns[0])), call(fns[1])


RDMA_CASES = [(kind, d, shape) for kind in ("gravity", "boids", "rows") for d in (2, 3, 4, 8)
              for shape in ((203,), (3, 70))]
# gravity at its plan's edges on an H100 (132 SMs): T R - 1, T R and T R + 1
# rows a shard, for T R = 32 (one env on 2 shards) and T R = 512 (33 envs on
# 4 shards: T = 256, R = 1 then 2; tests/test_torch_rdma_gravity_plan.py
# pins these plans)
RDMA_GRAVITY_EDGES = [("gravity", d, (nb, d * nl)) for d, nb, tr in ((2, 1, 32), (4, 33, 512))
                      for nl in (tr - 1, tr, tr + 1)]


@pytest.mark.parametrize("kind,d,shape", RDMA_CASES + RDMA_GRAVITY_EDGES)
def test_rdma_ring_kernel_matches_plain_and_repeats(cuda, kind, d, shape):
    """Each RDMA kernel (one launch walking every hop) against its plain
    version on the card: gravity normalised by its largest force (sums in
    another order, test_kernels.py:141-155's bound), boids at the fused
    kernel's tolerances, the rows at the eye's with no pixel flipped; then
    20 more launches give the same bits (a shard's hop order is fixed)."""
    run, want = _rdma_case(kind, d, shape, cuda)
    common.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    name = {"gravity": "rdma_gravity", "boids": "rdma_boids", "rows": "rdma_vision"}[kind]
    counts = common.launch_counts()
    assert counts[name] == 1 and sum(counts.values()) == 1
    if kind == "gravity":
        _scaled_close(got, want, 3e-5)
    elif kind == "boids":
        _close(got, want, 3e-5, 1e-6)
    else:
        far = VisionConfig().far
        assert int(((got[1] < far) != (want[1] < far)).sum()) == 0
        assert (want[1] < far).double().mean() > 0.01
        _close(got[1], want[1], 1e-5, 1e-4)
        _close(got[0], want[0], 1e-5, 1e-5)
    first = got if kind == "rows" else (got,)
    for _ in range(20):
        again = run()
        again = again if kind == "rows" else (again,)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(again, first))


def test_rdma_gravity_plan_matches_the_kernels(cuda):
    """nbt_rdma_gravity_plan (the kernel's) equals rdma_gravity_plan (the
    wrapper's, which the launch takes) over envs, rows a shard, shards on
    the card and SM counts."""
    from nenbody_tpu_torch.parallel import rdma

    out = (ctypes.c_int * 3)()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for count in (sms, 132, 16):
        for nb in (1, 3, 33, 4096):
            for nl in (1, 31, 32, 33, 64, 203, 300, 511, 512, 513, 16384, 16385):
                for shards in (1, 2, 3, 4, 8):
                    common.kernel_library().call("nbt_rdma_gravity_plan", nb, nl, shards, count,
                                                 ctypes.addressof(out))
                    assert tuple(out) == rdma.rdma_gravity_plan(nb, nl, shards, count)


def _rdma_tie_scene(device):
    """tests/test_torch_rdma.py's tie scene: 512 agents on 2 shards, all at
    x = -50 behind the two eyes except eye 300 at (0, 0) looking along +x,
    which sees agent 400 (hop 0) at (10, 0.5) and agent 100 (hop 1) at
    (10, 0) at one depth on the centre pixel of 17, and eye 301 at (0, 100),
    which sees agents 150 at (10, 100.5) and 200 at (10, 100), both on hop 1."""
    pos = torch.stack([torch.full((512,), -50.0), torch.linspace(-300.0, 300.0, 512)], -1)
    vel = torch.tensor([0.0, 1.0]).repeat(512, 1)
    for i, (x, y) in {300: (0, 0), 400: (10, 0.5), 100: (10, 0),
                      301: (0, 100), 150: (10, 100.5), 200: (10, 100)}.items():
        pos[i] = torch.tensor([x, y], dtype=torch.float32)
    vel[300] = vel[301] = torch.tensor([1.0, 0.0])
    return pos.to(device), vel.to(device)


def test_rdma_vision_kernel_tie_rule(cuda):
    """The eye kernel's keys keep the JAX RDMA kernel's tie rules: across
    hops the earlier hop keeps an exact depth tie (eye 300 keeps agent 400,
    off^2 = 0.25, shade 0.9375), within a hop the least off^2 wins (eye 301
    gets agent 200, shade 1.0); one launch, the rest of the rows within the
    rows' tolerance of the plain version, and 20 more launches bit-identical."""
    from nenbody_tpu_torch.parallel import make_mesh, rdma

    pos, vel = _rdma_tie_scene(cuda)
    mesh = make_mesh({"agents": 2}, devices=[cuda] * 2)
    vcfg = VisionConfig(width=17)
    common.reset_launch_counts()
    got = rdma.rdma_ring_render_rows(pos, vel, vcfg, mesh=mesh)
    torch.cuda.synchronize()
    counts = common.launch_counts()
    assert counts["rdma_vision"] == 1 and sum(counts.values()) == 1
    want = rdma.rdma_ring_render_rows_plain(pos, vel, vcfg, mesh=mesh)
    _close(got[1], want[1], 1e-5, 1e-4)
    _close(got[0], want[0], 1e-5, 1e-5)
    assert got[1][300, 8].item() == got[1][301, 8].item() == 10.0
    assert got[0][300, 8].item() == pytest.approx(0.9375)
    assert got[0][301, 8].item() == pytest.approx(1.0)
    for _ in range(20):
        again = rdma.rdma_ring_render_rows(pos, vel, vcfg, mesh=mesh)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(again, got))


# -- appearance: per-target albedo and skin textures -------------------------

# a texture staged in shared memory (32 x 32), and one read from device
# memory (more than 4,096 texels)
TEXTURES = {"staged": (32, 32), "global": (80, 72)}


def _appearance(form, tex, lead, m, device):
    """(albedo [lead, M] or None, texture or None) for one appearance form."""
    albedo = _uniform(lead + (m,), 0.3, 1.0, 11, device) if "albedo" in form else None
    texture = None
    if "texture" in form:
        ht, wt = TEXTURES[tex]
        texture = render.checker_texture(max(ht, wt), 4, device=device)[:ht, :wt].contiguous()
        texture = texture * _uniform((ht, wt), 0.8, 1.0, 12, device)  # no two texels alike
    return albedo, texture


@pytest.mark.parametrize("b,n,w", [(1, 24, 64), (1, 100, 128), (3, 72, 512), (5, 33, 17)])
@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("form,tex", [("albedo", None), ("texture", "staged"),
                                      ("albedo+texture", "staged"), ("texture", "global")])
@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_eye_appearance_kernels_match_plain(cuda, b, n, w, aa, form, tex, sprite):
    # tests/test_texture_kernel.py's tolerances (atol 3e-4, rtol 1e-5; the
    # sample's texel picks are threshold tests on the winner's uv), the
    # depth equal to the untextured kernel's: appearance moves no winner
    shape = (b, n, 2) if b > 1 else (n, 2)
    pos = _uniform(shape, -40, 40, n, cuda)
    dirs = camera.unit_heading(_uniform(shape, -1, 1, n + 1, cuda))
    cfg = VisionConfig(width=w, antialias=aa, sprite_mode=sprite, far=200.0)
    albedo, texture = _appearance(form, tex, shape[:-2], n, cuda)
    if sprite == "wireframe":
        gs, gd = wireframe.wireframe_eye(pos, dirs, pos, dirs, cfg, albedo, texture)
        ws, wd, _ = wireframe.wireframe_eye_plain(pos, dirs, pos, dirs, cfg, albedo, texture)
        _, bare = wireframe.wireframe_eye(pos, dirs, pos, dirs, cfg)
    else:
        gs, gd = raycast.disc_eye(pos, dirs, pos, cfg, albedo, texture)
        ws, wd = raycast.disc_eye_plain(pos, dirs, pos, cfg, albedo, texture)
        _, bare = raycast.disc_eye(pos, dirs, pos, cfg)
    torch.cuda.synchronize()
    assert torch.equal(gd, bare)
    flips = (gd < cfg.far) != (wd < cfg.far)
    assert (wd < cfg.far).double().mean() > 0.01
    if w & (w - 1) == 0:
        assert not flips.any()
        _close(gd, wd, 1e-5, 3e-4)
        _close(gs, ws, 1e-5, 3e-4)
    else:  # pixel centres through a reciprocal on the card: the forward's allowance
        beyond = flips | ((gd - wd).abs() > 3e-4 + 1e-5 * wd.abs())
        beyond |= (gs - ws).abs() > 3e-4 + 1e-5 * ws.abs()
        assert beyond.double().mean().item() <= 1e-3


@pytest.mark.parametrize("b,n,w", [(1, 100, 64), (3, 60, 32), (256, 64, 64)])
@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("form,tex", [("albedo", None), ("texture", "staged"),
                                      ("albedo+texture", "staged"), ("texture", "global")])
def test_wireframe_eye_bwd_appearance_matches_winner_pullback(cuda, b, n, w, aa, form, tex):
    # the disc backward's tolerances (per-pixel terms round apart; atomic
    # sums in run-to-run order); 256 envs make the texture launch loop over
    # envs (a staged texture's gradient sums per block)
    shape = (b, n, 2) if b > 1 else (n, 2)
    pos = _uniform(shape, -40, 40, n, cuda)
    dirs = camera.unit_heading(_uniform(shape, -1, 1, n + 1, cuda))
    cfg = VisionConfig(width=w, antialias=aa, sprite_mode="wireframe", far=200.0)
    albedo, texture = _appearance(form, tex, shape[:-2], n, cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    us = torch.randn(shape[:-1] + (w,), generator=gen, device=cuda)
    ud = torch.randn(shape[:-1] + (w,), generator=gen, device=cuda) * 1e-2
    _, _, winner = wireframe.wireframe_eye_with_winner(pos, dirs, pos, dirs, cfg, albedo, texture)
    common.reset_launch_counts()
    got = wireframe.wireframe_eye_vjp(pos, dirs, pos, dirs, winner, us, ud, cfg, albedo, texture)
    assert common.launch_counts()["wireframe_eye_bwd"] == 1
    want = wireframe.winner_pullback(pos, dirs, pos, dirs, winner, us, ud, cfg, albedo, texture)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 4 + (albedo is not None) + (texture is not None)
    for g, x in zip(got, want):
        assert x.abs().max() > 0
        torch.testing.assert_close(g, x, rtol=2e-4, atol=2e-4 * x.abs().max().item())


def test_appearance_paths_launch_the_kernels(cuda):
    """With albedo or a texture on CUDA tensors, the disc rows, the
    wireframe rows, the wireframe gradient and the ring each launch their
    kernels (and no plain version runs: it would count no launch); the disc
    refuses a gradient with appearance, as the JAX package has none."""
    from nenbody_tpu_torch.parallel import make_mesh, ring

    pos = _uniform((2, 64, 2), -30, 30, 1, cuda)
    vel = _uniform((2, 64, 2), -1, 1, 2, cuda)
    albedo = _uniform((2, 64), 0.3, 1.0, 3, cuda)
    tex = render.checker_texture(32, 4, device=cuda)
    disc = VisionConfig(width=64, antialias=True, far=200.0)
    wf = dataclasses.replace(disc, sprite_mode="wireframe")
    common.reset_launch_counts()
    raycast.render_rows_tiled(pos, vel, disc, albedo=albedo, texture=tex)
    wireframe.render_rows_wireframe_tiled(pos, vel, wf, albedo=albedo, texture=tex)
    assert common.launch_counts()["disc_eye"] == 1 and common.launch_counts()["wireframe_eye"] == 1
    p, a, t = pos.clone().requires_grad_(), albedo.clone().requires_grad_(), tex.clone().requires_grad_()
    shade, _ = wireframe.render_rows_wireframe_diff(p, vel, wf, a, t)
    shade.sum().backward()
    counts = common.launch_counts()
    assert counts["wireframe_eye"] == 2 and counts["wireframe_eye_bwd"] == 1
    assert all(torch.isfinite(x.grad).all() and x.grad.abs().max() > 0 for x in (p, a, t))
    mesh = make_mesh({"agents": 2}, devices=[cuda] * 2)
    for cfg, name in ((disc, "disc_eye"), (wf, "wireframe_eye")):
        common.reset_launch_counts()
        got = ring.ring_render_rows(pos, vel, cfg, mesh=mesh, texture=tex)
        assert common.launch_counts()[name] == 2 * 2  # shards x hops
        one = (wireframe.render_rows_wireframe_tiled(pos, vel, cfg, texture=tex)
               if cfg is wf else raycast.render_rows_tiled(pos, vel, cfg, texture=tex))
        _close(got[1], one[1], 1e-5, 1e-4)
        _close(got[0], one[0], 1e-5, 3e-4)
    with pytest.raises(NotImplementedError, match="albedo or texture"):
        raycast.render_rows_tiled(pos.clone().requires_grad_(), vel, disc, texture=tex)


# -- the disc eye's culls and gravity's plan and split sum --------------------


def _plain_winner(eye_pos, eye_dir, tgt, cfg):
    """The plain renderer's winner index (vision.render.eye_rows's argmin
    over the covered targets' depths; -1 where none covers the pixel)."""
    rel = tgt[..., None, :, :] - eye_pos[..., :, None, :]
    u_c, du, f, visible = camera.project(rel, eye_dir, cfg)
    safe_du = du.clamp(min=1e-30)
    off = (camera.pixel_centers(cfg, device=eye_pos.device) - u_c[..., None]) / safe_du[..., None]
    thr = 1.0 + ((1.0 / cfg.width) / safe_du)[..., None] if cfg.antialias else 1.0
    cover = visible[..., None] & (off.abs() < thr)
    field = torch.where(cover, f[..., None], torch.full_like(off, float("inf")))
    winner = field.argmin(dim=-2)  # the first minimum: the lowest index of a tie
    best = field.gather(-2, winner[..., None, :]).squeeze(-2)
    return torch.where(torch.isfinite(best), winner, -1).to(torch.int32)


def _frame_targets(kind, b, m, w, aa, device, seed):
    """(eye_pos [b, 1, 2], eye_dir [b, 1, 2], tgt [b, m, 2]): targets placed
    in each env's eye frame (t = 1) with the footprint centre on a pixel
    boundary ('boundaries') or the footprint's edge a few ulps from the
    centre of the first or last pixel of a 32-pixel span ('edges')."""
    g = torch.Generator(device=device).manual_seed(seed)
    eye = torch.rand((b, 1, 2), generator=g, device=device) * 100 - 50
    d = camera.unit_heading(torch.rand((b, 1, 2), generator=g, device=device) * 2 - 1)
    f = torch.rand((b, m), generator=g, device=device) * 58 + 2
    if kind == "boundaries":
        u = 2.0 * torch.randint(0, w + 1, (b, m), generator=g, device=device) / w - 1.0
    else:
        first = 32 * torch.randint(0, -(-w // 32), (b, m), generator=g, device=device)
        low = torch.rand((b, m), generator=g, device=device) < 0.5
        end = torch.where(low, first, (first + 31).clamp(max=w - 1))
        reach = 1.0 / f + (1.0 / w if aa else 0.0)  # thr du at t = 1, r = 1
        u = (2.0 * (end + 0.5) / w - 1.0) + torch.where(low, -1.0, 1.0) * reach
    right = torch.stack([d[..., 1], -d[..., 0]], dim=-1)
    tgt = (eye + f[..., None] * d + (u * f)[..., None] * right).contiguous()
    return eye.contiguous(), d.contiguous(), tgt


def _hold_disc_exact(eye_pos, eye_dir, tgt, cfg, albedo=None, texture=None):
    """The kernel's shade, depth and winner equal the plain version's bit
    for bit (a power-of-two width: the pixel centres and 1/W are exact
    on both sides)."""
    if albedo is None and texture is None:
        gs, gd, winner = raycast.disc_eye_with_winner(eye_pos, eye_dir, tgt, cfg)
    else:
        (gs, gd), winner = raycast.disc_eye(eye_pos, eye_dir, tgt, cfg, albedo, texture), None
    ws, wd = raycast.disc_eye_plain(eye_pos, eye_dir, tgt, cfg, albedo, texture)
    torch.cuda.synchronize()
    assert (wd < cfg.far).any()
    assert torch.equal(gd, wd) and torch.equal(gs, ws)
    if winner is not None:
        assert torch.equal(winner, _plain_winner(eye_pos, eye_dir, tgt, cfg))


@pytest.mark.parametrize("aa", [False, True])
def test_disc_eye_exact_depth_ties_go_to_the_lowest_index(cuda, aa):
    # every target twice, at one position: each pixel's winner is the first copy
    pos = _uniform((2, 40, 2), -30, 30, 21, cuda)
    tgt = torch.cat([pos, pos], dim=-2).contiguous()
    dirs = camera.unit_heading(_uniform((2, 40, 2), -1, 1, 22, cuda))
    cfg = VisionConfig(width=64, antialias=aa)
    _hold_disc_exact(pos, dirs, tgt, cfg)
    _, _, winner = raycast.disc_eye_with_winner(pos, dirs, tgt, cfg)
    assert (winner < 40).all() and (winner >= 0).any()


@pytest.mark.parametrize("kind", ["boundaries", "edges"])
@pytest.mark.parametrize("w", [64, 1024])
@pytest.mark.parametrize("aa", [False, True])
def test_disc_eye_footprints_on_pixel_boundaries_and_edges(cuda, kind, w, aa):
    eye, d, tgt = _frame_targets(kind, 8, 300, w, aa, cuda, seed=w)
    _hold_disc_exact(eye, d, tgt, VisionConfig(width=w, antialias=aa))


@pytest.mark.parametrize("b,n,w", [(1, 1024, 64), (4, 256, 64), (1, 300, 256), (1, 100, 1024)])
@pytest.mark.parametrize("aa", [False, True])
def test_disc_eye_clustered_swarm_is_exact(cuda, b, n, w, aa):
    # U(-8, 8): near targets with wide ranges, which the warp walks together
    shape = (b, n, 2) if b > 1 else (n, 2)
    pos = _uniform(shape, -8, 8, n + w, cuda)
    dirs = camera.unit_heading(_uniform(shape, -1, 1, n + w + 1, cuda))
    _hold_disc_exact(pos, dirs, pos, VisionConfig(width=w, antialias=aa))


@pytest.mark.parametrize("nt", [4096, 5000])
@pytest.mark.parametrize("aa", [False, True])
def test_disc_eye_many_targets_cross_form(cuda, nt, aa):
    # eyes against another, larger target set (a ring hop's cross form):
    # many tiles, the last one ragged
    eyes = _uniform((2, 96, 2), -100, 100, nt, cuda)
    dirs = camera.unit_heading(_uniform((2, 96, 2), -1, 1, nt + 1, cuda))
    tgt = _uniform((2, nt, 2), -100, 100, nt + 2, cuda)
    _hold_disc_exact(eyes, dirs, tgt, VisionConfig(width=128, antialias=aa))


@pytest.mark.parametrize("w", [17, 100])
@pytest.mark.parametrize("aa", [False, True])
def test_disc_eye_odd_widths(cuda, w, aa):
    # pixel centres go through a reciprocal in the plain version on the card
    # (the appearance test's allowance); the winner is still the plain argmin
    # wherever both cover the pixel alike
    pos = _uniform((3, 200, 2), -60, 60, w, cuda)
    dirs = camera.unit_heading(_uniform((3, 200, 2), -1, 1, w + 1, cuda))
    cfg = VisionConfig(width=w, antialias=aa)
    gs, gd = raycast.disc_eye(pos, dirs, pos, cfg)
    ws, wd = raycast.disc_eye_plain(pos, dirs, pos, cfg)
    torch.cuda.synchronize()
    beyond = ((gd < cfg.far) != (wd < cfg.far)) | ((gd - wd).abs() > 1e-4 + 1e-5 * wd.abs())
    beyond |= (gs - ws).abs() > 1e-5 + 1e-5 * ws.abs()
    assert (wd < cfg.far).any() and beyond.double().mean().item() <= 1e-3


@pytest.mark.parametrize("form", ["albedo", "texture", "albedo+texture"])
@pytest.mark.parametrize("aa", [False, True])
def test_disc_eye_appearance_forms_are_exact(cuda, form, aa):
    pos = _uniform((3, 128, 2), -40, 40, 31, cuda)
    dirs = camera.unit_heading(_uniform((3, 128, 2), -1, 1, 32, cuda))
    albedo, texture = _appearance(form, "staged", (3,), 128, cuda)
    _hold_disc_exact(pos, dirs, pos, VisionConfig(width=256, antialias=aa), albedo, texture)


def _gravity_plan_of_card(batch, n, m, sms):
    out = (ctypes.c_int * 5)()
    common.kernel_library().call("nbt_gravity_plan", batch, n, m, sms, ctypes.addressof(out))
    return tuple(out)


def test_gravity_plan_matches_the_kernels(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for count in (sms, 132, 16):
        for batch in (1, 3, 4096):
            for n, m in ((1, 1), (2, 2), (300, 77), (1024, 1024), (16384, 16384), (65537, 65537)):
                assert _gravity_plan_of_card(batch, n, m, count) == pairwise.gravity_plan(
                    batch, n, m, count)


@pytest.mark.parametrize("n", [1, 2, 1024])
def test_gravity_kernel_small_and_split(cuda, n):
    # N=1,024 splits the j range 8 ways across a cluster on an H100
    pos = _uniform((n, 2), -100, 100, n + 7, cuda)
    cfg = GravityConfig()
    _close(pairwise.gravity_forces_tiled(pos, cfg), pairwise.gravity_forces_plain(pos, cfg),
           3e-5, 1e-7)


def test_gravity_kernel_ragged_large_n_against_float64(cuda):
    # N=65,537: a ragged i block and j tile; the sum cancels heavily, so the
    # error is normalised by max |g| against N * 2^-24 (chip_smoke.py phase 3)
    n = 65537
    pos = _uniform((n, 2), -100, 100, 8, cuda)
    cfg = GravityConfig()
    got = pairwise.gravity_forces_tiled(pos, cfg)
    want = pairwise.gravity_forces_plain(pos.double(), cfg)
    torch.cuda.synchronize()
    err = ((got.double() - want).abs().max() / want.norm(dim=-1).max()).item()
    assert err < n * 2.0 ** -24


@pytest.mark.parametrize("b,n,m", [(4096, 256, 256), (3, 300, 1000), (2, 1000, 37)])
def test_gravity_kernel_batched_and_cross(cuda, b, n, m):
    pos = _uniform((b, n, 2), -100, 100, n, cuda)
    pos_j = pos if m == n else _uniform((b, m, 2), -100, 100, m, cuda)
    cfg = GravityConfig()
    _close(pairwise.gravity_forces_tiled(pos, cfg, pos_j),
           pairwise.gravity_forces_plain(pos, cfg, pos_j), 3e-5, 1e-7)


@pytest.mark.parametrize("n", [300, 1024])
def test_gravity_kernel_approx_mode_split(cuda, n):
    pos = _uniform((n, 2), -100, 100, n + 3, cuda)
    want = pairwise.gravity_forces_plain(pos, GravityConfig())
    got = pairwise.gravity_forces_tiled(pos, GravityConfig(approx_reciprocal=True))
    torch.cuda.synchronize()
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-2


@pytest.mark.parametrize("shape", [(1024, 2), (16384, 2), (4096, 256, 2)])
def test_gravity_kernel_repeats_bit_for_bit(cuda, shape):
    # the cluster's leader adds the partials in rank order: 20 more launches
    # give the first one's bits
    pos = _uniform(shape, -100, 100, 9, cuda)
    cfg = GravityConfig()
    first = pairwise.gravity_forces_tiled(pos, cfg)
    for _ in range(20):
        assert torch.equal(pairwise.gravity_forces_tiled(pos, cfg), first)


# -- the wireframe eye's culls and keys, boids' plan and split sum ------------


def _hold_wireframe_exact(eye_pos, eye_dir, tgt, hdg, cfg):
    """The kernel's shade, depth and winner equal the plain version's bit
    for bit at a power-of-two width (the pixel centres and 1/W are exact on
    both sides); at other widths the plain pixel centres divide by W through
    a reciprocal on the card, so, as test_wireframe_eye_kernel_matches_plain
    allows, at most 1e-3 of the pixels may flip or differ beyond
    tests/test_wireframe_kernel.py's tolerance."""
    gs, gd, gw = wireframe.wireframe_eye_with_winner(eye_pos, eye_dir, tgt, hdg, cfg)
    ws, wd, ww = wireframe.wireframe_eye_plain(eye_pos, eye_dir, tgt, hdg, cfg)
    torch.cuda.synchronize()
    assert (wd < cfg.far).any()
    if cfg.width & (cfg.width - 1) == 0:
        assert torch.equal(gd, wd) and torch.equal(gs, ws) and torch.equal(gw.long(), ww)
        return
    beyond = ((gd < cfg.far) != (wd < cfg.far)) | ((gd - wd).abs() > 2e-4 + 1e-5 * wd.abs())
    beyond |= (gs - ws).abs() > 2e-4 + 1e-5 * ws.abs()
    assert beyond.double().mean().item() <= 1e-3


def _wf_frame(kind, b, m, w, device, seed):
    """(eye_pos, eye_dir [b, 1, 2], tgt, hdg [b, m, 2]): sprites in each
    env's eye frame (t = 1) straddling the near plane ('near_plane') or with
    edge 0 ((2, 1) r in the sprite frame) along the ray of a pixel centre,
    turned by less than 1e-6 rad ('edge_on')."""
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=g, device=device)
    eye = rand(b, 1, 2) * 100 - 50
    d = camera.unit_heading(rand(b, 1, 2) * 2 - 1)
    right = torch.stack([d[..., 1], -d[..., 0]], dim=-1)
    if kind == "near_plane":
        f = 1.0 + rand(b, m) * 3 - 1.5
        lat = (rand(b, m) * 3 - 1.5) * f.clamp(min=0.5)
        tgt = eye + f[..., None] * d + lat[..., None] * right
        return eye, d, tgt.contiguous(), camera.unit_heading(rand(b, m, 2) * 2 - 1)
    f = rand(b, m) * 37 + 3
    u = 2.0 * (torch.randint(0, w, (b, m), generator=g, device=device) + 0.5) / w - 1.0
    flip = (rand(b, m) < 0.5) * math.pi
    phi = torch.atan2(u, torch.ones_like(u)) + (rand(b, m) * 2e-6 - 1e-6) + flip
    world = torch.cos(phi)[..., None] * d + torch.sin(phi)[..., None] * right
    theta = torch.atan2(world[..., 1], world[..., 0]) - math.atan2(1.0, 2.0)
    c, s = torch.cos(theta), torch.sin(theta)
    vert0 = eye + f[..., None] * d + (u * f)[..., None] * right
    return eye, d, (vert0 - torch.stack([-c + s, -s - c], dim=-1)).contiguous(), torch.stack(
        [c, s], dim=-1)


@pytest.mark.parametrize("b,n,w", [(1, 1024, 64), (4, 256, 64), (1, 300, 256), (1, 100, 1024),
                                   (1, 300, 513), (3, 200, 300), (2, 77, 257)])
@pytest.mark.parametrize("aa", [False, True])
def test_wireframe_eye_clustered_swarm_and_segments(cuda, b, n, w, aa):
    # U(-8, 8): near sprites over many pixels, which the warp walks
    # together; rows wider than 256 pixels are cut into segments
    shape = (b, n, 2) if b > 1 else (n, 2)
    pos = _uniform(shape, -8, 8, n + w, cuda)
    dirs = camera.unit_heading(_uniform(shape, -1, 1, n + w + 1, cuda))
    cfg = VisionConfig(width=w, antialias=aa, sprite_mode="wireframe")
    _hold_wireframe_exact(pos, dirs, pos, dirs, cfg)


@pytest.mark.parametrize("kind", ["near_plane", "edge_on"])
@pytest.mark.parametrize("w", [64, 512, 1024])
@pytest.mark.parametrize("aa", [False, True])
def test_wireframe_eye_adversarial_sprites(cuda, kind, w, aa):
    eye, d, tgt, hdg = _wf_frame(kind, 8, 300, w, cuda, seed=w)
    _hold_wireframe_exact(eye, d, tgt, hdg,
                          VisionConfig(width=w, antialias=aa, sprite_mode="wireframe"))


@pytest.mark.parametrize("nt", [4096, 5000])
@pytest.mark.parametrize("aa", [False, True])
def test_wireframe_eye_many_targets_cross_form(cuda, nt, aa):
    # eyes against another, larger target set (a ring hop's cross form)
    eyes = _uniform((2, 96, 2), -100, 100, nt, cuda)
    dirs = camera.unit_heading(_uniform((2, 96, 2), -1, 1, nt + 1, cuda))
    tgt = _uniform((2, nt, 2), -100, 100, nt + 2, cuda)
    hdg = camera.unit_heading(_uniform((2, nt, 2), -1, 1, nt + 3, cuda))
    _hold_wireframe_exact(eyes, dirs, tgt, hdg,
                          VisionConfig(width=128, antialias=aa, sprite_mode="wireframe"))


def _boids_plan_of_card(batch, n, sms):
    out = (ctypes.c_int * 5)()
    common.kernel_library().call("nbt_boids_plan", batch, n, sms, ctypes.addressof(out))
    return tuple(out)


def test_boids_plan_matches_the_kernels(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for count in (sms, 132, 16):
        for batch in (1, 5, 64):
            for n in (1, 63, 64, 100, 333, 4096, 4097, 8193, 16385, 65536):
                assert _boids_plan_of_card(batch, n, count) == boids_ops.boids_plan(
                    batch, n, count)


# each N where the plan changes T, R or S on an H100, and the N before it
@pytest.mark.parametrize("n", [1, 2, 63, 64, 127, 128, 255, 256, 511, 512, 2048, 2049, 4095, 4096,
                               4097, 8192, 8193, 16384, 16385])
@pytest.mark.parametrize("glob", [False, True])
def test_boids_kernel_at_the_plan_boundaries(cuda, n, glob):
    half = 20 if n < 1024 else 100
    pos = _uniform((n, 2), -half, half, n + 5, cuda)
    vel = _uniform((n, 2), -1, 1, n + 6, cuda)
    got = boids_ops.boids_velocity_tiled(pos, vel, BoidsConfig(global_alignment=glob))
    _close(got, boids_ops.boids_velocity_plain(pos, vel, BoidsConfig()), 3e-5, 1e-6)


@pytest.mark.parametrize("shape", [(4096, 2), (5, 333, 2), (64, 256, 2), (65536, 2)])
def test_boids_kernel_repeats_bit_for_bit(cuda, shape):
    # the cluster's leader adds the partials in rank order. At N=65,536 each
    # cohesion sum runs over thousands of positions and cancels where the
    # mean is near 0, so the summation order alone moves such elements past
    # atol 1e-6 (by up to 1.8e-6 on the H100): there the error is held,
    # normalised by max |want|, to the ring boids' bound against one device
    # (chip_smoke.py's RING_BOIDS_BOUND)
    pos = _uniform(shape, -20 if shape[0] < 65536 else -100, 20 if shape[0] < 65536 else 100,
                   10, cuda)
    vel = _uniform(shape, -1, 1, 11, cuda)
    cfg = BoidsConfig()
    first = boids_ops.boids_velocity_tiled(pos, vel, cfg)
    want = boids_ops.boids_velocity_plain(pos, vel, cfg)
    if shape[0] < 65536:
        _close(first, want, 3e-5, 1e-6)
    else:
        torch.cuda.synchronize()
        assert ((first - want).abs().max() / want.abs().max()).item() < 1e-5
    for _ in range(5):
        assert torch.equal(boids_ops.boids_velocity_tiled(pos, vel, cfg), first)


# -- the gravity VJP's and the boids partials' plans and split sums ----------


def _vjp_plan_of_card(batch, n, m, sms):
    out = (ctypes.c_int * 5)()
    common.kernel_library().call("nbt_gravity_vjp_plan", batch, n, m, sms, ctypes.addressof(out))
    return tuple(out)


def _partials_plan_of_card(batch, n, m, sms):
    out = (ctypes.c_int * 5)()
    common.kernel_library().call("nbt_boids_partials_plan", batch, n, m, sms,
                                 ctypes.addressof(out))
    return tuple(out)


def test_vjp_and_partials_plans_match_the_kernels(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for count in (sms, 132, 16):
        for batch in (1, 3, 2048, 4096):
            for n, m in ((1, 1), (2, 2), (77, 300), (128, 128), (300, 77), (1024, 1024),
                         (4097, 4097), (16384, 16384), (65537, 65537)):
                assert _vjp_plan_of_card(batch, n, m, count) == pairwise.gravity_vjp_plan(
                    batch, n, m, count)
                assert _partials_plan_of_card(batch, n, m, count) == (
                    boids_ops.boids_partials_plan(batch, n, m, count))


# each N where the VJP's plan (batch 1, self form) changes T, R or S on an
# H100, and the N before it; and config 4's N=65,536
@pytest.mark.parametrize("n", [1, 2, 63, 64, 127, 128, 255, 256, 4096, 4097, 8192, 8193, 16384,
                               16385, 33280, 33281, 65536])
def test_gravity_vjp_kernel_at_the_plan_boundaries(cuda, n):
    # up to N=4,097 the scaled bound of test_gravity_vjp_kernel_matches_plain;
    # beyond, against float64 with chip_smoke.py phase 3's N * 2^-24 (a
    # worst-case sequential fp32 sum of N terms)
    pos = _uniform((n, 2), -100, 100, n + 12, cuda)
    u = torch.randn((n, 2), generator=torch.Generator(device=cuda).manual_seed(n), device=cuda)
    cfg = GravityConfig()
    got = pairwise.gravity_vjp_tiled(pos, u, cfg)
    if n == 1:
        torch.cuda.synchronize()
        assert torch.equal(got, torch.zeros_like(got))
    elif n <= 4097:
        _scaled_close(got, pairwise.gravity_vjp_plain(pos, u, cfg), 3e-5)
    else:
        _scaled_close(got.double(), pairwise.gravity_vjp_plain(pos.double(), u.double(), cfg),
                      n * 2.0 ** -24)


@pytest.mark.parametrize("b,n", [(4096, 1), (2048, 128), (2048, 33), (4096, 256)])
def test_gravity_vjp_kernel_batched_shards(cuda, b, n):
    """The trainers' width, the 2 x 2 mesh's shards (128-thread blocks now)
    and a batch of single bodies, whose self-pairs give exactly 0."""
    pos = _uniform((b, n, 2), -100, 100, n + 13, cuda)
    u = torch.randn((b, n, 2), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    cfg = GravityConfig()
    got = pairwise.gravity_vjp_tiled(pos, u, cfg)
    if n == 1:
        torch.cuda.synchronize()
        assert torch.equal(got, torch.zeros_like(got))
    else:
        _scaled_close(got, pairwise.gravity_vjp_plain(pos, u, cfg), 3e-5)


@pytest.mark.parametrize("b,n,m", [(2048, 128, 128), (1, 16384, 16384), (1, 4097, 33),
                                   (1, 33, 4097)])
def test_gravity_vjp_cross_kernel_at_the_path_shapes(cuda, b, n, m):
    # the 2 x 2 mesh's hop, a ring hop at config 4 on 4 shards, and a split
    # launch beside an unsplit one; both outputs against float64 under
    # test_gravity_vjp_cross_kernel_matches_float64's bound
    lead = (b,) if b > 1 else ()
    pos_i = _uniform(lead + (n, 2), -100, 100, n + 1, cuda)
    pos_j = _uniform(lead + (m, 2), -100, 100, m + 2, cuda)
    u = torch.randn(lead + (n, 2), generator=torch.Generator(device=cuda).manual_seed(4),
                    device=cuda)
    cfg = GravityConfig()
    got = pairwise.gravity_vjp_cross_tiled(pos_i, pos_j, u, cfg)
    want = pairwise.gravity_vjp_cross_plain(pos_i.double(), pos_j.double(), u.double(), cfg)
    for g, x in zip(got, want):
        _scaled_close(g.double(), x, 3e-5)


def test_gravity_vjp_cross_kernel_far_sentinels(cuda):
    """A j block padded with the ring's far sentinels (1e17): 1/d2 = 1e-34,
    its square underflows to 0, so the rows move by no more than the bound
    and the sentinels' own column gradients are finite and below 1e-30."""
    pos = _uniform((100, 2), -100, 100, 14, cuda)
    u = torch.randn((100, 2), generator=torch.Generator(device=cuda).manual_seed(5), device=cuda)
    pad = torch.full((28, 2), 1e17, device=cuda)
    cfg = GravityConfig()
    d_i, d_j = pairwise.gravity_vjp_cross_tiled(pos, torch.cat([pos, pad]), u, cfg)
    want_i, _ = pairwise.gravity_vjp_cross_tiled(pos, pos, u, cfg)
    _scaled_close(d_i, want_i, 3e-5)
    assert torch.isfinite(d_j).all() and d_j[100:].abs().max().item() < 1e-30


# each N where the partials' plan (batch 1, n = m) changes T, R or S on an
# H100, and the N before it
@pytest.mark.parametrize("n", [1, 2, 63, 64, 127, 128, 255, 256, 511, 512, 2048, 2049, 4095, 4096,
                               8192, 8193, 16384, 16385])
@pytest.mark.parametrize("exclude_diagonal", [True, False])
def test_boids_partials_kernel_at_the_plan_boundaries(cuda, n, exclude_diagonal):
    # counts exact; the sums (the alignment sum runs over every agent and
    # cancels) normalised by their largest under chip_smoke.py phase 3's
    # N * 2^-24 (a worst-case sequential fp32 sum of N terms)
    half = 20 if n < 1024 else 100
    pos = _uniform((n, 2), -half, half, n + 15, cuda)
    vel = _uniform((n, 2), -1, 1, n + 16, cuda)
    cfg = BoidsConfig()
    got = boids_ops.boids_partials_tiled(pos, vel, pos, vel, cfg, exclude_diagonal)
    want = boids_ops.boids_partials_plain(pos, vel, pos, vel, cfg, exclude_diagonal)
    torch.cuda.synchronize()
    for k, (g, x) in enumerate(zip(got, want)):
        if k in (1, 4) or not x.any():  # the counts; the sums of one agent with itself masked
            assert torch.equal(g, x)
        else:
            _scaled_close(g, x, n * 2.0 ** -24)


@pytest.mark.parametrize("shape_i,shape_j", [((1024, 2), (1024, 2)), ((16384, 2), (16384, 2)),
                                             ((64, 512, 2), (64, 1536, 2))])
def test_vjp_and_partials_repeat_bit_for_bit(cuda, shape_i, shape_j):
    # the cluster's leader adds the partials in rank order: 20 more launches
    # of each kernel (the VJP's self and cross forms) give the first one's bits
    pos_i = _uniform(shape_i, -20, 20, 16, cuda)
    vel_i = _uniform(shape_i, -1, 1, 17, cuda)
    pos_j = _uniform(shape_j, -20, 20, 18, cuda)
    vel_j = _uniform(shape_j, -1, 1, 19, cuda)
    u = torch.randn(shape_i, generator=torch.Generator(device=cuda).manual_seed(6), device=cuda)
    gcfg, bcfg = GravityConfig(), BoidsConfig()
    runs = (lambda: (pairwise.gravity_vjp_tiled(pos_i, u, gcfg),),
            lambda: pairwise.gravity_vjp_cross_tiled(pos_i, pos_j, u, gcfg),
            lambda: boids_ops.boids_partials_tiled(pos_i, vel_i, pos_j, vel_j, bcfg, False),
            lambda: boids_ops.boids_partials_tiled(pos_i, vel_i, pos_i, vel_i, bcfg, True))
    for run in runs:
        first = run()
        for _ in range(20):
            assert all(torch.equal(a, b) for a, b in zip(run(), first))


# -- the eye backward kernels' winner runs ------------------------------------
# Each case against the plain version at the backward kernels' tolerances
# (per-pixel terms round apart; target sums in atomic, run-to-run order:
# rtol 2e-4, atol 2e-4 of the largest component), one launch each.


def _cotangents(shape, w, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape[:-1] + (w,), generator=g, device=device),
            torch.randn(shape[:-1] + (w,), generator=g, device=device) * 1e-2)


def _hold_pullback(sprite, ep, ed, tp, th, cfg, albedo=None, texture=None, winner=None,
                   seed=2):
    """The backward kernel's gradients (one launch) against its plain
    version, from the forward's winner index or the one given (the
    wireframe's pullback is defined for any winner: it re-evaluates the
    given sprite at each pixel). Returns the winner index used."""
    us, ud = _cotangents(ep.shape, cfg.width, ep.device, seed)
    if sprite == "disc":
        _, _, win = raycast.disc_eye_with_winner(ep, ed, tp, cfg)
        common.reset_launch_counts()
        got = raycast.render_rows_vjp_cross(ep, ed, win, us, ud, cfg, targets=tp)
        assert common.launch_counts()["disc_eye_bwd"] == 1
        want = raycast.render_rows_vjp_cross_plain(ep, ed, us, ud, cfg, targets=tp)
    else:
        win = winner
        if win is None:
            _, _, win = wireframe.wireframe_eye_with_winner(ep, ed, tp, th, cfg, albedo, texture)
        common.reset_launch_counts()
        got = wireframe.wireframe_eye_vjp(ep, ed, tp, th, win, us, ud, cfg, albedo, texture)
        assert common.launch_counts()["wireframe_eye_bwd"] == 1
        want = wireframe.winner_pullback(ep, ed, tp, th, win, us, ud, cfg, albedo, texture)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, x in zip(got, want):
        assert torch.isfinite(g).all() and x.abs().max() > 0
        torch.testing.assert_close(g, x, rtol=2e-4, atol=2e-4 * x.abs().max().item())
    return win


def _near_sprites(b, w, device, seed, dist=(4.0,)):
    """Eyes at random places and headings, each with sprites of radius 4
    `dist` ahead of it turned away from it (their two front edges, clipped
    by the near plane, span u in about [-3.5, 3.5]: each covers the whole
    row), behind them spread targets they occlude. Returns (eye_pos,
    eye_dir, tgt, hdg [b, m, 2]), eyes the first entry of each env."""
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=g, device=device)
    eye = rand(b, 1, 2) * 100 - 50
    d = camera.unit_heading(rand(b, 1, 2) * 2 - 1)
    near = torch.stack([eye + k * d for k in dist], dim=1)[:, :, 0]
    far = eye + (rand(b, 30, 1) * 40 + 20) * d + (rand(b, 30, 1) * 20 - 10) * torch.stack(
        [d[..., 1], -d[..., 0]], dim=-1)
    tgt = torch.cat([eye, near, far], dim=1).contiguous()
    hdg = torch.cat([d, d.expand(-1, len(dist), -1), camera.unit_heading(rand(b, 30, 2) - 0.5)],
                    dim=1).contiguous()
    return eye.contiguous(), d.contiguous(), tgt, hdg


@pytest.mark.parametrize("aa", [False, True])
def test_wireframe_eye_bwd_one_sprite_wins_a_whole_row(cuda, aa):
    eye, d, tgt, hdg = _near_sprites(3, 1024, cuda, seed=5)
    cfg = VisionConfig(width=1024, antialias=aa, sprite_mode="wireframe", sprite_radius=4.0)
    win = _hold_pullback("wireframe", eye, d, tgt, hdg, cfg)
    assert (win == 1).all()  # the near sprite wins all 1,024 pixels of each row


@pytest.mark.parametrize("aa", [False, True])
def test_wireframe_eye_bwd_alternating_winners(cuda, aa):
    # two near sprites that each cover the whole row, credited with every
    # other pixel: runs of one lane
    eye, d, tgt, hdg = _near_sprites(3, 256, cuda, seed=6, dist=(4.0, 4.5))
    cfg = VisionConfig(width=256, antialias=aa, sprite_mode="wireframe", sprite_radius=4.0)
    p = torch.arange(256, device=cuda)
    win = torch.where(p % 2 == 0, 1, 2).to(torch.int32).expand(3, 1, 256).contiguous()
    _hold_pullback("wireframe", eye, d, tgt, hdg, cfg, winner=win)


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
@pytest.mark.parametrize("aa", [False, True])
def test_eye_bwd_ring_hop_with_background(cuda, sprite, aa):
    # a hop's eyes against another block's targets: -1 where none covers
    pos = _uniform((4, 128, 2), -40, 40, 7, cuda)
    dirs = camera.unit_heading(_uniform((4, 128, 2), -1, 1, 8, cuda))
    cfg = VisionConfig(width=64, antialias=aa, sprite_mode=sprite, far=200.0)
    blk = lambda x, k: x[:, 32 * k:32 * (k + 1)].contiguous()
    win = _hold_pullback(sprite, blk(pos, 0), blk(dirs, 0), blk(pos, 2), blk(dirs, 2), cfg)
    assert (win < 0).any() and (win >= 0).any()


@pytest.mark.parametrize("w", [17, 50, 1000])
@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
@pytest.mark.parametrize("aa", [False, True])
def test_eye_bwd_widths_off_the_warp(cuda, w, sprite, aa):
    # widths that are no multiple of 4 (the disc's 4-byte tail) or of 32
    # (rounds and chunks that straddle rows)
    b, n = (3, 40) if w < 1000 else (1, 60)
    pos = _uniform((b, n, 2), -40, 40, w, cuda)
    dirs = camera.unit_heading(_uniform((b, n, 2), -1, 1, w + 1, cuda))
    cfg = VisionConfig(width=w, antialias=aa, sprite_mode=sprite, far=200.0)
    _hold_pullback(sprite, pos, dirs, pos, dirs, cfg)


@pytest.mark.parametrize("w", [17, 64])
@pytest.mark.parametrize("aa", [False, True])
def test_disc_eye_bwd_unaligned_arrays(cuda, w, aa):
    # the winner and cotangents one element into their storage: not 16-byte
    # aligned, so every lane reads its 4 pixels with 4-byte loads
    pos = _uniform((3, 40, 2), -40, 40, w, cuda)
    dirs = camera.unit_heading(_uniform((3, 40, 2), -1, 1, w + 1, cuda))
    cfg = VisionConfig(width=w, antialias=aa, far=200.0)
    us, ud = _cotangents(pos.shape, w, cuda, 2)
    _, _, win = raycast.disc_eye_with_winner(pos, dirs, pos, cfg)
    shifted = lambda x: torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
    us_s, ud_s, win_s = shifted(us), shifted(ud), shifted(win)
    assert all(x.data_ptr() % 16 != 0 and x.is_contiguous() for x in (us_s, ud_s, win_s))
    common.reset_launch_counts()
    got = raycast.render_rows_vjp_cross(pos, dirs, win_s, us_s, ud_s, cfg)
    assert common.launch_counts()["disc_eye_bwd"] == 1
    want = raycast.render_rows_vjp_cross_plain(pos, dirs, us, ud, cfg)
    for g, x in zip(got, want):
        assert torch.isfinite(g).all() and x.abs().max() > 0
        torch.testing.assert_close(g, x, rtol=2e-4, atol=2e-4 * x.abs().max().item())


@pytest.mark.parametrize("b,n,w", [(1, 1024, 64), (4, 256, 64), (1, 100, 1024)])
@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
@pytest.mark.parametrize("aa", [False, True])
def test_eye_bwd_clustered_swarm(cuda, b, n, w, sprite, aa):
    # U(-8, 8): near sprites over many pixels, long runs of one winner
    shape = (b, n, 2) if b > 1 else (n, 2)
    pos = _uniform(shape, -8, 8, n + w, cuda)
    dirs = camera.unit_heading(_uniform(shape, -1, 1, n + w + 1, cuda))
    cfg = VisionConfig(width=w, antialias=aa, sprite_mode=sprite)
    _hold_pullback(sprite, pos, dirs, pos, dirs, cfg)


@pytest.mark.parametrize("form,tex", [("albedo", None), ("texture", "staged"),
                                      ("albedo+texture", "global")])
@pytest.mark.parametrize("aa", [False, True])
def test_wireframe_eye_bwd_appearance_in_runs(cuda, form, tex, aa):
    # the near sprite over whole rows and a clustered swarm: long runs of
    # one winner, and of lanes that read the same texels
    eye, d, tgt, hdg = _near_sprites(3, 256, cuda, seed=9)
    near = VisionConfig(width=256, antialias=aa, sprite_mode="wireframe", sprite_radius=4.0)
    albedo, texture = _appearance(form, tex, (3,), tgt.shape[1], cuda)
    _hold_pullback("wireframe", eye, d, tgt, hdg, near, albedo, texture)
    pos = _uniform((2, 200, 2), -8, 8, 10, cuda)
    dirs = camera.unit_heading(_uniform((2, 200, 2), -1, 1, 11, cuda))
    albedo, texture = _appearance(form, tex, (2,), 200, cuda)
    cfg = VisionConfig(width=128, antialias=aa, sprite_mode="wireframe")
    _hold_pullback("wireframe", pos, dirs, pos, dirs, cfg, albedo, texture)


@pytest.mark.parametrize("sprite_mode", ["disc", "wireframe"])
def test_exported_step_equals_the_live_step(cuda, sprite_mode):
    """The `.pt2` program (utils/export.py) on the card at config 2 (N=1,024,
    64 px), its kernels launched through the custom ops (ops/library.py),
    against the live closed-loop step through the wrappers directly: bit
    for bit, one launch of gravity and of the eye per step."""
    from nenbody_tpu_torch.rl.env import VisionEnv
    from nenbody_tpu_torch.rl.policy import init_mlp_policy
    from nenbody_tpu_torch.state import SceneState, spawn
    from nenbody_tpu_torch.utils import export as export_lib

    env = VisionEnv(SimConfig(n=1024, controller="gravity",
                              vision=VisionConfig(width=64, sprite_mode=sprite_mode)))
    policy = init_mlp_policy(env.obs_width, 0).to(cuda)
    step = export_lib.load_policy_step(export_lib.export_policy_step(env, policy))
    st = spawn(env.cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    eye = "wireframe_eye" if sprite_mode == "wireframe" else "disc_eye"
    common.reset_launch_counts()
    got = step(st.pos, st.vel)
    torch.cuda.synchronize()
    counts = common.launch_counts()
    assert counts["gravity"] == 1 and counts[eye] == 1
    with torch.no_grad():
        state = SceneState(pos=st.pos, vel=st.vel, t=st.t)
        action, _ = policy(env.observe(state))
        nxt = env.dynamics(state, action)
    for g, w in zip(got, (nxt.pos, nxt.vel, action)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("sprite,w,aa", [("disc", 512, False), ("disc", 480, True),
                                         ("wireframe", 1024, True), ("wireframe", 480, False)])
@pytest.mark.parametrize("form", ["bare", "colors", "texture"])
def test_render_eye_view_launches_the_eye_kernel(cuda, sprite, w, aa, form):
    """Scene.render_eye_row/render_eye_view on the card: one launch of the
    sprite's eye kernel a channel, against the plain render_single_row on
    the card: equal at a power-of-two width, else within the eye's
    tolerances (ROADMAP queue 3, pixel centres on the card), hits equal."""
    n = 300
    cfg = SimConfig(n=n, controller="gravity",
                    vision=VisionConfig(width=64, sprite_mode=sprite, antialias=aa))
    scene = Scene(cfg, device=cuda)
    st = scene.spawn(seed=3)
    colors = render.default_agent_colors(n, cuda) if form == "colors" else None
    texture = render.checker_texture(16, 4, device=cuda) if form == "texture" else None
    common.reset_launch_counts()
    shade, depth = scene.render_eye_row(st, 7, w, colors, texture)
    kernel = "wireframe_eye" if sprite == "wireframe" else "disc_eye"
    counts = common.launch_counts()
    assert counts[kernel] == (3 if form == "colors" else 1)
    assert sum(counts.values()) == counts[kernel]
    vcfg = dataclasses.replace(cfg.vision, width=w)
    chans = []
    for c in range(3 if form == "colors" else 1):
        ccfg = (dataclasses.replace(vcfg, background=render.BACKGROUND_RGB[c])
                if form == "colors" else vcfg)
        s, d = render.render_single_row(st.pos, st.vel, 7, ccfg,
                                        None if colors is None else colors[:, c].contiguous(),
                                        texture)
        chans.append(s)
    want = (torch.stack(chans, -1) if form == "colors" else chans[0], d)
    torch.cuda.synchronize()
    assert torch.equal(depth < vcfg.far, want[1] < vcfg.far)
    if w & (w - 1) == 0 and form != "texture":
        assert torch.equal(depth, want[1]) and torch.equal(shade, want[0])
    # the shade: the wireframe's 2e-4, the texture's 3e-4 (its texel picks
    # are threshold tests), the disc's 1e-5, 1e-4 with AA (coverage moves
    # with the pixel centre: ROADMAP queue 3)
    tol = 2e-4 if sprite == "wireframe" else (3e-4 if form == "texture" else
                                               1e-4 if aa else 1e-5)
    _close(depth, want[1], 1e-5, 1e-4 if sprite == "disc" else 2e-4)
    _close(shade, want[0], 1e-5, tol)
    img = scene.render_eye_view(st, 7, size=(96, w), colors=colors, texture=texture)
    assert img.shape == (96, w, 3) and img.dtype.name == "uint8"


@pytest.mark.parametrize("n", [512, 4096])
def test_scene_cells_matches_the_boids_kernel(cuda, n):
    """Scene(backend="cells") on the card at a capacity cells_stats sizes,
    against backend="pallas" (boids.cu), a few steps, within the smoke's
    RING_BOIDS_BOUND scaled error (err / max|pallas| < 1e-5); the cell list
    launches no kernel."""
    from nenbody_tpu_torch.physics import cells

    cfg = SimConfig(n=n, controller="boids", backend="pallas")
    kernel = Scene(cfg, device=cuda)
    st = kernel.spawn(seed=1)
    states = [st]
    for _ in range(3):
        states.append(kernel.step(states[-1]))
    r = math.sqrt(cfg.boids.cohesion_dist_sq)
    cap = max(cells.cells_stats(s.pos, r)["max_occupancy"] for s in states)
    cells_scene = Scene(dataclasses.replace(cfg, backend="cells", boids=dataclasses.replace(
        cfg.boids, cells_capacity=cap)), device=cuda)
    for s, want in zip(states[:-1], states[1:]):
        common.reset_launch_counts()
        got = cells_scene.step(s)
        assert sum(common.launch_counts().values()) == 0
        for a, b in ((got.pos, want.pos), (got.vel, want.vel)):
            torch.cuda.synchronize()
            err = float((a.double() - b.double()).abs().max() / b.double().abs().max())
            assert err < 1e-5, err
