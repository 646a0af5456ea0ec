"""The plain reference agrees with the port's CPU path (its plain
versions) at tiny sizes, and the work counts agree with hand counts."""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from bench_port.lib import inputs
from bench_port.reference import apg as apg_ref
from bench_port.reference import compare, eyes
from bench_port.reference import disc_eye as eye_ref
from bench_port.reference import policy as policy_ref
from bench_port.reference import world
from bench_port.work import disc_eye, disc_eye_bwd, gravity, gravity_vjp, mlp, peaks


def _swarm(seed, b, n, half=20.0):
    g = torch.Generator().manual_seed(seed)
    pos = (torch.rand((b, n, 2), generator=g) * 2 - 1) * half
    vel = torch.rand((b, n, 2), generator=g) * 2 - 1
    return pos, vel


@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eye_lines_equal_the_port(aa, seed):
    from nenbody_tpu_torch.config import VisionConfig
    from nenbody_tpu_torch.vision import render

    pos, vel = _swarm(seed, 3, 24)
    vc = VisionConfig(width=32, antialias=aa)
    want_s, want_d = render.render_rows(pos, vel, vc)
    got_s, got_d = eye_ref.lines(pos, vel, eye_ref.Eye(width=32, antialias=aa))
    assert torch.equal(got_s, want_s) and torch.equal(got_d, want_d)


def test_eye_gradient_equals_autograd_through_the_port():
    from nenbody_tpu_torch.config import VisionConfig
    from nenbody_tpu_torch.vision import render

    pos, vel = _swarm(3, 2, 16, half=8.0)
    vc = VisionConfig(width=16, antialias=True)
    w = torch.randn(2, 16, 16, generator=torch.Generator().manual_seed(9))
    grads = []
    for fn in (lambda p, v: render.render_rows(p, v, vc),
               lambda p, v: eye_ref.lines(p, v, eye_ref.Eye(width=16, antialias=True))):
        p, v = pos.clone().requires_grad_(), vel.clone().requires_grad_()
        s, d = fn(p, v)
        ((s * w).sum() + 1e-3 * (d * w).sum()).backward()
        grads.append((p.grad, v.grad))
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(grads[1][1], grads[0][1], rtol=1e-5, atol=1e-6)


def test_gravity_and_step_equal_the_port():
    from nenbody_tpu_torch.config import SimConfig
    from nenbody_tpu_torch.physics import dense
    from nenbody_tpu_torch.state import SceneState

    pos, vel = _swarm(4, 2, 40, half=100.0)
    cfg = SimConfig(n=40, controller="gravity", backend="dense")
    want = dense.gravity_step(SceneState(pos, vel, torch.zeros(2, dtype=torch.int32)), cfg)
    gc = cfg.gravity
    f = world.gravity(pos, gc.g, gc.bias)
    rows = torch.tensor([3, 7, 31])
    torch.testing.assert_close(world.gravity(pos, gc.g, gc.bias, rows=rows), f[:, rows])
    p2, v2 = world.integrate(pos, vel, f, None, gc.dt, None, gc.dt_on_position)
    assert torch.equal(p2, want.pos) and torch.equal(v2, want.vel)


def test_policy_equals_the_port():
    from nenbody_tpu_torch.rl.policy import MLPPolicy

    params = inputs.mlp_params(18, (128, 128), 2, 11, "cpu")
    pol = inputs.load_policy(MLPPolicy(18), params)
    obs = torch.rand(3, 5, 18, generator=torch.Generator().manual_seed(1))
    assert torch.equal(policy_ref.mean_action(params, obs), pol(obs)[0])
    low = policy_ref.mean_action(params, obs, lower=True)
    assert not torch.equal(low, pol(obs)[0])


def test_spawns_are_the_ports_draws():
    from nenbody_tpu_torch.config import SimConfig
    from nenbody_tpu_torch.state import spawn_batch

    cfg = SimConfig(n=8)
    want = spawn_batch(cfg, torch.Generator().manual_seed(5), 3, "cpu")
    got = world.spawn(torch.Generator().manual_seed(5), (3, 8, 2), cfg.spawn_pos_range,
                      cfg.spawn_vel_range, "cpu")
    assert torch.equal(got[0], want.pos) and torch.equal(got[1], want.vel)


def test_apg_reference_blocks_sum_to_the_whole():
    """The env blocks' losses and gradients add up to one block's: the
    gradients up to the bfloat16 rounding of each block's weight gradient
    (the hidden layers' GEMMs round their outputs to bfloat16)."""
    cfg = {"n": 8, "num_envs": 4, "vision": {"width": 8},
           "gravity": {"g": 1e-3, "bias": 1e-7, "dt": 0.1, "dt_on_position": False},
           "env": {"max_accel": 0.05}, "policy": {"hidden_dtype": "bfloat16"}}
    job = {"antialias": True, "horizon": 2, "lr": 1e-3}
    params = inputs.mlp_params(10, (128, 128), 2, 3, "cpu")
    pos, vel = _swarm(6, 4, 8, half=6.0)
    whole = apg_ref.gradient(apg_ref.leaves(params), pos, vel, 4, cfg, job)
    saved = apg_ref.BLOCK_PAIRS
    apg_ref.BLOCK_PAIRS = 64  # one env a block
    try:
        split = apg_ref.gradient(apg_ref.leaves(params), pos, vel, 4, cfg, job)
    finally:
        apg_ref.BLOCK_PAIRS = saved
    assert abs(whole[0] - split[0]) <= 1e-6 * abs(whole[0])
    for k in whole[1]:
        a, b = (torch.linalg.vector_norm(g[1][k]) for g in (split, whole))
        assert abs(a - b) <= 1e-2 * b, k


def test_work_counts_by_hand():
    assert gravity.work(2, 3) == {"fp32_ops": 2 * 9 * 11, "bytes": 2 * 2 * 3 * 8}
    assert disc_eye.work(1, 2, 4, 5) == {"fp32_ops": 4 * 16 + 5 * 6,
                                         "bytes": 2 * 2 * 8 + 2 * 2 * 4 * 4}
    # the pullback reads positions, headings (2 x 2 agents x 8 bytes), the
    # int32 winners and both cotangent lines (3 x 2 x 4 pixels x 4 bytes)
    # and writes three gradients (3 x 2 x 8 bytes)
    assert disc_eye_bwd.work(1, 2, 4, 5) == {"fp32_ops": 5 * 60,
                                             "bytes": 2 * 2 * 8 + 3 * 2 * 4 * 4 + 3 * 2 * 8}
    assert gravity_vjp.work(2, 3) == {"fp32_ops": 2 * 9 * 25, "bytes": 3 * 2 * 3 * 8}
    m = mlp.work(10, 4, (8, 8), 2)
    assert m["bf16_flops"] == 10 * 2 * (4 * 8 + 8 * 8) and m["fp32_ops"] == 10 * 2 * 8 * 2
    assert peaks.least_seconds(fp32_ops=67e12) == pytest.approx(1.0)
    assert peaks.least_seconds(bytes_moved=3.35e12, fp32_ops=1.0) == pytest.approx(1.0)
    # a number of renders from the reference's stats summed over them
    assert disc_eye.renders(1, 2, 4, 3, {"covered": 5, "won": 2}) == {
        "fp32_ops": 3 * 4 * 16 + 5 * 6, "bytes": 3 * (2 * 2 * 8 + 2 * 2 * 4 * 4)}
    assert disc_eye_bwd.renders(1, 2, 4, 3, {"covered": 5, "won": 2}) == {
        "fp32_ops": 2 * 60, "bytes": 3 * disc_eye_bwd.work(1, 2, 4, 0)["bytes"]}


def test_covered_pixels_by_brute_force():
    """winners' count of covering (eye, target, pixel) triples against every
    triple tested."""
    pos, vel = _swarm(8, 2, 12, half=6.0)
    for aa in (False, True):
        e = eye_ref.Eye(width=16, antialias=aa)
        dirs = eye_ref.heading_of(vel)
        stats = {}
        eye_ref.winners(pos, dirs, e, stats=stats)
        rx = pos[:, None, :, 0] - pos[:, :, None, 0]
        ry = pos[:, None, :, 1] - pos[:, :, None, 1]
        u, du, _, vis = eye_ref.project(rx, ry, dirs[:, :, None, 0], dirs[:, :, None, 1], e)
        off = (eye_ref.pixel_centres(16, "cpu") - u[..., None]) / du.clamp(min=1e-30)[..., None]
        thr = 1.0 + (1.0 / 16) / du.clamp(min=1e-30)[..., None] if aa else 1.0
        assert stats["covered"] == int((vis[..., None] & (off.abs() < thr)).sum())
        assert stats["won"] == int((eye_ref.winners(pos, dirs, e) >= 0).sum())


def test_eye_dataclass_reads_the_config():
    e = eye_ref.Eye.of({"width": 64, "hfov_deg": 90.0, "sprite_mode": "disc"}, True)
    assert dataclasses.astuple(e)[:2] == (64, 90.0) and e.antialias


def test_training_comparisons_by_hand():
    g = {"w": torch.tensor([1.0, -2.0, 0.0, 3.0])}
    assert compare.sign_share(g, {"w": torch.tensor([2.0, -1.0, 1.0, -3.0])}, ["w"]) == 0.5
    assert math.isnan(compare.sign_share({"w": torch.tensor([float("nan")] * 4)}, g, ["w"]))
    p0 = {"w": torch.zeros(4)}
    stepped = apg_ref.adam_steps(p0, [g, g], lr=0.1)
    assert compare.update_gap(stepped, stepped, p0) == 0.0
    assert compare.update_gap(p0, stepped, p0) == 1.0  # a step left out
    flat = torch.arange(4.0)
    assert compare.replica_mismatch([flat, flat.clone(), flat.clone()]) == 0.0
    assert compare.replica_mismatch([flat, flat + torch.tensor([0, 0, 0, 1e-6])]) == 0.25


def test_the_eye_is_found_by_its_sprite_mode(tmp_path):
    from bench_port import work

    assert eyes.of({"width": 8, "sprite_mode": "disc"}) is eye_ref
    assert eyes.of({"width": 8}) is eye_ref  # the port's default sprite
    assert eyes.name({"sprite_mode": "disc"}) == "disc_eye"
    assert work.of("disc_eye") is disc_eye and work.of("disc_eye_bwd") is disc_eye_bwd
    with pytest.raises(FileNotFoundError, match="reference/cube_eye.py"):
        eyes.of({"width": 8, "sprite_mode": "cube"})
    with pytest.raises(FileNotFoundError, match="work/cube_eye.py"):
        work.of("cube_eye")
    with pytest.raises(ValueError):
        eyes.of({"width": 8, "sprite_mode": "../disc"})
