"""`correct` at the CPU sizes of tiny.py: true for the program as it is,
false for its control (the reference one precision lower in its place)
and false for each fault a cell can have (faults.py), the whole run driven
as on the chip but for the look for a card."""

from __future__ import annotations

import pytest

from bench_port.lib import harness
from bench_port.tests import faults, rank_worker, tiny

ONE_CARD = {"c5-rollout": ("state_unchanged", "half_batch", "altered_answer"),
            "c5-train-apg-dv": ("state_unchanged", "half_batch", "eye_bwd_zeroed")}
ACROSS = {"c5x4-train-apg-dv": ("state_unchanged", "half_batch", "no_exchange",
                                "grads_not_summed")}


def _run(cell: str, fault: str = "none", seed: int = 5, control: bool = False,
         trace: bool = False):
    ctx = tiny.context(cell, seed, trace=trace, control=control)
    with faults.planted(fault):
        out = harness.run_cell(ctx)
    return ctx, out


@pytest.mark.parametrize("cell", sorted(ONE_CARD))
def test_sound_run_is_correct_and_control_is_not(cell):
    ctx, out = _run(cell, control=True)
    line = harness.result_line(ctx, out)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == set(ctx.limits)
    control = harness.Outcome(0, {}, out.controls, 0, 0, 0)
    assert not harness.verdict(ctx, control), out.controls


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in ONE_CARD.items() for f in fs])
def test_fault_is_caught(cell, fault):
    ctx, out = _run(cell, fault)
    assert not harness.verdict(ctx, out), (fault, out.checks)


@pytest.mark.parametrize("cell", sorted(ONE_CARD))
def test_traced_run_reads_its_metrics(cell):
    ctx, out = _run(cell, trace=True, seed=8)
    line = harness.result_line(ctx, out)
    assert line["correct"] and line["device"]["window_s"] > 0
    assert "breakdown" in line and line["metrics"]


def _across(cell, fault):
    ctx = tiny.context(cell, 5, seconds=0.5)
    ctx.ranks = rank_worker.start(cell, 5, 0.5, False, fault, ctx.traffic["processes"])
    with faults.planted("none" if fault == "forbidden_module" else fault):
        out = harness.run_cell(ctx)
    return ctx, out


@pytest.mark.parametrize("cell", sorted(ACROSS))
def test_across_processes_sound(cell):
    ctx, out = _across(cell, "none")
    assert harness.verdict(ctx, out), out.checks
    assert out.attempted > 0 and out.loaded == []


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in ACROSS.items() for f in fs])
def test_across_processes_fault_is_caught(cell, fault):
    ctx, out = _across(cell, fault)
    assert not harness.verdict(ctx, out), (fault, out.checks)


@pytest.mark.parametrize("cell", sorted(ACROSS))
def test_a_forbidden_module_on_another_rank_is_reported(cell):
    """Rank 1 holds a module named jax once the window has closed: rank 0
    reports it, and run.py then prints no result."""
    _, out = _across(cell, "forbidden_module")
    assert "rank 1: jax" in out.loaded and "rank 1: jax" in harness.forbidden(out)


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_eye_pullback_fault_zeroes_either_eyes_gradient(sprite):
    """eye_bwd_zeroed plants zeros in the pullback of whichever eye the
    env's differentiable observation routes through."""
    import torch

    from nenbody_tpu_torch.rl.env import VisionEnv

    from bench_port.lib import program

    cfg = tiny.context("c5-train-apg-dv").config
    cfg = {**cfg, "vision": {**cfg["vision"], "sprite_mode": sprite}}
    env = VisionEnv(program.sim_config(cfg, antialias=True), max_accel=cfg["env"]["max_accel"])
    gen = torch.Generator().manual_seed(4)
    pos = (torch.rand((2, cfg["n"], 2), generator=gen) * 2 - 1) * 6.0
    vel = torch.rand((2, cfg["n"], 2), generator=gen) * 2 - 1
    weights = torch.randn((2, cfg["n"], env.obs_width), generator=gen)

    def grads():
        p, v = pos.clone().requires_grad_(), vel.clone().requires_grad_()
        (env.observe(program.state(p, v)) * weights).sum().backward()
        return p.grad, v.grad

    assert all(bool(g.any()) for g in grads())
    with faults.planted("eye_bwd_zeroed"):
        zeroed = grads()
    # the velocity's own columns of the observation still pull back
    assert not zeroed[0].any()
    assert torch.equal(zeroed[1], weights[..., -2:])
