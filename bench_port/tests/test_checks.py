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
