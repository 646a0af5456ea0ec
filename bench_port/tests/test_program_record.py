"""The per-layer metrics read from the program's own spans
(lib/program_record.py and its readers): a tiny traced run of each driver
on the CPU gives every such metric of its cell a number, the spans' device
times are their host times there, a trainer's phases add up to its
iteration, a traced run leaves the eye's counters off, and inside the
program's recording() the eye's counted triples equal the reference eye's
covered count on the traced states."""

from __future__ import annotations

import contextlib

import pytest
import torch

from bench_port.lib import harness, program_record
from bench_port.lib.cells import Bench
from bench_port.lib.trace import Tracer
from bench_port.reference import eyes
from bench_port.tests import rank_worker, tiny

torch.set_num_threads(1)  # the tiny windows: no thread pool oversubscribed beside other workers

BENCH = Bench()
READS_RECORD = {m["name"] for m in BENCH.spec["per_layer"]
                if m["source"] in ("program_span", "program_counter")}


@pytest.fixture(autouse=True)
def clean_record():
    from nenbody_tpu_torch.utils import profiling

    profiling.reset_record()
    yield profiling
    profiling.reset_record()


def _new_metrics(cell: str) -> set:
    return {m["name"] for m in BENCH.metrics_of(cell, "per_layer")} & READS_RECORD


def test_each_cell_has_metrics_of_the_record():
    assert _new_metrics("c5-rollout") == {"observe_ms.rollout", "policy_ms.rollout"}
    for cell in ("c5-train-apg-dv", "c5x4-train-apg-dv"):
        assert _new_metrics(cell) == {"apg_rollout_ms.train", "apg_backward_ms.train",
                                      "apg_update_ms.train"}


def test_an_empty_record_reads_none(clean_record):
    for name in READS_RECORD:
        assert BENCH.reader(name)([]) is None
    assert program_record.record() is None


def test_a_program_without_a_record_reads_none(monkeypatch):
    from nenbody_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "record")
    assert program_record.record() is None
    assert program_record.span_ms("env.step", "env.observe") is None


def test_traced_rollout_reads_its_metrics_and_the_eyes_counts(monkeypatch, clean_record):
    """The record is cleared, and the program's recording() opened, where
    the traced stretch opens, and closed where it stops, so that the eye
    counts the states drivers/rollout.py::_work counts covered pixels on."""
    begin, stop, inside = Tracer.begin, Tracer.stop, contextlib.ExitStack()

    def begin_afresh(self):
        clean_record.reset_record()
        inside.enter_context(clean_record.recording())
        begin(self)

    def stop_counting(self, *args):
        out = stop(self, *args)
        inside.close()
        return out

    covered = []
    eye_ref = eyes.of(BENCH.config(BENCH.cell("c5-rollout")["config"])["vision"])
    winners = eye_ref.winners

    def counting(pos, dirs, eye, dtype=None, stats=None):
        before = stats.get("covered", 0) if stats is not None else 0
        out = winners(pos, dirs, eye, **({} if dtype is None else {"dtype": dtype}),
                      stats=stats)
        if stats is not None:  # the render's own count: the driver sums them in one dict
            covered.append(stats["covered"] - before)
        return out

    monkeypatch.setattr(Tracer, "begin", begin_afresh)
    monkeypatch.setattr(Tracer, "stop", stop_counting)
    monkeypatch.setattr(eye_ref, "winners", counting)
    ctx = tiny.context("c5-rollout", seed=11, seconds=2.0, trace=True)
    out = harness.run_cell(ctx)
    line = harness.result_line(ctx, out)
    assert line["correct"], line["checks"]
    assert _new_metrics("c5-rollout") <= set(line["metrics"])
    rec = clean_record.record()
    steps, episode = rec["spans"]["env.step"], ctx.traffic["episode_steps"]
    assert steps["calls"] == episode and rec["spans"]["env.observe"]["calls"] == episode + 1
    assert len(covered) == episode + 1 and sum(covered) > 0
    assert rec["counters"]["eye.triples"] == sum(covered)
    for s in rec["spans"].values():  # on the CPU a span's device time is its host time
        assert s["device_ms"] == s["host_ms"]
    m, observe = line["metrics"], rec["spans"]["env.observe"]
    # the episode's first observation falls into its first step
    assert m["observe_ms.rollout"]["value"] == pytest.approx(observe["device_ms"] / episode)
    assert 0 < observe["device_ms"] / observe["calls"] <= steps["device_ms"] / steps["calls"]
    assert rec["counters"]["eye.pixels"] == (episode + 1) * ctx.config["num_envs"] * (
        ctx.config["n"] * ctx.config["vision"]["width"])


def test_traced_training_reads_its_metrics(clean_record):
    ctx = tiny.context("c5-train-apg-dv", seed=8, seconds=2.0, trace=True)
    line = harness.result_line(ctx, harness.run_cell(ctx))
    assert line["correct"], line["checks"]
    assert _new_metrics("c5-train-apg-dv") <= set(line["metrics"])
    rec = clean_record.record()
    spans, counters = rec["spans"], rec["counters"]
    # the profiler alone leaves the eye uncounted: the stretch runs what an untraced run does
    assert not any(k.startswith("eye.") for k in counters)
    it = spans["apg.iteration"]
    assert it["calls"] == 1 + ctx.traffic["trace_iterations"]  # the lead and the stretch
    phases = sum(spans[f"apg.{p}"]["device_ms"] for p in ("rollout", "backward", "update"))
    assert phases <= it["device_ms"] and it["self_device_ms"] < 0.1 * it["device_ms"]
    for p in ("rollout", "backward", "update"):
        assert spans[f"apg.{p}"]["parents"] == ["apg.iteration"]


def test_traced_training_across_processes_reads_its_metrics(clean_record):
    cell = "c5x4-train-apg-dv"
    ctx = tiny.context(cell, 5, seconds=4.0, trace=True)
    ctx.ranks = rank_worker.start(cell, 5, 4.0, True, "none", ctx.traffic["processes"])
    line = harness.result_line(ctx, harness.run_cell(ctx))
    assert line["correct"], line["checks"]
    assert _new_metrics(cell) <= set(line["metrics"])
    spans = clean_record.record()["spans"]
    assert spans["mesh.all_reduce_grads"]["parents"] == ["apg.update"]
