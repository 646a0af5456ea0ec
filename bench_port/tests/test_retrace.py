"""A traced stretch that the result line could not carry is traced again
(lib/retrace.py): a stretch for which the profiler handed back no device
event reads busy_s 0, and the drivers trace another, at most twice, then
end the run with an error rather than print a line with busy_s 0."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_port.lib import harness, retrace
from bench_port.lib.trace import Tracer, summarize
from bench_port.tests import tiny

torch.set_num_threads(1)


class CardTracer(Tracer):
    """A tracer that expects a card's device work while the profiler records
    the CPU alone: its first `empty` stretches hold no device event, as
    where a card's profiler dropped them; each later one is given device
    work over half its length."""

    def __init__(self, empty: int):
        super().__init__(cuda=True)
        self.empty, self.stops = empty, 0

    def start(self) -> None:
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.prof.__enter__()

    def stop(self, units: int, unit: str) -> dict:
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        summary = summarize(self.prof.profiler.kineto_results, units, unit)
        self.prof = None
        self.stops += 1
        assert summary["busy_s"] == 0 and summary["window_s"] > 0
        if self.stops > self.empty:
            summary["busy_s"] = summary["window_s"] / 2
        return summary


def _empty_stretch() -> dict:
    tr = Tracer(cuda=False)
    tr.start()
    tr.begin()
    with tr.span("train_step"):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    return tr.stop(1, "iteration")


def test_a_stretch_without_device_events_is_traced_again_twice(capsys):
    s = _empty_stretch()
    assert s["busy_s"] == 0 and s["window_s"] > 0 and not s["device_s"]
    assert retrace.fault([s]) == "holds no device work (busy_s 0)"
    r = retrace.Retrace(device=True)
    assert r.again([s]) and r.again([s])
    with pytest.raises(RuntimeError, match="3 traced stretches in a row"):
        r.again([s])
    assert capsys.readouterr().err.count("tracing another") == 2
    # on the CPU no stretch holds device work, and none is traced again
    assert not retrace.Retrace(device=False).again([s])


def test_a_stretch_the_line_could_carry_is_kept():
    assert retrace.fault([{"busy_s": 0.2, "window_s": 0.3}]) is None
    assert retrace.fault([{"busy_s": 0.3, "window_s": 0.3}]) is None
    # the line's busy_s is the ranks' mean, against rank 0's window
    ranks = [{"busy_s": 0.29, "window_s": 0.30}, {"busy_s": 0.33, "window_s": 0.34}]
    assert "over rank 0's window_s" in retrace.fault(ranks)
    assert retrace.fault([{"busy_s": 0.0, "window_s": 0.3}, {"busy_s": 0.0, "window_s": 0.3}])


@pytest.mark.parametrize("cell", ["c5-rollout", "c5-train-apg-dv"])
def test_the_drivers_trace_again(cell, capsys):
    """Two stretches without device events, then one with: the run prints
    its line from the third, having said each retry."""
    ctx = tiny.context(cell, seed=6, trace=True)
    ctx.tracer = CardTracer(empty=2)
    line = harness.result_line(ctx, harness.run_cell(ctx))
    assert ctx.tracer.stops == 3
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert capsys.readouterr().err.count("tracing another") == 2


@pytest.mark.parametrize("cell", ["c5-rollout", "c5-train-apg-dv"])
def test_the_drivers_end_the_run_after_the_third_empty_stretch(cell):
    ctx = tiny.context(cell, seed=6, trace=True)
    ctx.tracer = CardTracer(empty=3)
    with pytest.raises(RuntimeError, match="no result line"):
        harness.run_cell(ctx)
    assert ctx.tracer.stops == 3
