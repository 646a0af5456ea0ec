"""One run of a cell on the card through the command the benchmark gives,
and the refusal of a cell that asks for more cards than there are. Marked
`cuda`: they skip without a card.

    python -m pytest -q -m cuda bench_port/tests/test_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark refuses to run without one)")


def _run(cell: str, seconds: str = "2"):
    return subprocess.run([sys.executable, "bench_port/run.py", "--workload", cell, "--seed",
                           "2147483659", "--seconds", seconds, "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_rollout_cell_runs_correct_on_the_card(card):
    out = _run("c5-rollout")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
    assert {"agent_steps_per_s", "step_ms_p95", "peak_mem_gib", "setup_s"} == set(line["metrics"])


def test_a_cell_with_too_few_cards_prints_no_result(card):
    if torch.cuda.device_count() >= 4:
        pytest.skip("this machine holds the four cards the cell asks for")
    out = _run("c5x4-train-apg-dv")
    assert out.returncode != 0 and not out.stdout.strip()
