"""A configuration, a cell (its mix and limits), a driver and a per-layer
metric added as new files alone, in a copy of the benchmark, are found by
their names and run: no file that was there is edited but BENCHMARK.json's
lists."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench_port.lib import harness
from bench_port.lib.cells import Bench
from bench_port.tests import tiny

ROOT = Path(__file__).resolve().parents[2]

READER = '''"""Host time (ms) of the spawn call a step."""


def read(summaries):
    s = summaries[0]
    spawn = s["host_s_by_span"].get("spawn")
    return spawn["s"] / s["units"] * 1e3 if spawn else None
'''


def test_new_files_are_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    port = root / "bench_port"
    cfg = json.loads((port / "configs" / "c5-envs4096x256-w64.json").read_text())
    cfg["name"] = "c5-envs4096x256-w32"
    cfg["vision"]["width"] = 32
    (port / "configs" / "c5-envs4096x256-w32.json").write_text(json.dumps(cfg))
    mix = json.loads((port / "traffic" / "eval-episodes64.json").read_text())
    (port / "traffic" / "eval-episodes16.json").write_text(
        json.dumps({**mix, "driver": "rollout_copy", "episode_steps": 16}))
    shutil.copy(port / "drivers" / "rollout.py", port / "drivers" / "rollout_copy.py")
    shutil.copy(port / "limits" / "c5-rollout.json", port / "limits" / "c5w32-rollout.json")
    (port / "metrics" / "spawn_host_ms.rollout.py").write_text(READER)
    spec["configs"].append({"name": "c5-envs4096x256-w32", "source": "https://example.org",
                            "file": "bench_port/configs/c5-envs4096x256-w32.json",
                            "reduced": ["vision"], "why": "a test"})
    spec["workloads"].append({"name": "c5w32-rollout", "config": "c5-envs4096x256-w32",
                              "traffic": "eval-episodes16", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "spawn_host_ms.rollout", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "env and scene",
                              "moves": "agent_steps_per_s", "workloads": ["c5w32-rollout"]})
    for m in spec["end_to_end"]:
        if m["name"] in ("agent_steps_per_s", "step_ms_p95"):
            m["workloads"].append("c5w32-rollout")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Bench(root)
    assert bench.driver("rollout_copy").__file__.startswith(str(port))
    for trace in (False, True):
        ctx = tiny.context("c5w32-rollout", seed=3, trace=trace, bench=bench)
        assert ctx.traffic["driver"] == "rollout_copy"
        line = harness.result_line(ctx, harness.run_cell(ctx))
        assert line["correct"], line["checks"]
        if trace:
            assert "spawn_host_ms.rollout" in line["metrics"]
        else:
            assert {"agent_steps_per_s", "setup_s"} <= set(line["metrics"])
