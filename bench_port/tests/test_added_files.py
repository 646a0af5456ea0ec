"""A configuration, a cell (its mix and limits), a driver and a per-layer
metric added as new files alone, in a copy of the benchmark, are found by
their names and run: no file that was there is edited but BENCHMARK.json's
lists. So is a cell of another eye: its reference eye and work modules are
found by the configuration's sprite_mode."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port.lib import harness
from bench_port.lib.cells import Bench
from bench_port.tests import test_files, tiny

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


EYE_STAND_IN = '''"""A stand-in for the reference eye of the wireframe sprite: it records
each call (CALLS) and hands it to the disc's eye."""

from . import disc_eye

CALLS = []


class Eye(disc_eye.Eye):
    @classmethod
    def of(cls, vision, antialias):
        CALLS.append("Eye.of")
        return disc_eye.Eye.of(vision, antialias)


def lines(*args, **kw):
    CALLS.append("lines")
    return disc_eye.lines(*args, **kw)


def heading_of(*args, **kw):
    CALLS.append("heading_of")
    return disc_eye.heading_of(*args, **kw)


def winners(*args, **kw):
    CALLS.append("winners")
    return disc_eye.winners(*args, **kw)
'''

WORK_STAND_IN = '''"""A stand-in for the work of the wireframe sprite's {kernel}: it records
each call (CALLS) and counts the disc's."""

from . import {disc}

CALLS = []


def renders(*args):
    CALLS.append(args)
    return {disc}.renders(*args)
'''

# runs in a fresh interpreter at the root of the copy, whose bench_port is
# then the package imported: each cell at the CPU sizes, untraced and
# traced, and what the stand-ins and the summaries' work say
RUN = '''
import json, sys
from bench_port.lib import harness
from bench_port.tests import tiny
import bench_port.reference.wireframe_eye as ref
import bench_port.work.wireframe_eye as fwd, bench_port.work.wireframe_eye_bwd as bwd
out = []
for cell in sys.argv[1:]:
    for trace in (False, True):
        for m in (ref, fwd, bwd):
            m.CALLS.clear()
        ctx = tiny.context(cell, seed=3, seconds=3.0, trace=trace)
        run = harness.run_cell(ctx)
        line = harness.result_line(ctx, run)
        out.append({"cell": cell, "trace": trace, "driver": ctx.traffic["driver"],
                    "reference": sorted(set(ref.CALLS)), "fwd": len(fwd.CALLS),
                    "bwd": len(bwd.CALLS), "work": sorted(run.summaries[0]["work"]) if trace else [],
                    "metrics": sorted(line["metrics"]), "files": [ref.__file__, fwd.__file__,
                                                                  bwd.__file__]})
print(json.dumps(out))
'''


def test_a_cell_of_another_eye_is_picked_up(tmp_path):
    """A configuration whose sprite_mode is "wireframe", with stand-ins of
    its reference eye and work modules, a driver declaring its own traffic
    keys, and cells, mixes, limits and readers, all new files in a copy:
    the drivers take the eye's reference and work by the sprite_mode, and
    key the traced work by its kernels. `correct` is not judged: a stand-in
    is not the wireframe eye."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    port = root / "bench_port"
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((port / "configs" / "c5-envs4096x256-w64.json").read_text())
    cfg["name"] = "c5-envs4096x256-w64-wf"
    cfg["vision"]["sprite_mode"] = "wireframe"
    (port / "configs" / "c5-envs4096x256-w64-wf.json").write_text(json.dumps(cfg))
    (port / "reference" / "wireframe_eye.py").write_text(EYE_STAND_IN)
    (port / "work" / "wireframe_eye.py").write_text(
        WORK_STAND_IN.format(kernel="eye", disc="disc_eye"))
    (port / "work" / "wireframe_eye_bwd.py").write_text(
        WORK_STAND_IN.format(kernel="eye's pullback", disc="disc_eye_bwd"))
    driver = (port / "drivers" / "apg_train.py").read_text()
    assert driver.count("TRAFFIC_KEYS = frozenset({") == 1
    (port / "drivers" / "apg_train_wf.py").write_text(
        driver.replace("TRAFFIC_KEYS = frozenset({", 'TRAFFIC_KEYS = frozenset({"note", '))
    mix = json.loads((port / "traffic" / "apg-dv-h8.json").read_text())
    (port / "traffic" / "apg-dv-h8-wf.json").write_text(
        json.dumps({**mix, "driver": "apg_train_wf", "note": "a key the new driver declares"}))
    cells = {"c5wf-rollout": ("eval-episodes64", "c5-rollout"),
             "c5wf-train-apg-dv": ("apg-dv-h8-wf", "c5-train-apg-dv")}
    for cell, (traffic, like) in cells.items():
        shutil.copy(port / "limits" / f"{like}.json", port / "limits" / f"{cell}.json")
        spec["workloads"].append({"name": cell, "config": cfg["name"], "traffic": traffic,
                                  "chips": 1, "why": "a test"})
    spec["configs"].append({"name": cfg["name"], "source": "https://example.org",
                            "file": f"bench_port/configs/{cfg['name']}.json", "reduced": [],
                            "why": "a test"})
    for name, cell in (("agent_steps_per_s", "c5wf-rollout"), ("step_ms_p95", "c5wf-rollout"),
                       ("train_agent_frames_per_s", "c5wf-train-apg-dv")):
        next(m for m in spec["end_to_end"] if m["name"] == name)["workloads"].append(cell)
    for name, cell in (("step_mfu.rollout", "c5wf-rollout"), ("step_mfu.train", "c5wf-train-apg-dv")):
        next(m for m in spec["per_layer"] if m["name"] == name)["workloads"].append(cell)
    for kernel, unit, cell, moves in (("wireframe_eye", "rollout", "c5wf-rollout", "agent_steps_per_s"),
                                      ("wireframe_eye_bwd", "train", "c5wf-train-apg-dv",
                                       "train_agent_frames_per_s")):
        name = f"{kernel}_roofline.{unit}"
        (port / "metrics" / f"{name}.py").write_text(
            f"from bench_port.lib.readers import roofline\n\n\ndef read(summaries):\n"
            f"    return roofline(summaries, {kernel + '_kernel'!r})\n")
        spec["per_layer"].append({"name": name, "unit": "%", "better": "higher",
                                  "source": "device_trace", "layer": "eyes", "moves": moves,
                                  "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Bench(root)
    for cell in cells:
        test_files.check_cell(bench, cell)
    test_files.check_config(bench, cfg["name"])
    for m in bench.spec["per_layer"]:
        test_files.check_metric(bench, m["name"])
    # the driver's own declaration is what the check holds a mix to
    (port / "traffic" / "apg-dv-h8-wf.json").write_text(
        json.dumps({**mix, "driver": "apg_train_wf"}))
    with pytest.raises(AssertionError):
        test_files.check_cell(Bench(root), "c5wf-train-apg-dv")
    (port / "traffic" / "apg-dv-h8-wf.json").write_text(
        json.dumps({**mix, "driver": "apg_train_wf", "note": "a key the new driver declares"}))

    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(root), str(ROOT)])}
    proc = subprocess.run([sys.executable, "-c", RUN, *cells], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(runs) == 4
    for r in runs:
        assert all(f.startswith(str(port)) for f in r["files"]), r["files"]
        assert {"Eye.of", "lines"} <= set(r["reference"]), r
        if r["trace"]:
            assert "winners" in r["reference"] and r["fwd"] == 1
            kernels = {k for k in r["work"] if k.endswith("_kernel")}
            assert not any(k.startswith("disc_") for k in kernels), kernels
            if r["cell"] == "c5wf-rollout":
                assert kernels == {"wireframe_eye_kernel", "gravity_kernel"} and r["bwd"] == 0
                assert "step_mfu.rollout" in r["metrics"]
            else:
                assert r["driver"] == "apg_train_wf" and r["bwd"] == 1
                assert kernels == {"wireframe_eye_kernel", "wireframe_eye_bwd_kernel",
                                   "gravity_kernel"}
                assert "step_mfu.train" in r["metrics"]
        else:
            assert r["fwd"] == r["bwd"] == 0
