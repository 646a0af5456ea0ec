"""BENCHMARK.json and the files it names: every configuration, mix, limit
file and reader loads and names only pieces that exist; nothing under
bench_port imports jax, jaxlib, flax or the JAX package.

The checks of one cell, one configuration and one per-layer metric take
the benchmark of any checkout (`check_cell`, `check_config`,
`check_metric`): tests/test_added_files.py runs them on a copy to which
new files were added."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port.lib.cells import Bench

BENCH = Bench()
PORT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "nenbody_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# the configuration whose sizes the others of its preset are held to
BASE = "c5-envs4096x256-w64"
SIZES = ("num_envs", "n", "vision", "gravity", "policy", "env")


def test_benchmark_keys():
    spec = BENCH.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench_port"] and 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in spec["end_to_end"])
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in spec["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for c in spec["configs"] + spec["workloads"]:
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_port/")
        assert not any(k.endswith(("_dim", "_rank")) or k in ("width", "hidden")
                       for k in c["reduced"])
    assert len(json.dumps(spec)) < 64 * 1024


def check_cell(bench: Bench, cell: str) -> None:
    """A cell names pieces that exist: its configuration, its mix, whose
    driver loads and whose keys hold every key the driver declares
    (TRAFFIC_KEYS), its limits, and metrics of both kinds."""
    w = bench.cell(cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    assert len(w["why"]) <= 200
    cfg, job = bench.config(w["config"]), bench.traffic(w["traffic"])
    assert cfg["name"] == w["config"]
    assert bench.driver(job["driver"]).TRAFFIC_KEYS <= set(job)
    # a limit is above 0, or 0 for an exact comparison
    assert set(bench.limits(cell)) and all(v >= 0 for v in bench.limits(cell).values())
    e2e = {m["name"] for m in bench.metrics_of(cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = bench.metrics_of(cell, "per_layer")
    assert layer and all(m["moves"] in e2e for m in layer)


def check_metric(bench: Bench, metric: str) -> None:
    """A per-layer metric has a reader, moves an end-to-end metric that
    each cell it lists reports, and a roofline share is named so."""
    m = next(x for x in bench.spec["per_layer"] if x["name"] == metric)
    assert callable(bench.reader(metric))
    assert m["moves"] in {x["name"] for x in bench.spec["end_to_end"]}
    for cell in m.get("workloads", []):
        bench.cell(cell)
        assert m["moves"] in {e["name"] for e in bench.end_to_end_of(cell)}, cell
    if m["unit"] == "%" and "roofline" in metric:
        assert metric.split(".")[0].endswith("_roofline")


def _sizes(cfg: dict, key: str):
    """A configuration's `key`, its eye's sprite left out: the source's own
    sprite is the wireframe triangle, and the disc no cut of it."""
    if key == "vision":
        return {k: v for k, v in cfg[key].items() if k != "sprite_mode"}
    return cfg[key]


def check_config(bench: Bench, name: str) -> None:
    """A configuration of the base's preset keeps the base's sizes but for
    the keys its `reduced` names."""
    c = next(x for x in bench.spec["configs"] if x["name"] == name)
    base, cfg = bench.config(BASE), bench.config(name)
    if cfg.get("preset") != base["preset"]:
        return
    assert {k for k in SIZES if _sizes(cfg, k) != _sizes(base, k)} == set(c["reduced"]), name


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH.spec["workloads"]])
def test_cell_names_known_pieces(cell):
    check_cell(BENCH, cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH.spec["per_layer"]])
def test_metric_has_reader(metric):
    check_metric(BENCH, metric)


def test_four_chip_cells_are_few():
    """At most a quarter of the cells, rounded down, ask for four chips, or one."""
    cells = BENCH.spec["workloads"]
    four = [w for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH.spec["per_layer"]])
def test_per_layer_cells_report_what_it_moves(metric):
    m = next(x for x in BENCH.spec["per_layer"] if x["name"] == metric)
    for cell in m["workloads"]:
        assert m["moves"] in {e["name"] for e in BENCH.end_to_end_of(cell)}, cell


def test_reduced_lists_every_changed_key():
    """Each configuration keeps its preset's sizes but for the keys its
    `reduced` names; the eye's sprite is not a size."""
    for c in BENCH.spec["configs"]:
        check_config(BENCH, c["name"])
    cfg = BENCH.config(BASE)
    wireframe = {**cfg, "vision": {**cfg["vision"], "sprite_mode": "wireframe"}}
    assert all(_sizes(wireframe, k) == _sizes(cfg, k) for k in SIZES)


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(PORT)))
def test_no_jax_imports(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PORT / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "nenbody_tpu_torch" not in _imports(path)


def _loaded(code: str) -> set:
    """Top-level names of the modules loaded after `code` in a fresh
    interpreter at the root of the checkout."""
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.', 1)[0] "
                          "for m in sys.modules}))"], cwd=PORT.parent, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(PORT.parent)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole run of the rollout cell at the CPU sizes (the harness, its
    driver, the program, the reference and the readers) loads no module
    named jax, jaxlib, flax or nenbody_tpu, compared by whole top-level
    names; the port's own name starts with the JAX package's."""
    loaded = _loaded("from bench_port.lib import harness\n"
                     "from bench_port.tests import tiny\n"
                     "ctx = tiny.context('c5-rollout', seed=3, seconds=1.5, trace=True)\n"
                     "harness.result_line(ctx, harness.run_cell(ctx))")
    assert "nenbody_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import bench_port.reference.apg, bench_port.reference.compare, "
                     "bench_port.reference.disc_eye, bench_port.reference.eyes, "
                     "bench_port.reference.policy, "
                     "bench_port.reference.world")
    assert not loaded & (FORBIDDEN | {"nenbody_tpu_torch"})


def test_import_scan_sees_the_names(tmp_path):
    """The scan compares whole top-level names: the port's package name
    begins with the JAX package's and is allowed."""
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy\nfrom nenbody_tpu.ops import x\nimport nenbody_tpu_torch\n")
    assert _imports(probe) == {"jax", "nenbody_tpu", "nenbody_tpu_torch"}
