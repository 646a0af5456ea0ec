"""Where each piece of a cell is found, by its name in BENCHMARK.json.

    configs/<file named by the configuration>   the sizes, as run
    traffic/<traffic>.json                      the mix: its driver and parameters
    drivers/<driver>.py                         the general generator of a kind of mix
    limits/<cell>.json                          the limit of each number `correct` compares
    metrics/<per-layer metric>.py               the reader of one per-layer metric
    work/<kernel>.py                            a kernel's operations and bytes

A later cell, configuration, mix or metric is a new file here and a new
entry in BENCHMARK.json; no file that exists needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """BENCHMARK.json of the checkout at `root` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "bench_port"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())["limits"]

    def driver(self, kind: str) -> ModuleType:
        path = self.dir / "drivers" / f"{kind}.py"
        if path.parent == Path(__file__).resolve().parents[1] / "drivers":
            return importlib.import_module(f"bench_port.drivers.{kind}")
        return _module(path, f"bench_port_driver_{kind}")

    def reader(self, metric: str):
        return _module(self.dir / "metrics" / f"{metric}.py",
                       "bench_port_metric_" + metric.replace(".", "_")).read

    def metrics_of(self, cell: str, kind: str) -> list:
        """The `kind` ("end_to_end" or "per_layer") metrics a cell reports:
        those that list it, and those without a list whose `moves` metric
        it reports."""
        e2e = {m["name"] for m in self.end_to_end_of(cell)}
        out = []
        for m in self.spec[kind]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out

    def end_to_end_of(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]
