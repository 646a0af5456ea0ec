"""The port's config copy equals the JAX package's, and the port never
imports jax, flax or optax (nor the JAX package)."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (imported first, as every JAX test file does)
import pytest
import torch

import nenbody_tpu.config as jcfg
import nenbody_tpu_torch.config as tcfg

torch.set_num_threads(1)

CLASSES = ["GravityConfig", "BoidsConfig", "RandomWalkConfig", "VisionConfig", "SimConfig"]
PORT_ROOT = pathlib.Path(tcfg.__file__).resolve().parent


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        default = f.default
        if f.default_factory is not dataclasses.MISSING:
            default = dataclasses.asdict(f.default_factory())
        out.append((f.name, str(f.type), default))
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_config_fields_and_defaults_equal(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert _fields(j) == _fields(t)
    assert j.__dataclass_params__.frozen and t.__dataclass_params__.frozen


def test_presets_equal():
    assert list(jcfg.PRESETS) == list(tcfg.PRESETS)
    for name in jcfg.PRESETS:
        assert dataclasses.asdict(jcfg.PRESETS[name]()) == dataclasses.asdict(
            tcfg.PRESETS[name]()
        ), name


@pytest.mark.parametrize("cls,kwargs", [
    ("VisionConfig", {"sprite_mode": "cube"}),
    ("VisionConfig", {"width": 0}),
    ("VisionConfig", {"hfov_deg": 180.0}),
    ("VisionConfig", {"near": 5.0, "far": 2.0}),
    ("VisionConfig", {"sprite_radius": 0.0}),
    ("SimConfig", {"controller": "swarm"}),
    ("SimConfig", {"backend": "cuda"}),
    ("SimConfig", {"n": 0}),
])
def test_validation_equal(cls, kwargs):
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError):
            getattr(mod, cls)(**kwargs)


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax():
    banned = {"jax", "jaxlib", "flax", "optax", "nenbody_tpu"}
    files = sorted(PORT_ROOT.rglob("*.py")) + [PORT_ROOT.parent / "chip_smoke.py"]
    for path in files:
        hits = banned.intersection(_imported_roots(path))
        assert not hits, f"{path.name} imports {hits}"


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import nenbody_tpu_torch, nenbody_tpu_torch.entry, nenbody_tpu_torch.ops\n"
        "import nenbody_tpu_torch.rl\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'nenbody_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=PORT_ROOT.parent,
    )
    assert out.returncode == 0, out.stdout + out.stderr
