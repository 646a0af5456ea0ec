"""The port's example twins (examples_torch/*.py) on the CPU at a tiny size:
each script's main(argv) with --device cpu runs to its end and prints its
result lines (the card runs them at their default sizes, README.md).

And the port's import rule: no file of nenbody_tpu_torch/, examples_torch/
or chip_smoke.py imports jax, flax, optax, nenbody_tpu, Pillow or imageio,
and matplotlib only inside viz.live.run_live; importing every module of the
port pulls none of them in.
"""

import ast
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nenbody_tpu_torch.viz import image

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
FORBIDDEN = ("jax", "flax", "optax", "nenbody_tpu", "PIL", "imageio")


def _run(script, argv, capsys):
    main = runpy.run_path(str(EXAMPLES / f"{script}.py"), run_name="example")["main"]
    main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


CASES = {
    "gravity_demo": (["--n", "16", "--steps", "8"], "wrote"),
    "flocking_demo": (["--n", "16", "--steps", "16"], "wrote"),
    "datagen_demo": (["--envs", "2", "--agents", "8", "--horizon", "2"], "agent-frames/s"),
    "multichip_demo": (["--n", "64"], "train step on (data=2, agents=4)"),
    "trajopt_demo": (["--n", "16", "--horizon", "3", "--iters", "2"], "iter   1"),
    "train_and_show": (["--iters", "1", "--agents", "8", "--steps", "12", "--stride", "6"],
                       "final spread"),
    "imitation_demo": (["--agents", "8", "--envs", "4", "--bc-steps", "3"], "clone recovers"),
    "ppo_scale": (["--envs", "4", "--agents", "8", "--width", "8", "--horizon", "4",
                   "--iters", "1"], "eval reward after"),
    "serving_demo": ([], "served 32 envs x 32 steps in 4 calls"),
    "refconfig_diff_vision": (["--n", "8", "--width", "32", "--iters", "2"],
                              "mean visibility"),
    "gpu_smoke": (["--n", "64"], "vision N=64 W=256"),
}


def test_every_jax_example_has_a_twin():
    jax_examples = {p.stem for p in (ROOT / "examples").glob("*.py")}
    twins = {p.stem for p in EXAMPLES.glob("*.py")}
    assert twins == (jax_examples - {"tpu_smoke"}) | {"gpu_smoke"} == set(CASES)


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_runs_on_the_cpu(tmp_path, capsys, script):
    argv, expect = CASES[script]
    if script in ("gravity_demo", "flocking_demo", "train_and_show", "serving_demo"):
        argv = argv + ["--out", str(tmp_path / ("out.pt2" if script == "serving_demo"
                                                 else "out.gif"))]
    out = _run(script, argv, capsys)
    assert expect in out, out
    assert "nan" not in out.lower()
    if script in ("gravity_demo", "flocking_demo", "train_and_show"):
        info = image.gif_info(str(tmp_path / "out.gif"))
        assert info["frames"] == 2 and info["loop"] == 0
        assert info["width"] == (544 if script == "train_and_show" else 480)


def _imports(path: Path):
    """(module, enclosing function names) of every import in a file."""
    out = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            inner = scope + [child.name] if isinstance(child, (ast.FunctionDef,
                                                               ast.AsyncFunctionDef)) else scope
            if isinstance(child, ast.Import):
                out.extend((a.name, tuple(scope)) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module, tuple(scope)))
            visit(child, inner)

    visit(ast.parse(path.read_text()), [])
    return out


def test_the_port_imports_no_jax_pillow_or_imageio():
    files = [*(ROOT / "nenbody_tpu_torch").rglob("*.py"), *EXAMPLES.glob("*.py"),
             ROOT / "chip_smoke.py"]
    for path in files:
        for module, scope in _imports(path):
            top = module.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {module}"
            if top == "matplotlib":
                assert path.name == "live.py" and scope == ("run_live",), (path, scope)


def test_importing_the_port_pulls_in_none_of_them():
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in (ROOT / "nenbody_tpu_torch").rglob("*.py")
                  if p.name != "__main__.py")
    code = ("import sys, importlib\n"
            "before = set(sys.modules)  # what site hooks may have imported\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = [m for m in set(sys.modules) - before\n"
            f"       if m.split('.')[0] in {FORBIDDEN + ('matplotlib',)!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)
