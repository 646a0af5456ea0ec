"""The port's viewer commands (nenbody_tpu_torch.cli: `run --capture
--first-person`, `gif`, `replay`, `run --backend cells`) against the JAX
package's (nenbody_tpu.cli), both in-process on the CPU, on shared files
(the viewer cases of tests/test_cli.py, each through both commands).

- `run --capture` from one JAX-written checkpoint: the same PNG files,
  decoded through Pillow; the top-down view equal, the eye strip and the
  first-person panel within 1 of uint8 (the renderers' rounding,
  tests/test_torch_eye_view.py);
- `gif` (incl. `--first-person` and `--policy` with a JAX params file):
  the JAX GIF's frame count, size, delay and loop (the two spawns differ:
  jax.random and torch streams do not transfer), and the JAX command's
  errors (rc 2);
- `replay` of a `.nentraj` the JAX recorder wrote: the JAX GIF's frames
  exactly (a top-down frame has three colours, which both palettes hold);
- `run --backend cells` from a shared checkpoint: the JAX run's final
  checkpoint within the dense physics' tolerance (tests/test_torch_cli_run.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nenbody_tpu import cli as jcli
from nenbody_tpu.rl import policy as jpolicy
from nenbody_tpu.utils import checkpoint as jck
from nenbody_tpu.utils import native as jnative

from nenbody_tpu_torch import cli
from nenbody_tpu_torch.utils import native
from nenbody_tpu_torch.viz import image
from test_torch_cli_run import POS_TOL, VEL_TOL, _both_run, _jax_checkpoint

torch.set_num_threads(1)


def _frames(path):
    with Image.open(path) as im:
        out = []
        for i in range(getattr(im, "n_frames", 1)):
            im.seek(i)
            out.append(np.asarray(im.convert("RGB")).astype(int))
        return out, im.info.get("duration"), im.info.get("loop")


def _gif(tmp_path, name, main, argv):
    out = str(tmp_path / f"{name}.gif")
    assert main(["gif", *argv, "--out", out]) == 0
    return out


@pytest.mark.parametrize("first_person", [False, True], ids=["plain", "first-person"])
def test_run_capture_writes_the_jax_frames(tmp_path, capsys, first_person):
    ckpt = _jax_checkpoint(tmp_path / "start.npz", 24, spread=20.0)
    argv = ["run", "--n", "24", "--controller", "gravity", "--vision-width", "16",
            "--steps", "40", "--log-every", "10", "--capture", "20", "--resume", ckpt]
    argv += ["--first-person"] if first_person else []
    dirs = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        dirs[name] = str(tmp_path / name)
        assert main(argv + ["--out-dir", dirs[name]] + extra) == 0, name
    capsys.readouterr()
    names = sorted(os.listdir(dirs["port"]))
    # a capture after each chunk whose end passes a multiple of 20 (done % 20
    # < 10): after the chunks ending at done 20 and 40
    assert names == sorted(os.listdir(dirs["jax"])) == ["frame_000000.png", "frame_000001.png"]
    for f in names:
        (got,), _, _ = _frames(os.path.join(dirs["port"], f))
        (want,), _, _ = _frames(os.path.join(dirs["jax"], f))
        assert got.shape == want.shape == (540 + 4 + (96 if first_person else 0) + 48, 960, 3)
        np.testing.assert_array_equal(got[:540], want[:540])  # the top-down view
        assert np.abs(got - want).max() <= 1
        np.testing.assert_array_equal(image.read_png(os.path.join(dirs["port"], f)), got)


@pytest.mark.parametrize("argv", [
    ["--n", "8", "--controller", "random", "--vision-width", "16", "--steps", "4",
     "--stride", "2"],
    ["--n", "8", "--controller", "boids", "--vision-width", "16", "--steps", "6",
     "--stride", "3", "--first-person"],
    ["--n", "8", "--vision-width", "0", "--steps", "2", "--stride", "1"],
], ids=["random", "first-person", "no-vision"])
def test_gif_has_the_jax_gifs_shape(tmp_path, capsys, argv):
    """(imageio merges equal consecutive frames into one, so each case
    moves its swarm by a pixel or more between frames)"""
    want = _frames(_gif(tmp_path, "jax", jcli.main, argv))
    got = _frames(_gif(tmp_path, "port", cli.main, argv + ["--device", "cpu"]))
    assert len(got[0]) == len(want[0]) and got[0][0].shape == want[0][0].shape
    assert got[1:] == want[1:] == (40, 0)
    assert "wrote" in capsys.readouterr().out


def _jax_params(path, n_obs):
    params = jpolicy.MLPPolicy().init(jax.random.key(1), jnp.zeros((1, n_obs), jnp.float32))
    return jck.save_pytree(str(path), jax.tree_util.tree_map(lambda x: x + 0.01, params))


def test_gif_policy_playback_and_its_errors(tmp_path, capsys):
    """gif --policy with a JAX params file: the policy actuates the swarm
    (the frames differ from the controller's); the JAX command's errors."""
    params = _jax_params(tmp_path / "p.npz", 18)
    base = ["--n", "8", "--controller", "gravity", "--vision-width", "16", "--steps", "4",
            "--stride", "2", "--device", "cpu"]
    policy = _frames(_gif(tmp_path, "pol", cli.main, base + ["--policy", params]))
    plain = _frames(_gif(tmp_path, "plain", cli.main, base))
    want = _frames(_gif(tmp_path, "jax", jcli.main, base[:-2] + ["--policy", params]))
    assert len(policy[0]) == len(want[0]) == 2 and policy[1:] == want[1:]
    assert any((a != b).any() for a, b in zip(policy[0], plain[0]))
    capsys.readouterr()
    out = str(tmp_path / "x.gif")
    for extra, message in (
        (["--policy", str(tmp_path / "no.npz")], "not found"),
        (["--vision-width", "0", "--policy", params], "vision"),
        (["--policy", params, "--net", "gru"], "net family"),
    ):
        for main, dev in ((jcli.main, []), (cli.main, ["--device", "cpu"])):
            assert main(["gif", *base[:-2], "--out", out, *extra, *dev]) == 2
            assert message in capsys.readouterr().err


def test_replay_of_a_jax_recording_gives_the_jax_gif(tmp_path, monkeypatch, capsys):
    assert native.build()
    monkeypatch.setattr(jnative, "_LIB_PATH", str(native.lib_path()))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_host", None)
    traj = str(tmp_path / "t.nentraj")
    rng = np.random.default_rng(0)
    with jnative.TrajectoryRecorder(traj, 16) as rec:
        for t in range(6):
            rec.append(t, rng.normal(size=(16, 2)).astype(np.float32) * 50,
                       rng.normal(size=(16, 2)).astype(np.float32))
    outs = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        outs[name] = str(tmp_path / f"{name}.gif")
        assert main(["replay", traj, "--out", outs[name], "--stride", "2", "--fps", "10",
                     "--half-extent", "90"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("replayed 6 frames (3 rendered)")
    got, want = _frames(outs["port"]), _frames(outs["jax"])
    assert got[1:] == want[1:] == (100, 0) and len(got[0]) == len(want[0]) == 3
    for g, w in zip(got[0], want[0]):
        assert g.shape == (270, 480, 3)
        np.testing.assert_array_equal(g, w)


def test_run_backend_cells_as_the_jax_run_does(tmp_path, capsys):
    ckpt = _jax_checkpoint(tmp_path / "start.npz", 32, spread=60.0)
    want, got = _both_run(tmp_path, ["run", "--n", "32", "--controller", "boids", "--backend",
                                     "cells", "--steps", "20", "--log-every", "10", "--resume",
                                     ckpt, "--checkpoint-every", "20"], "state_000000025.npz")
    np.testing.assert_allclose(got["pos"], want["pos"], **POS_TOL)
    np.testing.assert_allclose(got["vel"], want["vel"], **VEL_TOL)
    capsys.readouterr()
    assert cli.main(["run", "--device", "cpu", "--n", "8", "--controller", "gravity",
                     "--backend", "cells", "--steps", "2"]) == 2
    assert "all-pairs" in capsys.readouterr().err
