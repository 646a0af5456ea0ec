"""The port's live viewer loop (nenbody_tpu_torch.viz.live) against the JAX
package's (nenbody_tpu.viz.live), headless, on the CPU (the cases of
tests/test_live_loop.py, each through both packages).

The key bindings give the same control dict after every key. run_live's
whole loop (rollout, top-down compose, eye strip, first-person toggle,
capture, quit) runs under a pyplot stub with one synthetic key stream in
both packages from one shared state on the dense backend; every image the
loop hands the stub must agree: the top-down views and eye strips exactly
(the dense boids steps agree to 1e-6 over these 10 steps, far inside a
pixel), the first-person panel within 1 of uint8 (its shade rounding,
tests/test_torch_eye_view.py). Without a display run_live raises the JAX
message, and `live` exits 2 with it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import Scene as JScene
from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu.state import SceneState as JSceneState
from nenbody_tpu.viz import live as jlive

from nenbody_tpu_torch import Scene, SimConfig, VisionConfig, cli
from nenbody_tpu_torch.viz import image, live

torch.set_num_threads(1)


@pytest.mark.parametrize("keys", ["wdsaqwe", "[]]vc", "escape", "xyz"])
def test_apply_key_bindings_match_jax(keys):
    keys = ["escape"] if keys == "escape" else list(keys)
    got, want = live.initial_controls(), jlive.initial_controls()
    for k in keys:
        live.apply_key(got, k, 8)
        jlive.apply_key(want, k, 8)
        assert got.keys() == want.keys()
        for name in got:
            np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]))


def test_apply_key_bindings():
    ctl = live.initial_controls()
    n = 8
    live.apply_key(ctl, "w", n)
    live.apply_key(ctl, "d", n)
    np.testing.assert_allclose(ctl["pan"], [10.0, 10.0])
    live.apply_key(ctl, "s", n)
    live.apply_key(ctl, "a", n)
    np.testing.assert_allclose(ctl["pan"], [0.0, 0.0])
    live.apply_key(ctl, "q", n)
    assert ctl["zoom"] == pytest.approx(1.25)
    live.apply_key(ctl, "w", n)  # pan step scales with zoom (QE height)
    assert ctl["pan"][1] == pytest.approx(12.5)
    live.apply_key(ctl, "e", n)
    assert ctl["zoom"] == pytest.approx(1.0)
    live.apply_key(ctl, "[", n)
    assert ctl["eye"] == n - 1  # wraps like the slider
    live.apply_key(ctl, "]", n)
    live.apply_key(ctl, "]", n)
    assert ctl["eye"] == 1
    live.apply_key(ctl, "v", n)
    assert ctl["fp"] is True
    live.apply_key(ctl, "c", n)
    assert ctl["capture"] is True
    live.apply_key(ctl, "escape", n)
    assert ctl["quit"] is True


class _Artist:
    def __init__(self, log, data):
        self._log, self._data = log, np.asarray(data)
        log.append(self._data)

    def set_data(self, d):
        self._data = np.asarray(d)
        self._log.append(self._data)

    def get_array(self):
        return self._data

    def remove(self):
        pass


class _Axis:
    def __init__(self, log):
        self._log = log

    def imshow(self, img, **kw):
        return _Artist(self._log, img)

    def set_axis_off(self):
        pass

    def set_title(self, *a, **kw):
        pass


class _Canvas:
    def mpl_connect(self, *a):
        return 0

    def draw_idle(self):
        pass


class _Fig:
    canvas = _Canvas()


class _Plt:
    """A pyplot stub that keeps every image shown, per axis."""

    def __init__(self):
        self.scene, self.eye = [], []

    def subplots(self, *a, **kw):
        return _Fig(), (_Axis(self.scene), _Axis(self.eye))

    def pause(self, *_):
        pass

    def close(self, *_):
        pass


def test_run_live_loop_headless_matches_jax(tmp_path):
    n = 6
    js = JScene(JSimConfig(n=n, controller="boids", backend="dense",
                           vision=JVisionConfig(width=16)))
    ts = Scene(SimConfig(n=n, controller="boids", backend="dense", vision=VisionConfig(width=16)),
               device="cpu")
    st = ts.spawn(seed=0)
    jst = JSceneState(pos=jnp.asarray(st.pos.numpy()), vel=jnp.asarray(st.vel.numpy()),
                      key=jax.random.key(0), t=jnp.int32(0))
    # frame 1: select; 2: first person on; 3: capture; 4: first person off;
    # 5: quit (the loop must stop early)
    keys = ["]", "v", "c", "v", "escape", "w"]
    runs = {}
    for name, mod, scene, state in (("jax", jlive, js, jst), ("port", live, ts, st)):
        plt = _Plt()
        cap = str(tmp_path / name)
        out = mod.run_live(scene, state, steps_per_frame=2, max_frames=10, capture_dir=cap,
                           _plt=plt, _key_source=iter(keys))
        runs[name] = (out, plt, cap)
    out, plt, cap = runs["port"]
    jout, jplt, jcap = runs["jax"]
    assert int(out.t) == int(np.asarray(jout.t)) == 2 * 5  # quit on frame 5
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos), rtol=3e-5, atol=1e-5)
    assert len(plt.scene) == len(jplt.scene) == 5
    for got, want in zip(plt.scene, jplt.scene):
        np.testing.assert_array_equal(got, want)
    assert [e.shape for e in plt.eye] == [e.shape for e in jplt.eye]
    assert [e.shape for e in plt.eye] == [(24, 16, 3), (96, 480, 3), (96, 480, 3), (24, 16, 3),
                                          (24, 16, 3)]
    for got, want in zip(plt.eye, jplt.eye):
        assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6
    pngs = sorted(f for f in os.listdir(cap) if f.endswith(".png"))
    assert pngs == sorted(f for f in os.listdir(jcap) if f.endswith(".png")) == [
        "frame_000000.png"]
    assert image.read_png(os.path.join(cap, pngs[0])).shape == (540 + 4 + 48, 960, 3)


@pytest.mark.parametrize("missing", ["display", "matplotlib"])
def test_run_live_without_a_display_raises_the_jax_message(capsys, monkeypatch, missing):
    import sys

    import matplotlib

    if missing == "display":
        monkeypatch.setattr(matplotlib, "get_backend", lambda: "agg")
    else:
        monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    ts = Scene(SimConfig(n=4, controller="boids", vision=VisionConfig(width=8)), device="cpu")
    with pytest.raises(RuntimeError, match=r"run --capture.*record_rollout_gif"):
        live.run_live(ts, ts.spawn(0), max_frames=1)
    assert cli.main(["live", "--device", "cpu", "--n", "4", "--vision-width", "8"]) == 2
    out = capsys.readouterr()
    assert "record_rollout_gif" in out.err and out.out == ""
