"""Interactive live viewer (matplotlib): the windowed-UI parity layer (the
port's counterpart of nenbody_tpu/viz/live.py, with the same bindings).

Mirrors the reference's interactive surface (SURVEY.md C19-C21): a scene
view that follows agent 0, an eye-strip widget for a selectable agent, a
frametime readout, and key bindings —

    w/a/s/d   pan the scene camera        (reference: WASD, src/main.rs:877-886)
    q/e       zoom out / in               (reference: QE height)
    [/]       previous / next eye         (reference: camera slider, main.rs:77-81)
    v         toggle first-person viewport (the selected-eye re-render,
                                           src/main.rs:979-998)
    c         capture a PNG               (the reference's never-wired key, main.rs:111)
    escape    quit                        (src/main.rs:869-876)

The sim advances in device-side chunks between draws, so the display rate
never throttles the simulation (unlike the reference's coupled frame loop).
Requires a display (or any interactive matplotlib backend); raises a clear
error headless — use `cli run --capture` / `record_rollout_gif` there.
matplotlib is imported only when run_live is given no `_plt`; each frame
makes one host copy of pos, vel and the observation rows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import frame as frame_lib
from .viewer import Viewer, host


class NoDisplayError(RuntimeError):
    """run_live found no matplotlib or no interactive backend."""


def initial_controls() -> dict:
    return {
        "eye": 0,
        "pan": np.zeros(2, np.float32),
        "zoom": 1.0,
        "quit": False,
        "capture": False,
        "fp": False,  # first-person viewport in the eye panel
    }


def apply_key(ctl: dict, key: str, n_agents: int) -> dict:
    """Pure key-binding logic (unit-testable without a display): mutate and
    return the control dict for one key press. Bindings in the module
    docstring; the reference's handlers are src/main.rs:877-886 (WASDQE +
    escape) and the NenbodyUi slider (main.rs:77-81)."""
    step = 10.0 * ctl["zoom"]
    if key == "escape":
        ctl["quit"] = True
    elif key == "w":
        ctl["pan"][1] += step
    elif key == "s":
        ctl["pan"][1] -= step
    elif key == "a":
        ctl["pan"][0] -= step
    elif key == "d":
        ctl["pan"][0] += step
    elif key == "q":
        ctl["zoom"] *= 1.25
    elif key == "e":
        ctl["zoom"] /= 1.25
    elif key == "[":
        ctl["eye"] = (ctl["eye"] - 1) % n_agents
    elif key == "]":
        ctl["eye"] = (ctl["eye"] + 1) % n_agents
    elif key == "v":
        ctl["fp"] = not ctl["fp"]
    elif key == "c":
        ctl["capture"] = True
    return ctl


def run_live(
    scene,
    state,
    steps_per_frame: int = 10,
    half_extent: float = 120.0,
    capture_dir: str = "out/live",
    max_frames: int | None = None,
    advance=None,
    _plt=None,
    _key_source=None,
):
    """Run an interactive viewer loop. Returns the final state.

    advance: optional `(state, k) -> state` transition override (e.g. a
    trained policy actuating the swarm — CLI `live --policy`); default is
    the scene's own controller rollout.

    _plt/_key_source: test hooks — a pyplot-compatible stub and an iterator
    of synthetic key presses applied once per frame, letting the full loop
    (rollout, compose, mode switches, capture) run headless in CI."""
    if _plt is None:
        try:
            import matplotlib
        except ImportError:
            matplotlib = None
        if matplotlib is None or matplotlib.get_backend().lower() == "agg":
            raise NoDisplayError(
                "no interactive matplotlib backend; use `nenbody-tpu run "
                "--capture` or viz.viewer.record_rollout_gif for headless "
                "output"
            )
        import matplotlib.pyplot as plt
    else:
        plt = _plt

    ctl = initial_controls()
    if advance is None:
        def advance(s, k):
            s, _ = scene.rollout(s, k)
            return s

    def on_key(ev):  # pragma: no cover - needs a display
        apply_key(ctl, ev.key, scene.cfg.n)

    fig, (ax_scene, ax_eye) = plt.subplots(
        2, 1, height_ratios=[8, 1], figsize=(8, 5)
    )
    fig.canvas.mpl_connect("key_press_event", on_key)
    im_scene = im_eye = None
    frames = 0
    cap = Viewer(out_dir=capture_dir)

    while not ctl["quit"] and (max_frames is None or frames < max_frames):
        if _key_source is not None:
            key = next(_key_source, None)
            if key is not None:
                apply_key(ctl, key, scene.cfg.n)
        t0 = time.perf_counter()
        with torch.no_grad():
            state = advance(state, steps_per_frame)
            obs = host(scene.observe(state)) if scene.cfg.vision else None
        pos = host(state.pos)
        vel = host(state.vel)

        center = pos[0] + ctl["pan"]
        img = frame_lib.render_topdown(
            pos, vel,
            center=center,
            half_extent=half_extent * ctl["zoom"],
            selected=ctl["eye"],
        )
        if ctl["fp"]:
            strip = scene.render_eye_view(
                state, ctl["eye"], size=(96, 480)
            ).astype(np.float32) / 255.0
        elif obs is not None:
            strip = frame_lib.eye_strip(obs[ctl["eye"]], height=24)
        else:
            strip = np.zeros((24, 8, 3), np.float32)
        if im_scene is None:
            im_scene = ax_scene.imshow(img)
            im_eye = ax_eye.imshow(strip, aspect="auto")
            ax_scene.set_axis_off()
            ax_eye.set_axis_off()
        else:
            im_scene.set_data(img)
            if im_eye.get_array().shape != strip.shape:  # mode switched
                im_eye.remove()
                im_eye = ax_eye.imshow(strip, aspect="auto")
            else:
                im_eye.set_data(strip)
        dt = time.perf_counter() - t0
        ax_scene.set_title(
            f"t={int(state.t)}  eye={ctl['eye']}  "
            f"{dt*1e3:.1f} ms/frame  ({steps_per_frame} steps/frame)",
            fontsize=9,
        )
        if ctl["capture"]:
            cap.capture(state, obs)
            ctl["capture"] = False
        fig.canvas.draw_idle()
        plt.pause(0.001)
        frames += 1

    plt.close(fig)
    cap.flush()
    return state
