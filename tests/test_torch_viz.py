"""The port's viewer (nenbody_tpu_torch.viz) against the JAX package's
(nenbody_tpu.viz) on shared numpy inputs made from a seed, on the CPU.

- viz.frame: the port's copy gives the same bytes (exact equality) for
  every function and mode;
- Viewer.compose on shared pos, vel and obs: the same uint8 frame (exact),
  with the first-person panel within 1 where the wireframe AA shade sits on
  a rounding edge (tests/test_torch_eye_view.py);
- the files: a captured PNG decodes through Pillow (a test-only import) to
  the composed frame exactly, through the native library and through the
  inline writer (whose bytes equal native.encode_png's); a written GIF
  decodes to the composed frames within half the palette's level step
  (exactly where a frame has at most 256 colours), with the frame count,
  delay and loop of the JAX package's imageio GIF of the same rollout.
"""

import io
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nenbody_tpu import Scene as JScene
from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu.state import SceneState as JSceneState
from nenbody_tpu.viz import frame as jframe
from nenbody_tpu.viz import viewer as jviewer

from nenbody_tpu_torch import Scene, SceneState, SimConfig, VisionConfig
from nenbody_tpu_torch.utils import native
from nenbody_tpu_torch.viz import frame, image, viewer

torch.set_num_threads(1)


def _swarm(n, seed, spread=60.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-spread, spread, (n, 2)).astype(np.float32),
            rng.uniform(-1, 1, (n, 2)).astype(np.float32))


def _states(pos, vel):
    jst = JSceneState(pos=jnp.asarray(pos), vel=jnp.asarray(vel), key=jax.random.key(0),
                      t=jnp.int32(0))
    tst = SceneState(pos=torch.tensor(pos), vel=torch.tensor(vel),
                     t=torch.tensor(0, dtype=torch.int32))
    return jst, tst


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_frame_constants_are_the_jax_modules():
    assert frame.CLEAR_COLOR == jframe.CLEAR_COLOR
    assert frame.AGENT_COLOR == jframe.AGENT_COLOR
    assert frame.SELECTED_COLOR == jframe.SELECTED_COLOR
    assert frame.SPRITE_EDGES == jframe.SPRITE_EDGES
    _equal(frame.SPRITE_VERTS, jframe.SPRITE_VERTS)


@pytest.mark.parametrize("kw", [
    {}, {"selected": 3}, {"size": (64, 96), "half_extent": 30.0},
    {"center": np.array([5.0, -7.0], np.float32), "sprite_scale": 2.5},
], ids=["defaults", "selected", "small", "center-scale"])
def test_render_topdown_is_byte_equal(kw):
    pos, vel = _swarm(48, 1)
    _equal(frame.render_topdown(pos, vel, **kw), jframe.render_topdown(pos, vel, **kw))


@pytest.mark.parametrize("thickness", ["perspective", 1, 3])
@pytest.mark.parametrize("rgb", [False, True], ids=["mono", "rgb"])
def test_first_person_view_is_byte_equal(thickness, rgb):
    rng = np.random.default_rng(2)
    w = 80
    depth = np.where(rng.uniform(size=w) < 0.5, 10000.0, rng.uniform(0.5, 60, w)).astype(np.float32)
    shade = rng.uniform(0, 1, (w, 3) if rgb else w).astype(np.float32)
    kw = dict(size=(50, w), thickness=thickness, sprite_albedo=0.9)
    _equal(frame.first_person_view(shade, depth, **kw),
           jframe.first_person_view(shade, depth, **kw))
    with pytest.raises(ValueError, match="viewport width"):
        frame.first_person_view(shade, depth, size=(50, w + 1))


@pytest.mark.parametrize("width", [None, 37, 200])
@pytest.mark.parametrize("rgb", [False, True], ids=["mono", "rgb"])
def test_eye_strip_compose_to_uint8_are_byte_equal(width, rgb):
    rng = np.random.default_rng(3)
    row = rng.uniform(-0.2, 1.2, (64, 3) if rgb else 64).astype(np.float32)
    strip = frame.eye_strip(row, height=9, width=width)
    _equal(strip, jframe.eye_strip(row, height=9, width=width))
    scene = rng.uniform(-0.5, 1.5, (30, 120, 3)).astype(np.float32)
    for s in (None, strip):
        _equal(frame.compose(scene, s, pad=3), jframe.compose(scene, s, pad=3))
        _equal(frame.to_uint8(frame.compose(scene, s)), jframe.to_uint8(jframe.compose(scene, s)))


@pytest.mark.parametrize("follow", ["agent0", "centroid"])
@pytest.mark.parametrize("with_obs", [False, True], ids=["no-obs", "obs"])
def test_viewer_compose_is_byte_equal(tmp_path, follow, with_obs):
    pos, vel = _swarm(40, 4)
    jst, tst = _states(pos, vel)
    obs = np.random.default_rng(5).uniform(0, 1, (40, 24)).astype(np.float32) if with_obs else None
    kw = dict(size=(90, 150), half_extent=50.0, selected_eye=2, strip_height=11,
              use_native=False, follow=follow)
    want = jviewer.Viewer(out_dir=str(tmp_path / "j"), **kw).compose(
        jst, None if obs is None else jnp.asarray(obs))
    got = viewer.Viewer(out_dir=str(tmp_path / "t"), **kw).compose(
        tst, None if obs is None else torch.tensor(obs))
    _equal(got, want)


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_viewer_first_person_compose_matches_jax(tmp_path, sprite):
    """The first-person panel comes from render_eye_view: hit columns equal,
    uint8 within 1 (the AA allowance); the rest of the frame exact."""
    n = 24
    pos, vel = _swarm(n, 6, spread=25.0)
    jst, tst = _states(pos, vel)
    vis = dict(width=32, sprite_mode=sprite, antialias=True)
    js = JScene(JSimConfig(n=n, controller="gravity", backend="dense",
                           vision=JVisionConfig(**vis)))
    ts = Scene(SimConfig(n=n, controller="gravity", backend="dense",
                         vision=VisionConfig(**vis)), device="cpu")
    kw = dict(size=(60, 120), use_native=False, first_person=True, fp_height=30)
    want = jviewer.Viewer(out_dir=str(tmp_path / "j"), scene=js, **kw).compose(
        jst, js.observe(jst))
    got = viewer.Viewer(out_dir=str(tmp_path / "t"), scene=ts, **kw).compose(
        tst, ts.observe(tst))
    assert got.shape == want.shape == (60 + 4 + 30 + 48, 120, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert not diff[:64].any()  # the top-down view and the pad
    with pytest.raises(ValueError, match="scene"):
        viewer.Viewer(out_dir=str(tmp_path / "t"), first_person=True)


@pytest.mark.parametrize("use_native", [False, True], ids=["inline", "native"])
def test_capture_writes_pngs_that_decode_to_the_frames(tmp_path, use_native):
    if use_native:
        assert native.build(), "g++ and zlib build libnenhost"
    pos, vel = _swarm(30, 7)
    _, st = _states(pos, vel)
    obs = torch.tensor(np.random.default_rng(8).uniform(0, 1, (30, 16)).astype(np.float32))
    v = viewer.Viewer(out_dir=str(tmp_path / "f"), size=(70, 110), use_native=use_native)
    assert (v._native is not None) == use_native
    paths = [v.capture(st, obs), v.capture(st.replace(pos=st.pos * 0.5), None)]
    v.flush()
    assert [os.path.basename(p) for p in paths] == ["frame_000000.png", "frame_000001.png"]
    assert v.frames_written == 2 and v.mean_frame_ms > 0
    for p, (s, o) in zip(paths, [(st, obs), (st.replace(pos=st.pos * 0.5), None)]):
        want = v.compose(s, o)
        with Image.open(p) as im:
            assert im.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(im), want)
        np.testing.assert_array_equal(image.read_png(p), want)
    if use_native:  # the inline writer gives the library's bytes
        want = v.compose(st, obs)
        assert image.png_bytes(want) == native.encode_png(want)


def test_record_rollout_gif_against_the_jax_gif(tmp_path):
    n = 16
    cfg = dict(n=n, controller="gravity", backend="dense")
    js = JScene(JSimConfig(**cfg, vision=JVisionConfig(width=16)))
    ts = Scene(SimConfig(**cfg, vision=VisionConfig(width=16)), device="cpu")
    pos, vel = _swarm(n, 9, spread=20.0)
    jst, tst = _states(pos, vel)
    jpath = jviewer.record_rollout_gif(js, jst, 6, path=str(tmp_path / "j.gif"), stride=2,
                                       size=(40, 64), fps=20)
    tpath = viewer.record_rollout_gif(ts, tst, 6, path=str(tmp_path / "t.gif"), stride=2,
                                      size=(40, 64), fps=20)
    # the port's frames, composed again from the same rollout
    v = viewer.Viewer(out_dir=str(tmp_path / "f"), size=(40, 64), use_native=False,
                      follow="centroid")
    frames, s = [], tst
    for _ in range(3):
        s, _ = ts.rollout(s, 2)
        frames.append(v.compose(s, ts.observe(s)))
    with Image.open(jpath) as jim, Image.open(tpath) as tim:
        assert tim.n_frames == jim.n_frames == 3
        assert tim.size == jim.size == (64, 40 + 4 + 48)
        assert tim.info["duration"] == jim.info["duration"] == 50
        assert tim.info["loop"] == jim.info["loop"] == 0
        for i, want in enumerate(frames):
            tim.seek(i)
            got = np.asarray(tim.convert("RGB"))
            exact = len(np.unique(want.reshape(-1, 3), axis=0)) <= 256
            bound = np.zeros(3) if exact else np.asarray(image.CUBE_STEP) / 2
            assert (np.abs(got.astype(float) - want).max(axis=(0, 1)) <= bound).all()
    info = image.gif_info(tpath)
    assert info == {"width": 64, "height": 92, "frames": 3, "delays_ms": [50.0] * 3, "loop": 0}


@pytest.mark.parametrize("colours", ["few", "many"])
def test_gif_writer_round_trips_through_pillow(colours):
    """LZW past a full code table (random pixels) and the colour cube."""
    rng = np.random.default_rng(10)
    if colours == "few":
        frames = [rng.integers(0, 200, (1, 1, 3), dtype=np.uint8)
                  + rng.integers(0, 50, (97, 131, 1), dtype=np.uint8) for _ in range(2)]
    else:
        frames = [rng.integers(0, 256, (97, 131, 3), dtype=np.uint8) for _ in range(2)]
    data = image.gif_bytes(frames, duration_ms=70.0, loop=3)
    with Image.open(io.BytesIO(data)) as im:
        assert im.n_frames == 2 and im.info["loop"] == 3 and im.info["duration"] == 70
        for i, want in enumerate(frames):
            im.seek(i)
            err = np.abs(np.asarray(im.convert("RGB")).astype(float) - want).max(axis=(0, 1))
            bound = np.zeros(3) if colours == "few" else np.asarray(image.CUBE_STEP) / 2
            assert (err <= bound).all(), err
    assert image.gif_info(data)["frames"] == 2


@pytest.mark.parametrize("shape", [(23, 41, 3), (23, 41, 4), (23, 41)],
                         ids=["rgb", "rgba", "gray"])
def test_png_writer_and_reader_round_trip_through_pillow(shape):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    data = image.png_bytes(img)
    want = img if img.ndim == 3 else img[:, :, None]
    np.testing.assert_array_equal(image.read_png(data), want)
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    # a row filter the writer never uses is refused, not misread
    raw = bytearray(zlib.decompress(data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]))
    raw[0] = 1
    body = zlib.compress(bytes(raw))
    bad = (data[:data.index(b"IDAT") - 4] + struct.pack(">I", len(body)) + b"IDAT" + body
           + struct.pack(">I", zlib.crc32(b"IDAT" + body) & 0xFFFFFFFF)
           + data[data.index(b"IEND") - 4:])
    with pytest.raises(ValueError, match="filter"):
        image.read_png(bad)
    with pytest.raises(ValueError, match="not a PNG"):
        image.read_png(b"GIF89a")
