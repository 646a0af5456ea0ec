"""The port's spans and counters (utils/profiling.py) and the disc eye's work
counters (ops/raycast.py, csrc/disc_eye.cu).

The CPU tests hold the recorder to its contract: off it records nothing and
enters no record_function; a profiler alone records spans and no count;
on, spans nest per thread, sit in the profiler's trace at their own host
times and sum to their self times; counters take host ints and device
tensors; the store is capped; the launch counts read as before, cleared by
their own reset alone. The plain eye's counters are held against a direct
enumeration. The `cuda` test holds the kernel's counters to the plain
path's, its outputs to those of a launch without counters, and a profiler
alone to the kernel without counters (on the card:
python -m pytest --noconftest -q -m cuda tests/test_torch_tracing.py).
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nenbody_tpu_torch import VisionConfig
from nenbody_tpu_torch.ops import common, raycast
from nenbody_tpu_torch.utils import profiling
from nenbody_tpu_torch.vision import camera

EYE = ("eye.pairs", "eye.pixels", "eye.pairs_passed", "eye.pairs_covering", "eye.triples")


@pytest.fixture(autouse=True)
def clean_record():
    profiling.reset_record()
    yield
    profiling.reset_record()


def _uniform(shape, lo, hi, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    assert not profiling.counting()
    with profiling.span("off"):
        profiling.count("off.count", 3)
        profiling.count("off.tensor", torch.tensor(4))
    assert profiling.counter_slots(("a", "b"), "cpu") is None
    assert entered == []
    rec = profiling.record()
    assert rec["spans"] == {} and rec["kept"] == 0 and rec["dropped"] == 0
    assert not any(k.startswith("off.") for k in rec["counters"])


def test_a_profiler_alone_records_spans_and_counts_nothing():
    """Counting changes the work (the eye's counting kernel), so a trace
    taken without recording() counts nothing: it times what an untraced run
    launches."""
    n, cfg = 64, VisionConfig(width=16)
    pos = _uniform((n, 2), -10, 10, 1)
    dirs = camera.unit_heading(_uniform((n, 2), -1, 1, 2))
    with profile(activities=[ProfilerActivity.CPU]):
        assert not profiling.counting()
        with profiling.span("traced"):
            profiling.count("host", 3)
            raycast.disc_eye(pos, dirs, pos, cfg)
        assert profiling.counter_slots(("a",), "cpu") is None
    rec = profiling.record()
    assert rec["spans"]["traced"]["calls"] == 1
    assert not any(k.startswith(("host", "eye.")) for k in rec["counters"])
    with profiling.recording():
        assert profiling.counting()


class _Twice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        with profiling.span("fn.forward"):
            return 2 * x

    @staticmethod
    def backward(ctx, g):
        with profiling.span("fn.backward"):
            return 2 * g


def test_spans_nest_per_thread_through_backward():
    """Under torch.profiler, a span's parent is the innermost span its own
    thread holds open: the backward's span sits in the span around
    backward() on the thread that runs it (the calling thread for CPU
    tensors), and a span on another thread has none of the main thread's."""
    seen = {}

    def other():
        with profiling.span("other"):
            seen["thread"] = threading.get_ident()

    with profile(activities=[ProfilerActivity.CPU]), profiling.recording():
        with profiling.span("outer"):
            x = torch.ones(4, requires_grad=True)
            with profiling.span("forward"):
                y = _Twice.apply(x).sum()
            worker = threading.Thread(target=other)
            worker.start()
            worker.join()
            with profiling.span("backward"):
                y.backward()
    kept = profiling.spans()
    by_name = {s.name: s for s in kept}
    parent = {s.name: kept[s.parent].name if s.parent is not None else None for s in kept}
    assert parent == {"outer": None, "forward": "outer", "fn.forward": "forward",
                      "other": None, "backward": "outer", "fn.backward": "backward"}
    assert by_name["fn.backward"].thread == by_name["backward"].thread
    assert by_name["other"].thread == seen["thread"] != by_name["outer"].thread
    rec = profiling.record()
    assert rec["spans"]["fn.backward"]["parents"] == ["backward"]
    assert rec["spans"]["outer"]["calls"] == 1 and rec["kept"] == 6


def _annotation_gaps():
    """(the largest distance from a kept span's host start to its
    annotation's start in the profiler's events, in ns; whether every span
    lies inside its annotation) for ten nested spans under torch.profiler."""
    profiling.reset_record()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):  # the first annotations of a process and of a trace are slow
            with profiling.span("warm-up"):
                pass
        profiling.reset_record()
        for i in range(5):
            with profiling.span(f"probe{i}"):
                torch.ones(64).sum()
                with profiling.span("inner"):
                    torch.ones(64).sum()
    notes = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name().startswith(profiling.PREFIX):
            notes.setdefault(e.name()[len(profiling.PREFIX):], []).append(
                (e.start_ns(), e.end_ns()))
    kept = profiling.spans()
    assert len(kept) == 10
    notes.pop("warm-up")
    assert sorted(notes) == sorted({s.name for s in kept})
    gap, inside = 0, True
    for name in notes:
        mine = [s for s in kept if s.name == name]
        assert len(notes[name]) == len(mine)
        for s, (start, end) in zip(mine, sorted(notes[name])):
            gap = max(gap, abs(s.start_ns - start))
            inside &= start <= s.start_ns <= s.end_ns <= end
    return gap, inside


def test_span_host_start_matches_its_annotation():
    """Within 50 us, in one of three tries: a try whose thread the machine
    preempts between the annotation and the span's clock reading is taken
    again."""
    tries = []
    for _ in range(3):
        gap, inside = _annotation_gaps()
        assert inside
        tries.append(gap)
        if gap < 50_000:
            break
    assert min(tries) < 50_000, tries


def test_self_time_is_the_span_less_its_children():
    with profiling.recording():
        with profiling.span("parent"):
            time.sleep(0.002)
            for _ in range(2):
                with profiling.span("child"):
                    time.sleep(0.003)
    rec = profiling.record()["spans"]
    p, c = rec["parent"], rec["child"]
    assert c["calls"] == 2 and c["self_host_ms"] == c["host_ms"] >= 6.0
    assert p["self_host_ms"] == pytest.approx(p["host_ms"] - c["host_ms"], abs=1e-9)
    assert 2.0 <= p["self_host_ms"] < p["host_ms"]
    # on the CPU a span's device time is its host time
    assert p["device_ms"] == p["host_ms"] and p["self_device_ms"] == p["self_host_ms"]


def test_counters_take_host_ints_and_device_tensors():
    with profiling.recording():
        profiling.count("host", 3)
        profiling.count("host", 4)
        profiling.count("dev", torch.tensor([2, 5]))
        profiling.count("dev", torch.tensor(1, dtype=torch.int32))
        slots = profiling.counter_slots(("a", "b"), "cpu")
        slots += torch.tensor([10, 20])
        assert profiling.counter_slots(("a", "b"), "cpu") is slots
        profiling.count("a", 1)
    counters = profiling.record()["counters"]
    assert counters["host"] == 7 and counters["dev"] == 8
    assert counters["a"] == 11 and counters["b"] == 20
    profiling.reset_record()
    assert profiling.record()["counters"] == {}


def test_the_store_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording():
        for _ in range(2):
            with profiling.span("kept"):
                pass
        with profiling.span("last"):
            with profiling.span("dropped"):
                with profiling.span("dropped_child"):
                    pass
        with profiling.span("dropped"):
            pass
    rec = profiling.record()
    assert rec["kept"] == 3 and rec["dropped"] == 3
    assert set(rec["spans"]) == {"kept", "last"}


def test_a_reset_under_an_open_span_names_no_stale_parent():
    with profiling.recording():
        with profiling.span("before"):
            profiling.reset_record()
            with profiling.span("after"):
                pass
    kept = profiling.spans()
    assert [(s.name, s.parent) for s in kept] == [("after", None)]


def test_launch_counts_read_as_before(monkeypatch):
    """chip_smoke.py's calls: reset, launch, read; every kernel named, each
    launch counted whether or not the recorder is on, the other counters
    left alone by a reset of the launch counts and the launch counts by a
    reset of the record."""
    class Lib:
        def call(self, name, *args):
            pass

    monkeypatch.setattr(common, "kernel_library", lambda: Lib())
    common.reset_launch_counts()
    assert common.launch_counts() == {name: 0 for name in common.KERNELS}
    common.KERNELS["gravity"].launch(1, 2)
    common.KERNELS["gravity_vjp"].launch(entry="nbt_gravity_vjp_cross")
    with profiling.recording():
        common.KERNELS["disc_eye"].launch()
        profiling.count("other", 5)
    counts = common.launch_counts()
    assert counts == {**{name: 0 for name in common.KERNELS},
                      "gravity": 1, "gravity_vjp": 1, "disc_eye": 1}
    assert profiling.record()["counters"]["launches.gravity"] == 1
    profiling.reset_record()
    assert common.launch_counts() == counts and "other" not in profiling.record()["counters"]
    with profiling.recording():
        profiling.count("other", 5)
    common.reset_launch_counts()
    assert sum(common.launch_counts().values()) == 0
    assert profiling.record()["counters"] == {"other": 5}


def _enumerate(eye_pos, eye_dir, tgt, cfg, chunk=64):
    """(pairs covering a pixel, covered triples): the exact test written out
    in float32 pair by pair and pixel by pixel, an eye chunk at a time."""
    t = camera.tan_half_fov(cfg)
    w = cfg.width
    u_p = 2.0 * (torch.arange(w, dtype=torch.float32) + 0.5) / w - 1.0
    covering = triples = 0
    for e0 in range(0, eye_pos.shape[-2], chunk):
        pe = eye_pos[..., e0:e0 + chunk, None, :]
        d = eye_dir[..., e0:e0 + chunk, None, :]
        rx = tgt[..., None, :, 0] - pe[..., 0]
        ry = tgt[..., None, :, 1] - pe[..., 1]
        f = rx * d[..., 0] + ry * d[..., 1]
        lat = rx * d[..., 1] - ry * d[..., 0]
        in_depth = (f > cfg.near) & (f < cfg.far)
        ft = torch.where(in_depth, f, torch.ones_like(f)) * t
        u = lat / ft
        du = cfg.sprite_radius / ft
        visible = in_depth & (u.abs() <= 1.0 + du)
        safe = du.clamp(min=1e-30)
        thr = 1.0 + (1.0 / w) / safe if cfg.antialias else torch.ones_like(safe)
        off = (u_p - u[..., None]) / safe[..., None]
        cover = visible[..., None] & (off.abs() < thr[..., None])
        covering += int(cover.any(-1).sum())
        triples += int(cover.sum())
    return covering, triples


def test_the_eye_counters_follow_the_kernels_array():
    """The counting kernel adds five sums in EYE_COUNTERS's order: the three
    the plain version counts too, then its two fallbacks, the lists drawn
    before their tile's cull ended and the pixel tests in the band."""
    assert raycast.EYE_COUNTERS == ("eye.pairs_passed", "eye.pairs_covering", "eye.triples",
                                    "eye.list_flushes", "eye.band_divides")
    with profiling.recording():
        slots = profiling.counter_slots(raycast.EYE_COUNTERS, "cpu")
    assert slots.shape == (5,) and slots.dtype == torch.int64


def _edge_scene(n, w, aa, seed):
    """(eye_pos, eye_dir, tgt) [1, n, 2] each: every eye at the origin
    looking along +x, each target placed so that its footprint's edge (thr
    du from u_c) lies within a few ulps of a pixel centre."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(2.0, 60.0, n)
    reach = 1.0 / f + (1.0 / w if aa else 0.0)  # t = 1, r = 1
    centres = 2.0 * (np.arange(w) + 0.5) / w - 1.0
    u = (centres[rng.integers(0, w, n)] + rng.choice([-1.0, 1.0], n) * reach
         * (1 + rng.uniform(-4e-7, 4e-7, n)))
    eye = np.zeros((n, 2))
    tgt = np.stack([f, -u * f], axis=-1)  # rel . (d.y, -d.x) = -rel.y = u f
    t = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32))[None]
    return t(eye), camera.unit_heading(t(np.tile([1.0, 0.0], (n, 1)))), t(tgt)


@pytest.mark.parametrize("aa", [False, True])
def test_band_pixels_match_an_enumeration(aa):
    """raycast.disc_band_pixels (what the counting kernel's eye.band_divides
    reads) against the band written out eye by eye, where footprint edges
    lie within a few ulps of pixel centres."""
    w = 64
    cfg = VisionConfig(width=w, antialias=aa)
    eye_pos, eye_dir, tgt = _edge_scene(60, w, aa, 12 + aa)
    u_p = 2.0 * (torch.arange(w, dtype=torch.float32) + 0.5) / w - 1.0
    inv_w = torch.tensor(1.0 / w, dtype=torch.float32)
    band = 0
    for e in range(eye_pos.shape[1]):
        rel = tgt[0] - eye_pos[0, e]
        u_c, du, _, visible = camera.project(rel, eye_dir[0, e], cfg)
        du = du.clamp(min=1e-30)
        thr = 1.0 + inv_w / du if aa else torch.ones_like(du)
        reach = thr * du
        m = (u_p - u_c[:, None]).abs()
        near = (m >= reach[:, None] * (1.0 - 2.0 ** -20)) & (m < reach[:, None] * (1.0 + 2.0 ** -20))
        band += int((visible[:, None] & near).sum())
    assert band > 20
    assert raycast.disc_band_pixels(eye_pos, eye_dir, tgt, cfg) == band


@pytest.mark.parametrize("aa", [False, True])
def test_plain_eye_counts_match_a_direct_enumeration(aa):
    """Config 2's sizes (N=1,024, W=64), positions in its spawn range."""
    n, cfg = 1024, VisionConfig(width=64, antialias=aa)
    pos = _uniform((n, 2), -100, 100, 3)
    dirs = camera.unit_heading(_uniform((n, 2), -1, 1, 4))
    with profiling.recording():
        shade, _ = raycast.disc_eye(pos, dirs, pos, cfg)
    counters = profiling.record()["counters"]
    covering, triples = _enumerate(pos, dirs, pos, cfg)
    assert triples > n and covering > n  # the sizes cover pixels
    assert counters["eye.triples"] == triples
    assert counters["eye.pairs_covering"] == covering
    assert counters["eye.pairs"] == counters["eye.pairs_passed"] == n * n
    assert counters["eye.pixels"] == n * 64
    # the counts leave the render as it is
    torch.testing.assert_close(shade, raycast.disc_eye(pos, dirs, pos, cfg)[0], rtol=0, atol=0)


def test_the_diff_vision_forward_counts_too():
    cfg = VisionConfig(width=16, antialias=True)
    pos = _uniform((2, 12, 2), -10, 10, 5).requires_grad_()
    vel = _uniform((2, 12, 2), -1, 1, 6)
    with profiling.recording():
        shade, _ = raycast.render_rows_diff(pos, vel, cfg)
        shade.sum().backward()  # the pullback renders again, uncounted
    counters = profiling.record()["counters"]
    covering, triples = _enumerate(pos.detach(), camera.unit_heading(vel), pos.detach(), cfg)
    assert counters["eye.triples"] == triples > 0
    assert counters["eye.pairs_covering"] == covering
    assert counters["eye.pixels"] == 2 * 12 * 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,w,lo,hi", [
    (1, 1024, 64, -100.0, 100.0),  # config 2
    (64, 256, 64, -100.0, 100.0),  # config-5 width, 64 envs
    (16, 256, 64, -8.0, 8.0),  # clustered: ranges of many pixels, spread over a warp's lanes
    (1, 100, 1024, -100.0, 100.0),  # reference-100's eye: four segments
    (2, 60, 600, -20.0, 20.0),  # a narrow last segment
])
@pytest.mark.parametrize("aa", [False, True])
def test_kernel_eye_counters_match_the_plain_path(cuda, b, n, w, lo, hi, aa):
    cfg = VisionConfig(width=w, antialias=aa)
    pos = _uniform((b, n, 2), lo, hi, n + w, cuda)
    dirs = camera.unit_heading(_uniform((b, n, 2), -1, 1, n + w + 1, cuda))
    common.reset_launch_counts()
    plain_out = raycast.disc_eye_with_winner(pos, dirs, pos, cfg)
    with profiling.recording():
        counted_out = raycast.disc_eye_with_winner(pos, dirs, pos, cfg)
    torch.cuda.synchronize()
    for a, c in zip(plain_out, counted_out):  # the counters leave the outputs as they are
        assert torch.equal(a, c)
    assert common.launch_counts()["disc_eye"] == 2
    got = profiling.record()["counters"]
    profiling.reset_record()
    with profiling.recording():
        raycast.disc_eye_plain(pos.cpu(), dirs.cpu(), pos.cpu(), cfg)
    want = profiling.record()["counters"]
    assert got["eye.triples"] == want["eye.triples"] > 0
    assert got["eye.pairs_covering"] == want["eye.pairs_covering"] > 0
    assert got["eye.pairs"] == want["eye.pairs"] == b * n * n
    assert got["eye.pixels"] == want["eye.pixels"] == b * n * w
    assert got["eye.pairs_covering"] <= got["eye.pairs_passed"] < got["eye.pairs"]
    # the fallbacks: the band tests the plain version implies, and lists drawn early
    assert got["eye.band_divides"] == raycast.disc_band_pixels(pos.cpu(), dirs.cpu(), pos.cpu(),
                                                               cfg)
    assert 0 <= got["eye.list_flushes"] <= got["eye.pairs_passed"]
    # a profiler alone launches the kernel without counters, as an untraced run does
    profiling.reset_record()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_out = raycast.disc_eye_with_winner(pos, dirs, pos, cfg)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "disc_eye" in e.key]
    assert names and not any("counted" in k for k in names), names
    assert all(torch.equal(a, c) for a, c in zip(plain_out, traced_out))
    assert not any(k.startswith("eye.") for k in profiling.record()["counters"])
