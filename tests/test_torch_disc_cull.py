"""The plain models of the serving path's two CUDA kernels' designs, on the
CPU, against the port's plain versions and the JAX package.

- The disc eye's pixel ranges (ops.raycast.disc_pixel_ranges, the kernel's
  disc_pixel_range with its float32 expressions): conservative against the
  exact coverage test of vision.render.eye_rows on random, clustered and
  adversarial inputs (footprint centres on pixel centres and on pixel
  boundaries, footprint edges a few ulps from a pixel centre, half-widths
  near one pixel, near-plane targets covering the whole row), and a
  rendering from the targets whose range reaches each 32-pixel span alone
  equal to eye_rows bit for bit and to the JAX dense renderer within the
  JAX suite's eye tolerances (tests/test_kernels.py:209-210; AA shade as
  tests/test_torch_vision.py states).
- The disc eye's frustum test without a divide (disc_maybe_visible):
  every target camera.project calls visible passes it.
- The kernel's draw order: the pairs that pass the cull, drawn one at a
  time in a shuffled order with the eyes interleaved (as the kernel's
  block-wide list draws them), each covering the pixels of its range that
  the band test (raycast.disc_band_cover) covers, a pixel keeping its least
  (depth bits, index) key: the winners equal the plain argmin's and the
  rendering equals eye_rows bit for bit.
- The band test equal to the divide test, on random draws, on |a| within a
  few ulps of thr du, and on every geometry of the range tests.
- Gravity's launch plan (ops.pairwise.gravity_plan, the twin of the
  kernel's) and its split sum: j chunks whose partials the cluster's leader
  adds in rank order, held against the JAX package's dense gravity at
  tests/test_kernels.py:28's tolerances.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu.config import GravityConfig as JGravityConfig
from nenbody_tpu.physics import dense as jdense
from nenbody_tpu.vision import render as jrender

from nenbody_tpu_torch import VisionConfig
from nenbody_tpu_torch.config import GravityConfig
from nenbody_tpu_torch.ops import pairwise, raycast
from nenbody_tpu_torch.physics import dense
from nenbody_tpu_torch.vision import camera, render

torch.set_num_threads(1)

WIDTHS = (17, 32, 64, 100, 256, 1024)
KINDS = ("random", "clustered", "centres", "boundaries", "edges", "frustum", "pixel_wide",
         "near_plane")
SHADE_TOL = dict(rtol=1e-5, atol=1e-5)
AA_SHADE_TOL = dict(rtol=1e-5, atol=1e-4)
DEPTH_TOL = dict(rtol=1e-5, atol=1e-4)
GRAVITY_TOL = dict(rtol=3e-5, atol=1e-7)
H100_SMS = 132


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _inputs(kind, w, seed, aa=False):
    """(eye_pos [B, E, 2], eye_dir [B, E, 2], tgt [B, M, 2]) as float32
    tensors. random and clustered are self-renders of U(-100, 100) and
    U(-8, 8) swarms; the other kinds place targets in each env's one eye
    frame at chosen depth f and footprint centre u (t = tan 45 deg = 1);
    edges puts a footprint's edge (reach thr du from u) within a few
    float32 ulps of a pixel centre, where rounding alone decides coverage,
    and frustum its far edge on the frustum's, where it decides
    visibility."""
    rng = np.random.default_rng(seed)
    if kind in ("random", "clustered"):
        half = 100.0 if kind == "random" else 8.0
        pos = rng.uniform(-half, half, (2, 40, 2))
        dirs = _unit(rng.uniform(-1, 1, (2, 40, 2)))
        return _t(pos), camera.unit_heading(_t(dirs)), _t(pos)
    b, m = 4, 48
    eye = rng.uniform(-50, 50, (b, 1, 2))
    d = _unit(rng.uniform(-1, 1, (b, 1, 2)))
    centres = 2.0 * (np.arange(w) + 0.5) / w - 1.0
    if kind == "centres":
        f = rng.uniform(2.0, 60.0, (b, m))
        u = centres[rng.integers(0, w, (b, m))]
    elif kind == "boundaries":
        f = rng.uniform(2.0, 60.0, (b, m))
        u = 2.0 * rng.integers(0, w + 1, (b, m)) / w - 1.0
    elif kind == "edges":
        f = rng.uniform(2.0, 60.0, (b, m))
        reach = 1.0 / f + (1.0 / w if aa else 0.0)
        side = rng.choice([-1.0, 1.0], (b, m))
        jitter = 1 + rng.uniform(-4e-7, 4e-7, (b, m))
        u = centres[rng.integers(0, w, (b, m))] + side * reach * jitter
    elif kind == "frustum":  # the footprint's far edge on the frustum's edge: |u| = 1 + du
        f = rng.uniform(2.0, 60.0, (b, m))
        jitter = 1 + rng.uniform(-4e-7, 4e-7, (b, m))
        u = rng.choice([-1.0, 1.0], (b, m)) * (1.0 + 1.0 / f) * jitter
    elif kind == "pixel_wide":  # du = r / (f t) within 2% of one pixel's half-width 1/W
        f = w * rng.uniform(0.98, 1.02, (b, m))
        u = rng.uniform(-1.0, 1.0, (b, m))
    else:  # near_plane: du near 1, so a footprint spans the whole row
        f = 1.0 + rng.uniform(1e-4, 0.5, (b, m))
        u = rng.uniform(-2.0, 2.0, (b, m))
    right = np.stack([d[..., 1], -d[..., 0]], axis=-1)
    tgt = eye + f[..., None] * d + (u * f)[..., None] * right
    dirs = camera.unit_heading(_t(d))
    return _t(eye), dirs, _t(tgt)


def _exact_cover(eye_pos, eye_dir, tgt, cfg):
    """([..., E, M, W] bool: vision.render.eye_rows's coverage test,
    [..., E, M, W] float32: u_p - u_c, the test's numerator)."""
    rel = tgt[..., None, :, :] - eye_pos[..., :, None, :]
    u_c, du, _, visible = camera.project(rel, eye_dir, cfg)
    u_p = camera.pixel_centers(cfg)
    safe_du = du.clamp(min=1e-30)
    a = u_p - u_c[..., None]
    off = a / safe_du[..., None]
    thr = 1.0 + ((1.0 / cfg.width) / safe_du)[..., None] if cfg.antialias else 1.0
    return visible[..., None] & (off.abs() < thr), a


@pytest.mark.parametrize("kind", KINDS)
def test_frustum_precull_keeps_every_visible_target(kind):
    """Every (eye, target) camera.project calls visible passes the
    kernel's frustum test without a divide; under spread spawns the test
    keeps about a quarter of the pairs."""
    cfg = VisionConfig(width=64)
    for w in WIDTHS:
        eye_pos, eye_dir, tgt = _inputs(kind, w, seed=w + 2)
        rel = tgt[..., None, :, :] - eye_pos[..., :, None, :]
        visible = camera.project(rel, eye_dir, cfg)[3]
        maybe = raycast.disc_maybe_visible(eye_pos, eye_dir, tgt, cfg)
        assert visible.any() and not (visible & ~maybe).any(), f"{kind} W={w}"
    if kind == "random":
        assert 0.15 < maybe.float().mean().item() < 0.35


def _in_range(lo, hi, w):
    """[..., E, M, W] bool: pixel p lies in target m's range for eye e."""
    p = torch.arange(w)
    return (lo[..., None] <= p) & (p <= hi[..., None])


@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_pixel_ranges_are_conservative(kind, aa):
    """Every (eye, target, pixel) the exact test covers lies in the
    target's pixel range for the eye, with its centre within reach_plus of
    the footprint centre (the kernel's cheap exit), at every width."""
    for w in WIDTHS:
        cfg = VisionConfig(width=w, antialias=aa)
        eye_pos, eye_dir, tgt = _inputs(kind, w, seed=w, aa=aa)
        cover, a = _exact_cover(eye_pos, eye_dir, tgt, cfg)
        lo, hi, reach_plus = raycast.disc_pixel_ranges(eye_pos, eye_dir, tgt, cfg)
        assert lo.shape == hi.shape == reach_plus.shape == cover.shape[:-1]
        # a footprint on the frustum's edge reaches no pixel centre without antialias
        assert cover.any() or kind == "frustum", f"{kind} W={w}: no covered pixel"
        missed = cover & ~(_in_range(lo, hi, w) & (a.abs() < reach_plus[..., None]))
        assert not missed.any(), f"{kind} W={w} aa={aa}: {int(missed.sum())} covered pixels missed"


def test_pixel_ranges_are_narrow_under_spread_spawns():
    """Under U(-100, 100) spawns at config-5 width (256 agents, 64 px) a
    quarter of the targets lie in an eye's 90 deg frustum, and each reaches
    a few pixels (its footprint and a pixel each side): the exact test runs
    on about 1% of the (pixel, target) pairs a full scan would test."""
    rng = np.random.default_rng(3)
    pos = _t(rng.uniform(-100, 100, (256, 2)))
    dirs = camera.unit_heading(_t(rng.uniform(0, 0.1, (256, 2))))
    lo, hi, _ = raycast.disc_pixel_ranges(pos, dirs, pos, VisionConfig(width=64))
    tested = (hi - lo + 1).clamp(min=0).sum().item() / (256 * 256 * 64)
    assert 0.002 < tested < 0.03


def _render_from_candidates(eye_pos, eye_dir, tgt, cfg):
    """eye_rows for each (env, eye, 32-pixel span) against the targets whose
    pixel range reaches the span alone, in index order."""
    w = cfg.width
    reach = _in_range(*raycast.disc_pixel_ranges(eye_pos, eye_dir, tgt, cfg)[:2], w)
    cand = torch.stack([reach[..., q:q + 32].any(-1) for q in range(0, w, 32)], dim=-1)
    shade = torch.full(eye_pos.shape[:-1] + (w,), cfg.background)
    depth = torch.full(eye_pos.shape[:-1] + (w,), cfg.far)
    for b in range(eye_pos.shape[0]):
        for e in range(eye_pos.shape[1]):
            for q in range(cand.shape[-1]):
                keep = cand[b, e, :, q]
                if not keep.any():
                    continue
                s, d = render.eye_rows(eye_pos[b, e:e + 1], eye_dir[b, e:e + 1],
                                       tgt[b][keep], cfg)
                span = slice(32 * q, min(32 * q + 32, w))
                shade[b, e, span], depth[b, e, span] = s[0, span], d[0, span]
    return shade, depth


@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("kind,w", [("random", 64), ("clustered", 64), ("random", 100),
                                    ("centres", 1024), ("boundaries", 17), ("edges", 64),
                                    ("near_plane", 256)])
def test_render_from_candidates_equals_eye_rows(kind, w, aa):
    cfg = VisionConfig(width=w, antialias=aa)
    eye_pos, eye_dir, tgt = _inputs(kind, w, seed=w + 1, aa=aa)
    got = _render_from_candidates(eye_pos, eye_dir, tgt, cfg)
    want = render.eye_rows(eye_pos, eye_dir, tgt, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("half,w", [(100.0, 64), (8.0, 100)])
def test_render_from_candidates_matches_jax(half, w, aa):
    """Self-renders (eyes are the targets) against the JAX package's dense
    render_rows on the same arrays."""
    rng = np.random.default_rng(int(half) + w)
    pos = rng.uniform(-half, half, (2, 40, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (2, 40, 2)).astype(np.float32)
    cfg = VisionConfig(width=w, antialias=aa)
    got = _render_from_candidates(_t(pos), camera.unit_heading(_t(vel)), _t(pos), cfg)
    jcfg = JVisionConfig(width=w, antialias=aa)
    for b in range(2):
        want = jrender.render_rows(jnp.asarray(pos[b]), jnp.asarray(vel[b]), jcfg)
        np.testing.assert_allclose(got[1][b].numpy(), np.asarray(want[1]), **DEPTH_TOL)
        np.testing.assert_allclose(got[0][b].numpy(), np.asarray(want[0]),
                                   **(AA_SHADE_TOL if aa else SHADE_TOL))


def _render_from_list(eye_pos, eye_dir, tgt, cfg, seed):
    """(shade, depth, winner): the kernel's draw in plain PyTorch. The pairs
    that pass disc_maybe_visible, in a shuffled order (a block-wide list
    mixes eyes), each min its key (its depth's bits above its index) into
    the pixels of its range that disc_band_cover covers; each pixel is then
    shaded as eye_rows shades its winner alone."""
    w = cfg.width
    rel = tgt[..., None, :, :] - eye_pos[..., :, None, :]
    u_c, du, f, visible = camera.project(rel, eye_dir, cfg)
    du = du.clamp(min=1e-30)
    inv_w = torch.tensor(1.0 / w, dtype=torch.float32)
    thr = 1.0 + inv_w / du if cfg.antialias else torch.ones_like(du)
    covered, _ = raycast.disc_band_cover(camera.pixel_centers(cfg) - u_c[..., None],
                                         du[..., None], thr[..., None])
    lo, hi, _ = raycast.disc_pixel_ranges(eye_pos, eye_dir, tgt, cfg)
    draws = visible[..., None] & covered & _in_range(lo, hi, w)
    keys = (f.view(torch.int32).long() << 32) | torch.arange(tgt.shape[-2])
    none = torch.iinfo(torch.int64).max
    best = torch.full(eye_pos.shape[:-1] + (w,), none)
    pairs = raycast.disc_maybe_visible(eye_pos, eye_dir, tgt, cfg).nonzero()
    for b, e, m in pairs[torch.randperm(len(pairs), generator=torch.Generator().manual_seed(seed))]:
        px = draws[b, e, m]
        best[b, e, px] = torch.minimum(best[b, e, px], keys[b, e, m])
    winner = torch.where(best == none, -1, best & 0xffffffff).to(torch.int32)
    shade = torch.full(best.shape, cfg.background)
    depth = torch.full(best.shape, cfg.far)
    for b in range(eye_pos.shape[0]):
        for e in range(eye_pos.shape[1]):
            for j in winner[b, e].unique().tolist():
                if j < 0:
                    continue
                s, d = render.eye_rows(eye_pos[b, e:e + 1], eye_dir[b, e:e + 1],
                                       tgt[b, j:j + 1], cfg)
                px = winner[b, e] == j
                shade[b, e, px], depth[b, e, px] = s[0, px], d[0, px]
    return shade, depth, winner


@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("kind", ["random", "clustered"])
@pytest.mark.parametrize("w", [64, 1024])
def test_shuffled_list_draw_equals_eye_rows(w, kind, aa):
    """The key's least is the plain argmin's winner whatever the order the
    pairs are drawn in, so the block-wide list may draw them in any order."""
    cfg = VisionConfig(width=w, antialias=aa)
    eye_pos, eye_dir, tgt = _inputs(kind, w, seed=w + 3, aa=aa)
    shade, depth, winner = _render_from_list(eye_pos, eye_dir, tgt, cfg, seed=w)
    want = render.eye_rows(eye_pos, eye_dir, tgt, cfg)
    assert (winner >= 0).any()
    assert torch.equal(winner, raycast.disc_winners_plain(eye_pos, eye_dir, tgt, cfg))
    assert torch.equal(shade, want[0]) and torch.equal(depth, want[1])


def _ulps(x, k):
    """x moved by k float32 ulps (toward +inf for k > 0)."""
    bits = torch.as_tensor(x, dtype=torch.float32).view(torch.int32)
    return (bits + k).view(torch.float32)


@pytest.mark.parametrize("draw", ["random", "edge_ulps"])
@pytest.mark.parametrize("aa", [False, True])
def test_band_cover_equals_the_divide_test(draw, aa):
    """|a / du| < thr as disc_band_cover decides it, the divide only in the
    band, equals the divide everywhere: on random offsets and half-widths,
    and on |a| within 24 ulps of thr du, where rounding alone decides."""
    rng = np.random.default_rng(11 + aa)
    du = _t(10.0 ** rng.uniform(-6, 1, 4096))
    inv_w = torch.tensor(1.0 / 64, dtype=torch.float32)
    thr = 1.0 + inv_w / du if aa else torch.ones_like(du)
    if draw == "random":
        a = _t(rng.uniform(-2, 2, 4096)) * thr * du
    else:
        side = _t(rng.choice([-1.0, 1.0], 4096))
        a = side * _ulps(thr * du, torch.from_numpy(rng.integers(-24, 25, 4096)).int())
    covered, in_band = raycast.disc_band_cover(a, du, thr)
    assert torch.equal(covered, (a / du).abs() < thr)
    if draw == "edge_ulps":  # the band is 8 to 16 ulps each side: the divide decides there
        assert in_band.float().mean() > 0.2
        assert covered[in_band].any() and not covered[in_band].all()


@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_band_cover_equals_the_exact_cover(kind, aa):
    """On the range tests' geometries at every width: the band test covers
    exactly the (eye, target, pixel) triples eye_rows's test covers."""
    for w in WIDTHS:
        cfg = VisionConfig(width=w, antialias=aa)
        eye_pos, eye_dir, tgt = _inputs(kind, w, seed=w, aa=aa)
        cover, a = _exact_cover(eye_pos, eye_dir, tgt, cfg)
        rel = tgt[..., None, :, :] - eye_pos[..., :, None, :]
        _, du, _, visible = camera.project(rel, eye_dir, cfg)
        du = du.clamp(min=1e-30)[..., None]
        thr = 1.0 + (1.0 / w) / du if aa else torch.ones_like(du)  # as _exact_cover's
        covered, _ = raycast.disc_band_cover(a, du, thr)
        assert torch.equal(visible[..., None] & covered, cover), f"{kind} W={w}"


def _split_gravity(pos, cfg, split, chunk, pos_j=None):
    """The kernel's split sum: the unscaled force of each rank's j chunk,
    added in rank order as the cluster's leader adds them, scaled by G."""
    src = pos if pos_j is None else pos_j
    unit = dataclasses.replace(cfg, g=1.0)
    total = torch.zeros_like(pos)
    for s in range(split):
        block = src[..., s * chunk:(s + 1) * chunk, :]
        if block.shape[-2]:
            total = total + dense.gravity_forces_cross(pos, block, unit)
    return cfg.g * total


@pytest.mark.parametrize("batch,n", [(1, 1024), (1, 300), (3, 200)])
def test_split_gravity_sum_matches_jax(batch, n):
    _, _, split, chunk, _ = pairwise.gravity_plan(batch, n, n, H100_SMS)
    assert split > 1  # the plan splits these shapes on an H100
    rng = np.random.default_rng(n)
    pos = rng.uniform(-100, 100, (batch, n, 2)).astype(np.float32)
    got = _split_gravity(_t(pos), GravityConfig(), split, chunk)
    for b in range(batch):
        want = jdense.gravity_forces(jnp.asarray(pos[b]), JGravityConfig())
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), **GRAVITY_TOL)


def test_split_gravity_cross_form_matches_jax():
    """A ring hop's cross form (M != N) split as the plan says."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(-100, 100, (200, 2)).astype(np.float32)
    pos_j = rng.uniform(-100, 100, (700, 2)).astype(np.float32)
    _, _, split, chunk, _ = pairwise.gravity_plan(1, 200, 700, H100_SMS)
    assert split > 1
    got = _split_gravity(_t(pos), GravityConfig(), split, chunk, _t(pos_j))
    want = jdense.gravity_forces_cross(jnp.asarray(pos), jnp.asarray(pos_j), JGravityConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAVITY_TOL)


def _max_split(m, t):
    s = 1
    while s < pairwise.PAIR_MAX_SPLIT and m >= 2 * s * t:
        s *= 2
    return s


@pytest.mark.parametrize("sms", [1, 16, 132])
def test_gravity_plan_covers_j_once_and_fills_the_card(sms):
    target = pairwise.GRAVITY_MIN_WARPS_PER_SM * sms
    for batch in (1, 2, 3, 64, 4096):
        for n in (1, 2, 31, 32, 100, 128, 300, 1024, 4097, 16384, 65537):
            for m in (1, 77, n, 4 * n + 5):
                t, r, split, chunk, bi = pairwise.gravity_plan(batch, n, m, sms)
                where = f"batch={batch} n={n} m={m} sms={sms}: T={t} R={r} S={split} chunk={chunk}"
                assert t in (32, 64, 128, 256) and r in (1, 2), where
                assert r == 1 or n >= t * r, where
                assert bi == -(-n // (t * r)), where
                assert 1 <= split <= pairwise.PAIR_MAX_SPLIT and split & (split - 1) == 0, where
                assert split == 1 and chunk == m or chunk % t == 0, where
                owner = torch.zeros(m, dtype=torch.int64)
                for s in range(split):
                    owner[s * chunk:(s + 1) * chunk] += 1
                assert bool((owner == 1).all()) and split * chunk >= m, where
                # the warps the plan aims for, wherever some (T, R, S) gives them
                if batch * -(-n // 32) * _max_split(m, 32) >= target:
                    assert batch * bi * split * t // 32 >= target, where


def test_gravity_plan_at_the_serving_shapes():
    """Config 4 (65,536 bodies) takes 256-thread blocks of two bodies a
    thread, split 2 ways; config 5 (4,096 envs of 256) fills the card
    without a split; config 2's N=1,024 takes one-warp blocks of one body a
    thread, split 8 ways (the fastest of the shapes measured on an H100)."""
    assert pairwise.gravity_plan(1, 65536, 65536, H100_SMS) == (256, 2, 2, 32768, 128)
    assert pairwise.gravity_plan(4096, 256, 256, H100_SMS) == (256, 1, 1, 256, 1)
    assert pairwise.gravity_plan(1, 1024, 1024, H100_SMS) == (32, 1, 8, 128, 32)
