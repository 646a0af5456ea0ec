"""The plain models of the wireframe eye kernel's culls, on the CPU, against
the port's plain renderer and the JAX package.

- The frustum test without a divide (ops.wireframe.wireframe_maybe_visible,
  the kernel's with its float32 expressions) keeps every target whose sprite
  the exact test of vision.render.edge_fragment hits on some pixel, so every
  target eye_rows_wireframe lets win one.
- The per-edge pixel ranges (ops.wireframe.wireframe_pixel_ranges, the
  kernel's edge_pixel_range with its float32 expressions) are conservative
  against that exact test at widths 17-1,024, antialias off and on, on
  random and clustered swarms and on adversarial inputs: vertices
  projecting onto pixel centres and onto pixel boundaries, sprites across
  the near plane, edges almost along a pixel's ray (|den| near 1e-12),
  fragments at exactly far, sprites behind the eye with one vert in front, a
  coincident target, and edges lying in the near plane (where a depth
  that rounds inside the slab lies outside it), and verts at exact floats
  within 16 ulps of pixel centres and boundaries. With the model's slack
  set to 0, some case misses a hit, antialias off and on.
- The (depth, edge, target) key rule, rendered from the in-range triples of
  the targets that pass the frustum test alone, equals eye_rows_wireframe
  bit for bit (tie scene of tests/test_torch_wireframe.py included) and the
  JAX dense renderer within tests/test_wireframe_kernel.py's tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu.vision import render as jrender

from nenbody_tpu_torch import VisionConfig
from nenbody_tpu_torch.ops import wireframe
from nenbody_tpu_torch.vision import camera, render

torch.set_num_threads(1)

WIDTHS = (17, 32, 64, 100, 256, 1024)
KINDS = ("random", "clustered", "centres", "boundaries", "near_plane", "edge_on", "far",
         "behind", "coincident", "grazing", "ulps")
# kinds where a single rounding decides whether a pixel is hit
ADVERSARIAL = ("centres", "boundaries", "edge_on", "grazing", "ulps")
MAX_KEY = (1 << 63) - 1


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _cfg(w, aa):
    return VisionConfig(width=w, antialias=aa, sprite_mode="wireframe")


def _rot(theta, v):
    c, s = np.cos(theta), np.sin(theta)
    return np.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], axis=-1)


def _place(eye, d, vert, f, l, direction, edge):
    """(centre, heading) of sprites whose vert `vert` lies at (f, l) in the
    eye frame (forward d, right (d_y, -d_x)) and whose edge `edge` (from its
    first vert) points along `direction` [..., 2], given in the eye frame."""
    right = np.stack([d[..., 1], -d[..., 0]], axis=-1)
    verts = np.asarray(render.SPRITE_VERTS)
    a, b = render.SPRITE_EDGES[edge]
    world_dir = direction[..., :1] * d + direction[..., 1:] * right
    s = verts[b] - verts[a]
    theta = np.arctan2(world_dir[..., 1], world_dir[..., 0]) - np.arctan2(s[1], s[0])
    p = eye + f[..., None] * d + l[..., None] * right
    centre = p - _rot(theta, np.broadcast_to(verts[vert], p.shape))
    return centre, np.stack([np.cos(theta), np.sin(theta)], axis=-1)


def _inputs(kind, w, seed):
    """(eye_pos [B, E, 2], eye_dir [B, E, 2], tgt, hdg [B, M, 2]) float32
    tensors (unit radius, t = 1). random and clustered are self-renders of
    U(-100, 100) and U(-8, 8) swarms; the other kinds place sprites in each
    env's one eye frame."""
    rng = np.random.default_rng(seed)
    if kind == "ulps":  # verts at exact floats within 16 ulps of pixel centres and boundaries
        marks = np.concatenate([2.0 * np.arange(w + 1) / w - 1.0, 2.0 * (np.arange(w) + 0.5) / w - 1.0])
        base = marks[rng.choice(len(marks), min(64, len(marks)), replace=False)].astype(np.float32)
        u = (base.view(np.int32)[:, None] + np.arange(-16, 17)).astype(np.int32).view(np.float32)
        # eye at 0 facing +x, sprites facing +x: vert 1 at (16, 16 u), verts 0, 2 at f = 14
        tgt = np.stack([np.full(u.size, 15.0), -16.0 * u.ravel()], axis=-1)[None]
        hdg = np.broadcast_to([1.0, 0.0], tgt.shape)
        return _t(np.zeros((1, 1, 2))), _t([[[1.0, 0.0]]]), _t(tgt), _t(hdg)
    if kind in ("random", "clustered"):
        half = 100.0 if kind == "random" else 8.0
        pos = rng.uniform(-half, half, (2, 40, 2))
        dirs = camera.unit_heading(_t(rng.uniform(-1, 1, (2, 40, 2))))
        return _t(pos), dirs, _t(pos), dirs
    b, m = 4, 48
    eye = rng.uniform(-50, 50, (b, 1, 2))
    d = _unit(rng.uniform(-1, 1, (b, 1, 2)))
    centres = 2.0 * (np.arange(w) + 0.5) / w - 1.0
    vert = int(rng.integers(0, 3))
    edge = int(rng.integers(0, 3))
    heading = _unit(rng.uniform(-1, 1, (b, m, 2)))
    if kind in ("centres", "boundaries", "far"):
        f = rng.uniform(2.0, 60.0, (b, m))
        if kind == "far":  # verts on pixel centres across far: depths round to exactly far
            eye = rng.uniform(-5, 5, (b, 1, 2))
            f = 10000.0 + rng.uniform(-2.0, 2.0, (b, m))
        u = (2.0 * rng.integers(0, w + 1, (b, m)) / w - 1.0 if kind == "boundaries"
             else centres[rng.integers(0, w, (b, m))])
        tgt, hdg = _place(eye, d, vert, f, u * f, heading, edge)
    elif kind == "edge_on":  # an edge along a pixel centre's ray, turned by < 1e-6 rad
        f = rng.uniform(3.0, 40.0, (b, m))
        u = centres[rng.integers(0, w, (b, m))]
        ray = _rot(rng.uniform(-1e-6, 1e-6, (b, m)), _unit(np.stack([np.ones_like(u), u], -1)))
        ray = ray * rng.choice([-1.0, 1.0], (b, m, 1))
        tgt, hdg = _place(eye, d, render.SPRITE_EDGES[edge][0], f, u * f, ray, edge)
    elif kind == "grazing":  # an edge in the near plane, turned by < 1e-6 rad
        f = 1.0 + rng.uniform(-4e-7, 4e-7, (b, m))
        lat = _rot(rng.uniform(-1e-6, 1e-6, (b, m)), np.broadcast_to([0.0, 1.0], (b, m, 2)))
        tgt, hdg = _place(eye, d, render.SPRITE_EDGES[2][0], f, rng.uniform(-0.9, 0.9, (b, m)),
                          lat * rng.choice([-1.0, 1.0], (b, m, 1)), 2)
    else:
        right = np.stack([d[..., 1], -d[..., 0]], axis=-1)
        if kind == "near_plane":  # centres within 1.5 r of the near plane
            f = 1.0 + rng.uniform(-1.5, 1.5, (b, m))
            l = rng.uniform(-1.5, 1.5, (b, m)) * np.maximum(f, 0.5)
        elif kind == "behind":  # centres at or behind the eye, some verts in front
            f = rng.uniform(-0.45, 0.45, (b, m))
            l = rng.uniform(-0.6, 0.6, (b, m))
        else:  # coincident: the first target on the eye, the others in front
            f = rng.uniform(2.0, 30.0, (b, m))
            l = rng.uniform(-0.9, 0.9, (b, m)) * f
            f[:, 0] = l[:, 0] = 0.0
        tgt = eye + f[..., None] * d + l[..., None] * right
        hdg = heading
    return _t(eye), _t(d), _t(tgt), _t(hdg)


def _exact_hits(eye_pos, eye_dir, tgt, hdg, cfg):
    """[..., E, M, 3, W] bool: edge k of target m hits pixel p of eye e
    (vision.render.edge_fragment, the plain renderer's exact test)."""
    f, l, live = render.sprite_view(eye_pos[..., :, None, :], eye_dir[..., :, None, :],
                                    tgt[..., None, :, :], hdg[..., None, :, :], cfg)
    u_p = camera.pixel_centers(cfg)
    hits = [torch.isfinite(render.edge_fragment(f[a][..., None], l[a][..., None], f[b][..., None],
                                                l[b][..., None], live[..., None], u_p, cfg)[0])
            for a, b in render.SPRITE_EDGES]
    return torch.stack(hits, dim=-2)


def _missed(eye_pos, eye_dir, tgt, hdg, cfg):
    """Exact hits outside their edge's pixel range, and the hit count."""
    hits = _exact_hits(eye_pos, eye_dir, tgt, hdg, cfg)
    lo, hi = wireframe.wireframe_pixel_ranges(eye_pos, eye_dir, tgt, hdg, cfg)
    assert lo.shape == hi.shape == hits.shape[:-1]
    p = torch.arange(cfg.width)
    inside = (lo[..., None] <= p) & (p <= hi[..., None])
    return int((hits & ~inside).sum()), int(hits.sum())


@pytest.mark.parametrize("kind", KINDS)
def test_frustum_precull_keeps_every_hit_sprite(kind):
    """Every (eye, target) whose sprite the exact test hits on some pixel
    passes the kernel's frustum test without a divide, AA off and on, at
    every width; the coincident target never passes; under spread spawns
    the test keeps about a quarter of the pairs."""
    for w in WIDTHS:
        for aa in (False, True):
            cfg = _cfg(w, aa)
            eye_pos, eye_dir, tgt, hdg = _inputs(kind, w, seed=w + 2)
            hit = _exact_hits(eye_pos, eye_dir, tgt, hdg, cfg).flatten(-2).any(-1)
            maybe = wireframe.wireframe_maybe_visible(eye_pos, eye_dir, tgt, cfg)
            assert hit.any() or kind == "behind", f"{kind} W={w} aa={aa}: no hit"
            assert not (hit & ~maybe).any(), f"{kind} W={w} aa={aa}"
            if kind == "coincident":
                assert not maybe[..., 0].any()
    if kind == "random":
        assert 0.15 < maybe.float().mean().item() < 0.35


@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_pixel_ranges_are_conservative(kind, aa):
    """Every (eye, target, edge, pixel) the exact test hits lies in the
    edge's pixel range, at every width."""
    total = 0
    for w in WIDTHS:
        cfg = _cfg(w, aa)
        missed, hits = _missed(*_inputs(kind, w, seed=w), cfg)
        assert missed == 0, f"{kind} W={w} aa={aa}: {missed} of {hits} hits outside their range"
        total += hits
    assert total > 0, f"{kind} aa={aa}: no hit at any width"


@pytest.mark.parametrize("aa", [False, True])
def test_the_slack_is_needed(monkeypatch, aa):
    """With RANGE_SLACK set to 0, the model leaves out some hit of the
    adversarial inputs: the slack covers roundings the exact test makes."""
    monkeypatch.setattr(wireframe, "RANGE_SLACK", 0.0)
    missed = sum(_missed(*_inputs(kind, w, seed=w), _cfg(w, aa))[0]
                 for kind in ADVERSARIAL for w in WIDTHS)
    assert missed > 0


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_slab_shortcut_equals_the_slab_clip(kind):
    """csrc/wireframe_eye.cu's edge_slab reads an edge whose two ends lie
    strictly inside (near, far) off its ends (two divides, tau_lo = 0 and
    tau_hi = 1): its u-interval equals the full slab clip's
    (ops.wireframe._slab, the kernel's slab_interval) bit for bit, and it
    applies to nearly every visible edge under spread spawns."""
    cfg = _cfg(64, False)
    eye_pos, eye_dir, tgt, hdg = _inputs(kind, 64, seed=7)
    f, l, live = render.sprite_view(eye_pos[..., :, None, :], eye_dir[..., :, None, :],
                                    tgt[..., None, :, :], hdg[..., None, :, :], cfg)
    t = camera.tan_half_fov(cfg)
    maybe = wireframe.wireframe_maybe_visible(eye_pos, eye_dir, tgt, cfg)
    for a, b in render.SPRITE_EDGES:
        fa, la, df, dl = f[a], l[a], f[b] - f[a], l[b] - l[a]
        f_lo, f_hi = fa + 0.0 * df, fa + 1.0 * df
        short = live & (fa > cfg.near) & (fa < cfg.far) & (f_hi > cfg.near) & (f_hi < cfg.far)
        u_a = (la + 0.0 * dl) / (t * f_lo.clamp(min=1e-30))
        u_b = (la + 1.0 * dl) / (t * f_hi.clamp(min=1e-30))
        valid, e_lo, e_hi = wireframe._slab(fa, la, df, dl, live, cfg.near, cfg.far, t)
        assert valid[short].all()
        for got, want in ((torch.minimum(u_a, u_b), e_lo), (torch.maximum(u_a, u_b), e_hi)):
            assert torch.equal(got[short].view(torch.int32), want[short].view(torch.int32))
        if kind == "random":
            assert short[maybe].float().mean() > 0.9


def test_pixel_ranges_are_narrow_under_spread_spawns():
    """Under U(-100, 100) spawns at config-5 width (256 agents, 64 px) the
    exact test runs on a few percent of the (pixel, target, edge) triples a
    full scan would test."""
    rng = np.random.default_rng(3)
    pos = _t(rng.uniform(-100, 100, (256, 2)))
    dirs = camera.unit_heading(_t(rng.uniform(-1, 1, (256, 2))))
    for aa in (False, True):
        cfg = _cfg(64, aa)
        maybe = wireframe.wireframe_maybe_visible(pos, dirs, pos, cfg)
        lo, hi = wireframe.wireframe_pixel_ranges(pos, dirs, pos, dirs, cfg)
        tested = ((hi - lo + 1).clamp(min=0) * maybe[..., None]).sum().item()
        assert 0.002 < tested / (256 * 256 * 64 * 3) < 0.03


def _render_from_keys(eye_pos, eye_dir, tgt, hdg, cfg):
    """The kernel's rule: each pixel keeps the least (depth bits, k M + j)
    key over the triples (target j that may be visible, edge k whose range
    holds the pixel) the exact test hits; the epilogue re-evaluates the
    winning sprite (ops.wireframe._winner_fragments). Returns (shade,
    depth, winner)."""
    m, w = tgt.shape[-2], cfg.width
    f, l, live = render.sprite_view(eye_pos[..., :, None, :], eye_dir[..., :, None, :],
                                    tgt[..., None, :, :], hdg[..., None, :, :], cfg)
    u_p = camera.pixel_centers(cfg)
    maybe = wireframe.wireframe_maybe_visible(eye_pos, eye_dir, tgt, cfg)
    lo, hi = wireframe.wireframe_pixel_ranges(eye_pos, eye_dir, tgt, hdg, cfg)
    p = torch.arange(w)
    keys = torch.full(eye_pos.shape[:-1] + (w,), MAX_KEY, dtype=torch.int64)
    for k, (a, b) in enumerate(render.SPRITE_EDGES):
        depth = render.edge_fragment(f[a][..., None], l[a][..., None], f[b][..., None],
                                     l[b][..., None], live[..., None], u_p, cfg)[0]
        tested = maybe[..., None] & (lo[..., k, None] <= p) & (p <= hi[..., k, None])
        hit = tested & torch.isfinite(depth)
        assert (depth[hit] > 0).all()  # the key's depth bits order as integers
        bits = depth.view(torch.int32).long()
        key = (bits << 32) | (k * m + torch.arange(m))[:, None]
        keys = torch.minimum(keys, torch.where(hit, key, MAX_KEY).min(dim=-2).values)
    hit = keys != MAX_KEY
    idx = keys & 0xFFFFFFFF
    winner = torch.where(hit, idx % m, 0)
    gather = lambda x: torch.gather(x, -2, winner.reshape(winner.shape[:-2] + (-1, 1)).expand(
        winner.shape[:-2] + (-1, 2))).reshape(winner.shape + (2,))
    shade, depth, _ = wireframe._winner_fragments(eye_pos, eye_dir, gather(tgt), gather(hdg),
                                                  u_p, cfg)
    depth_key = (keys >> 32).to(torch.int32).view(torch.float32)
    assert torch.equal(torch.where(hit, depth, 0.0), torch.where(hit, depth_key, 0.0))
    return (torch.where(hit, shade, cfg.background), torch.where(hit, depth, cfg.far),
            torch.where(hit, winner, -1))


@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("kind,w", [("random", 64), ("clustered", 64), ("random", 100),
                                    ("clustered", 1024), ("centres", 256), ("boundaries", 17),
                                    ("edge_on", 64), ("near_plane", 32), ("far", 64),
                                    ("behind", 64), ("coincident", 32), ("grazing", 1024)])
def test_key_rule_from_in_range_triples_equals_eye_rows(kind, w, aa):
    cfg = _cfg(w, aa)
    eye_pos, eye_dir, tgt, hdg = _inputs(kind, w, seed=w + 1)
    got = _render_from_keys(eye_pos, eye_dir, tgt, hdg, cfg)
    want = render.eye_rows_wireframe(eye_pos, eye_dir, tgt, hdg, cfg)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.parametrize("aa", [False, True])
def test_key_rule_tie_goes_to_the_lower_edge_first(aa):
    """tests/test_torch_wireframe.py's tie scene: at the centre pixel of an
    odd width target 0's edge 2 and target 1's edge 0 lie at depth 9; the
    key k M + j puts edge 0 first, so target 1 wins."""
    cfg = _cfg(17, aa)
    eye, eye_dir = _t([[0.0, 0.0]]), _t([[1.0, 0.0]])
    tgt, hdg = _t([[10.0, 0.0], [10.0, 0.0]]), _t([[1.0, 0.0], [-1.0, 0.0]])
    shade, depth, winner = _render_from_keys(eye, eye_dir, tgt, hdg, cfg)
    assert depth[0, 8].item() == 9.0 and winner[0, 8].item() == 1 and shade[0, 8].item() == 0.5
    want = render.eye_rows_wireframe(eye, eye_dir, tgt, hdg, cfg)
    assert all(torch.equal(g, x) for g, x in zip((shade, depth, winner), want))


@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("half,w", [(40.0, 64), (8.0, 100), (100.0, 256)])
def test_key_rule_matches_jax_dense(half, w, aa):
    """Self-renders against the JAX package's dense wireframe renderer
    (render_rows, _agent_row_wireframe per eye) on the same arrays, at
    tests/test_wireframe_kernel.py's tolerances with the hit pixels equal."""
    rng = np.random.default_rng(int(half) + w)
    pos = rng.uniform(-half, half, (2, 40, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (2, 40, 2)).astype(np.float32)
    cfg = VisionConfig(width=w, antialias=aa, sprite_mode="wireframe", far=200.0)
    dirs = camera.unit_heading(_t(vel))
    shade, depth, _ = _render_from_keys(_t(pos), dirs, _t(pos), dirs, cfg)
    jcfg = JVisionConfig(width=w, antialias=aa, sprite_mode="wireframe", far=200.0)
    for b in range(2):
        ws, wd = jrender.render_rows(jnp.asarray(pos[b]), jnp.asarray(vel[b]), jcfg)
        np.testing.assert_array_equal(depth[b].numpy() < 200.0, np.asarray(wd) < 200.0)
        np.testing.assert_allclose(depth[b].numpy(), np.asarray(wd), rtol=1e-5, atol=2e-4)
        np.testing.assert_allclose(shade[b].numpy(), np.asarray(ws), rtol=1e-5, atol=2e-4)
    assert (depth < 200.0).float().mean() > 0.02
