"""The plain models of the RDMA ring's disc eye kernel (csrc/rdma_ring.cu,
rdma_vision_kernel), on the CPU, against its plain version
(parallel/rdma.py::_disc_hop_plain and the exact test it reduces,
rdma_disc_cover, the JAX RDMA kernel's arithmetic).

- The frustum test without a divide (rdma_disc_maybe_visible) keeps every
  target that covers a pixel, and the pixel ranges (rdma_disc_pixel_ranges,
  the kernel's draw_targets with its float32 expressions) hold every
  covered (eye, target, pixel), with the pixel centre within reach_plus of
  the footprint's (the kernel's cheap exit): on spread and clustered
  swarms and on targets placed in an eye's frame with their footprint's
  centre on pixel centres and boundaries, its edge a few ulps from a pixel
  centre or from the outermost one, at depths a few ulps from near and from
  far, and close enough to the eye to cover half the row or more.
- The kernel's 64-bit key (the depth's bits above off^2's, reduced by a
  minimum over the hop's targets) gives _disc_hop_plain's (depth, off^2)
  exactly, and merged over the hops as the kernel merges (hop 0 writes
  every pixel, later hops only the pixels they cover, a strict < on depth)
  the plain version's rows bit for bit, exact ties included.
- The kernel's unit plan (rdma_eye_plan) covers every (eye, pixel).
"""

import numpy as np
import pytest
import torch

from nenbody_tpu_torch import VisionConfig
from nenbody_tpu_torch.parallel import rdma
from nenbody_tpu_torch.vision import camera

from test_torch_rdma import _tie_scene

torch.set_num_threads(1)

WIDTHS = (17, 32, 64, 100, 256, 1024)
KINDS = ("spread", "clustered", "centres", "boundaries", "edges", "outer", "near", "near_ulps",
         "far_ulps")
ULP = 2.0 ** -23


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _inputs(kind, w, seed, cfg):
    """(eye_pos [B, E, 2], eye_dir [B, E, 2], tgt [B, M, 2]) as float32
    tensors. spread and clustered are self-renders of U(-100, 100) and
    U(-8, 8) swarms; the other kinds place targets in each env's one eye
    frame at depth f with footprint centre u and half-width r / (f t) = 1 / f
    (t = tan 45 deg = 1, r = 1): edges puts the footprint's edge within a
    few float32 ulps of a pixel centre and outer within a few ulps of the
    outermost centre (where the frustum test decides), near brings targets
    close to the eye (footprints over half the row or more), near_ulps and far_ulps
    put their depth within a few ulps of the near and far planes."""
    rng = np.random.default_rng(seed)
    if kind in ("spread", "clustered"):
        half = 100.0 if kind == "spread" else 8.0
        pos = rng.uniform(-half, half, (2, 40, 2))
        dirs = _unit(rng.uniform(-1, 1, (2, 40, 2)))
        return _t(pos), camera.unit_heading(_t(dirs)), _t(pos)
    b, m = 4, 48
    eye = rng.uniform(-50, 50, (b, 1, 2))
    d = _unit(rng.uniform(-1, 1, (b, 1, 2)))
    centres = 2.0 * (np.arange(w) + 0.5) / w - 1.0
    jitter = 1 + rng.uniform(-4 * ULP, 4 * ULP, (b, m))
    side = rng.choice([-1.0, 1.0], (b, m))
    f = rng.uniform(2.0, 60.0, (b, m))
    if kind == "centres":
        u = centres[rng.integers(0, w, (b, m))]
    elif kind == "boundaries":
        u = 2.0 * rng.integers(0, w + 1, (b, m)) / w - 1.0
    elif kind == "edges":
        u = centres[rng.integers(0, w, (b, m))] + side * jitter / f
    elif kind == "outer":
        u = side * (centres[-1] + jitter / f)
    elif kind == "near":
        f = cfg.near * (1.0 + rng.uniform(1e-4, 0.5, (b, m)))
        u = rng.uniform(-2.0, 2.0, (b, m))
    elif kind == "near_ulps":
        f = cfg.near * (1.0 + rng.integers(-4, 5, (b, m)) * ULP)
        u = rng.uniform(-1.5, 1.5, (b, m))
    else:  # far_ulps: a footprint of 1e-4 covers only a centre it sits on
        f = cfg.far * (1.0 + rng.integers(-4, 5, (b, m)) * ULP)
        u = centres[rng.integers(0, w, (b, m))] + rng.uniform(-5e-5, 5e-5, (b, m))
    right = np.stack([d[..., 1], -d[..., 0]], axis=-1)
    tgt = eye + f[..., None] * d + (u * f)[..., None] * right
    return _t(eye), camera.unit_heading(_t(d)), _t(tgt)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_rdma_culls_keep_every_covered_pixel(kind, w):
    cfg = VisionConfig(width=w)
    eye_pos, eye_dir, tgt = _inputs(kind, w, seed=w + KINDS.index(kind), cfg=cfg)
    _, o2, covered = rdma.rdma_disc_cover(eye_pos, eye_dir, tgt, cfg)
    assert covered.any(), f"{kind} W={w}: nothing covered, the case tests nothing"
    maybe = rdma.rdma_disc_maybe_visible(eye_pos, eye_dir, tgt, cfg)
    assert not (covered.any(dim=-1) & ~maybe).any()
    lo, hi, reach_plus = rdma.rdma_disc_pixel_ranges(eye_pos, eye_dir, tgt, cfg)
    p = torch.arange(w)
    in_range = (lo[..., None] <= p) & (p <= hi[..., None])
    assert not (covered & ~in_range).any()
    _, _, u_c, _ = rdma._rdma_disc_project(eye_pos, eye_dir, tgt, cfg)
    a = camera.pixel_centers(cfg) - u_c[..., None]  # the kernel's s_up[p] - uc
    assert not (covered & (a.abs() >= reach_plus[..., None])).any()
    if kind == "spread":  # a quarter of the pairs in a 90-degree frustum
        assert 0.15 < maybe.float().mean().item() < 0.35
    if kind == "near":  # some footprints span half the row or more
        assert ((hi - lo + 1) >= w // 2).any()


def _bits(x):
    return x.contiguous().view(torch.int32).long()


def _key_hop(eye_pos, eye_dir, tgt, cfg):
    """The kernel's hop: each covered (eye, target, pixel) keyed (depth bits
    << 32) | off^2 bits, the least key per pixel (atomicMin), which starts
    at (far, 1.0). Returns the keys [..., E, W] (int64) and the empty key."""
    f, o2, covered = rdma.rdma_disc_cover(eye_pos, eye_dir, tgt, cfg)
    keys = (_bits(f)[..., None] << 32) | _bits(o2)
    empty = (_bits(torch.tensor(cfg.far)) << 32) | _bits(torch.tensor(1.0))
    return torch.where(covered, keys, empty).amin(dim=-2), empty


def _decode(keys):
    """(depth, off^2) float32 of keys."""
    depth = (keys >> 32).int().view(torch.float32)
    o2 = (keys & 0xFFFFFFFF).int().view(torch.float32)
    return depth, o2


def _key_rows(pos_b, dir_b, cfg):
    """The kernel's rows: each shard's hops in ring order, hop 0 writing
    every pixel, a later hop only the pixels it covers where its depth is
    strictly less."""
    d = len(pos_b)
    rows = []
    for s in range(d):
        for k in range(d):
            keys, empty = _key_hop(pos_b[s], dir_b[s], pos_b[(s - k) % d], cfg)
            depth, o2 = _decode(keys)
            if k == 0:
                best_d, best_o2 = depth, o2
                continue
            take = (keys != empty) & (depth < best_d)
            best_d, best_o2 = torch.where(take, depth, best_d), torch.where(take, o2, best_o2)
        rows.append((best_d, best_o2))
    return rows


@pytest.mark.parametrize("kind", ["spread", "clustered", "centres", "edges", "near"])
def test_rdma_key_hop_equals_plain_hop(kind):
    """Where any target covers the pixel the least key decodes to
    _disc_hop_plain's (depth, off^2) exactly; elsewhere the key stays (far,
    1.0) and the plain hop's depth is far (its off^2 there is never merged:
    far is not < any row's depth)."""
    cfg = VisionConfig(width=64)
    eye_pos, eye_dir, tgt = _inputs(kind, 64, seed=7, cfg=cfg)
    keys, empty = _key_hop(eye_pos, eye_dir, tgt, cfg)
    depth, o2 = _decode(keys)
    want_d, want_o2 = rdma._disc_hop_plain(eye_pos, eye_dir, tgt, cfg)
    hit = keys != empty
    assert hit.any() and torch.equal(depth, want_d)
    assert torch.equal(o2[hit], want_o2[hit]) and (o2[~hit] == 1.0).all()


def _mesh_blocks(pos, vel, d):
    """(position blocks, heading blocks) of the agents split into d shards."""
    dirs = camera.unit_heading(vel)
    return list(pos.chunk(d, dim=-2)), list(dirs.chunk(d, dim=-2))


@pytest.mark.parametrize("case", ["tie scene", "spread 3 shards", "clustered 4 shards batched"])
def test_rdma_key_rows_equal_plain_rows(case):
    """The kernel's merge over the hops, on its keys, gives the plain
    version's rows bit for bit: the tie scene's exact depth ties within a
    hop (the least off^2 wins) and across hops (the earlier hop keeps it),
    a spread swarm on 3 shards and a clustered batch on 4."""
    if case == "tie scene":
        pos, vel = map(_t, _tie_scene())
        d, cfg = 2, VisionConfig(width=17)
    else:
        rng = np.random.default_rng(len(case))
        d, half, batch = (3, 100.0, ()) if case.startswith("spread") else (4, 8.0, (2,))
        pos = _t(rng.uniform(-half, half, batch + (48, 2)))
        vel = _t(rng.uniform(-1, 1, batch + (48, 2)))
        cfg = VisionConfig(width=48)
    pos_b, dir_b = _mesh_blocks(pos, vel, d)
    got = _key_rows(pos_b, dir_b, cfg)
    want = rdma._plain_rdma_vision(pos_b, dir_b, cfg)
    for (gd, go2), (wd, wo2) in zip(got, want):
        assert torch.equal(gd, wd) and torch.equal(go2, wo2)
    if case == "tie scene":  # eye 300 keeps hop 0's agent 400, eye 301 gets agent 200
        depth, o2 = torch.cat([r[0] for r in got]), torch.cat([r[1] for r in got])
        assert depth[300, 8] == depth[301, 8] == 10.0
        assert o2[300, 8] == 0.25 and o2[301, 8] == 0.0


@pytest.mark.parametrize("nb,nl,w,shards", [(1, 256, 64, 4), (4096, 64, 64, 4), (1, 25, 1024, 4),
                                            (3, 10, 17, 2), (1, 100, 2000, 1)])
def test_rdma_eye_plan_covers_every_pixel(nb, nl, w, shards):
    """The plan's units (EB eyes by a segment of min(W, 256) pixels) hold
    every (eye, pixel) of a shard, each unit's keys fit the block's
    KEY_PIXELS, and EB falls only while the card's SMs (132) would get
    fewer than two units each."""
    eyes, units = rdma.rdma_eye_plan(nb, nl, w, shards, 132)
    seg = min(w, rdma.SEG_MAX)
    assert eyes & (eyes - 1) == 0 and eyes <= rdma.EYE_MAX and eyes * seg <= rdma.KEY_PIXELS
    assert units == nb * -(-nl // eyes) * -(-w // seg)
    assert units * eyes * seg >= nb * nl * w
    if eyes < rdma.EYE_MAX and eyes * 2 * seg <= rdma.KEY_PIXELS:
        assert shards * nb * -(-nl // (2 * eyes)) * -(-w // seg) < 2 * 132
