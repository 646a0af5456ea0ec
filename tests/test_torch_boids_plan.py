"""The boids kernel's launch plan (ops.boids.boids_plan, the twin of
csrc/boids.cu's) and its split sum on the CPU, against the JAX package.

- The plan covers every j once, in rank order, with whole tiles per rank
  and clusters of up to 16 blocks (a size Hopper allows beyond the
  portable 8), and fills the card at 132 SMs for the serving shapes (config 3's N=4,096,
  reference-100, config 4's N=65,536, 64 envs x 256).
- The kernel's split sum in plain PyTorch (each rank's rule partials over
  its j chunk, self excluded by global index, added in rank order with the
  counts as integers, then the guarded means and the weighted sum) matches
  the JAX package's physics/dense.py::boids_accels at the kernel
  tolerances of tests/test_kernels.py:60 (rtol 3e-5, atol 1e-6), at N = 1,
  100, 333 and 4,096, a batch, and with global_alignment.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu.config import BoidsConfig as JBoidsConfig
from nenbody_tpu.physics import dense as jdense

from nenbody_tpu_torch.config import BoidsConfig
from nenbody_tpu_torch.ops import boids as boids_ops
from nenbody_tpu_torch.ops import pairwise
from nenbody_tpu_torch.physics import dense

torch.set_num_threads(1)

H100_SMS = 132
BOIDS_TOL = dict(rtol=3e-5, atol=1e-6)


def _split_boids(pos, vel, cfg, split, chunk):
    """The kernel's split sum: rank s's partials over j in [s chunk, (s + 1)
    chunk), added in rank order (counts as integers), then finalized; under
    global_alignment rule 3 is the exact global mean, as boids_velocity_tiled
    adds it."""
    n = pos.shape[-2]
    skip = cfg.global_alignment
    total = None
    for s in range(split):
        j0, j1 = s * chunk, min(n, (s + 1) * chunk)
        if j0 >= j1:
            continue
        part = dense.boids_partials_cross(pos, vel, pos[..., j0:j1, :], vel[..., j0:j1, :], cfg,
                                          exclude_diagonal=True, i_offset=-j0,
                                          skip_alignment=skip)
        part = (part[0], part[1].long(), part[2], part[3], part[4].long())
        total = part if total is None else tuple(a + b for a, b in zip(total, part))
    out = dense.boids_finalize((total[0], total[1].float(), total[2], total[3],
                                total[4].float()), cfg)
    if skip and n > 1:
        out = out + cfg.alignment_scale * ((vel.sum(dim=-2, keepdim=True) - vel) / (n - 1))
    return out


@pytest.mark.parametrize("glob", [False, True])
@pytest.mark.parametrize("batch,n,half", [(1, 1, 100.0), (1, 100, 100.0), (1, 333, 20.0),
                                          (1, 4096, 100.0), (5, 333, 20.0), (3, 128, 8.0)])
def test_split_boids_sum_matches_jax(batch, n, half, glob):
    _, _, split, chunk, _ = boids_ops.boids_plan(batch, n, H100_SMS)
    assert split > 1 or n == 1  # the plan splits these shapes on an H100
    rng = np.random.default_rng(n + batch)
    pos = rng.uniform(-half, half, (batch, n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (batch, n, 2)).astype(np.float32)
    got = _split_boids(torch.from_numpy(pos), torch.from_numpy(vel),
                       BoidsConfig(global_alignment=glob), split, chunk)
    for b in range(batch):
        want = jdense.boids_accels(jnp.asarray(pos[b]), jnp.asarray(vel[b]), JBoidsConfig())
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), **BOIDS_TOL)


def test_split_boids_sum_fires_every_rule():
    """The clustered case (U(-8, 8)) has neighbours under every threshold,
    so the split sum's counts and separation are exercised, not zero."""
    rng = np.random.default_rng(8)
    pos = torch.from_numpy(rng.uniform(-8, 8, (3, 128, 2)).astype(np.float32))
    vel = torch.from_numpy(rng.uniform(-1, 1, (3, 128, 2)).astype(np.float32))
    cfg = BoidsConfig()
    _, _, split, chunk, _ = boids_ops.boids_plan(3, 128, H100_SMS)
    sum1, cnt1, repel, _, cnt3 = dense.boids_partials_cross(pos, vel, pos, vel, cfg)
    assert cnt1.min() > 0 and cnt3.min() > 0 and repel.abs().max() > 0
    torch.testing.assert_close(_split_boids(pos, vel, cfg, split, chunk),
                               dense.boids_accels(pos, vel, cfg), rtol=3e-5, atol=1e-6)


def _max_split(m, t):
    s = 1
    while s < boids_ops.BOIDS_MAX_SPLIT and m >= 2 * s * t:
        s *= 2
    return s


@pytest.mark.parametrize("sms", [1, 16, 132])
def test_boids_plan_covers_j_once_and_fills_the_card(sms):
    target = boids_ops.BOIDS_MIN_WARPS_PER_SM * sms
    for batch in (1, 2, 5, 64, 4096):
        for n in (1, 2, 31, 32, 100, 128, 333, 1024, 4096, 4097, 16384, 65536):
            t, r, split, chunk, bi = boids_ops.boids_plan(batch, n, sms)
            where = f"batch={batch} n={n} sms={sms}: T={t} R={r} S={split} chunk={chunk}"
            assert (t, r, split, chunk, bi) == pairwise.pair_plan(
                batch, n, n, sms, boids_ops.BOIDS_MIN_WARPS_PER_SM, boids_ops.BOIDS_MAX_SPLIT), where
            assert t in (32, 64, 128, 256) and r in (1, 2), where
            assert r == 1 or n >= t * r, where
            assert bi == -(-n // (t * r)), where
            assert 1 <= split <= boids_ops.BOIDS_MAX_SPLIT and split & (split - 1) == 0, where
            assert split == 1 and chunk == n or chunk % t == 0, where
            owner = torch.zeros(n, dtype=torch.int64)
            for s in range(split):  # rank s owns [s chunk, (s + 1) chunk): in rank order
                owner[s * chunk:(s + 1) * chunk] += 1
            assert bool((owner == 1).all()) and split * chunk >= n, where
            # a split rank never holds more than a tile beyond its share
            assert split == 1 or chunk < -(-n // split) + t, where
            if batch * -(-n // 32) * _max_split(n, 32) >= target:
                assert batch * bi * split * t // 32 >= target, where


def test_boids_plan_at_the_serving_shapes():
    """Config 3's N=4,096 takes 256-thread blocks of one body a thread
    split 16 ways (2,048 warps, 15.5 per SM); reference-100's N=100 splits 2
    ways (8 one-warp blocks, more than the parent's one block of 100 live
    threads); config 4's N=65,536 takes 256-thread blocks of two bodies a
    thread split 2 ways, as gravity; 64 envs x 256 fill the card split 4
    ways."""
    assert boids_ops.boids_plan(1, 4096, H100_SMS) == (256, 1, 16, 256, 16)
    assert boids_ops.boids_plan(1, 100, H100_SMS) == (32, 1, 2, 64, 4)
    assert boids_ops.boids_plan(1, 65536, H100_SMS) == (256, 2, 2, 32768, 128)
    assert boids_ops.boids_plan(64, 256, H100_SMS) == (64, 1, 4, 64, 4)
    for batch, n in ((1, 4096), (1, 65536), (64, 256)):
        t, r, split, _, bi = boids_ops.boids_plan(batch, n, H100_SMS)
        assert batch * bi * split * t // 32 >= 7 * H100_SMS
