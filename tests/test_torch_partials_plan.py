"""The boids partials kernel's launch plan (ops.boids.boids_partials_plan,
the twin of csrc/boids.cu's) and its split sum on the CPU, against the JAX
package.

- The plan is the i-block's own, pair_plan(batch, n, n) aiming at 16
  warps an SM where some plan gives them, else at boids_plan's 8, the last
  rank taking the rest of any j-block: it covers every j once in rank order
  with whole tiles per rank and clusters of up to 16 blocks, keeps its rank
  boundaries when the j-block is padded with far sentinels, and fills the
  card at 132 SMs at the ring's hop shapes:
  16,384 x 16,384 (a hop at N=65,536 on 4 shards) and 4,096 x 4,096
  (Scene(backend="ring") at config 3 on one card); at 1,024 x 1,024
  (config 3 on 4 shards) it gives the most warps any plan can.
- The kernel's split sum in plain PyTorch (each rank's raw rule sums over
  its j chunk, the diagonal masked by global index only with
  exclude_diagonal, added in rank order with the counts as integers)
  matches the JAX package's Pallas partials
  (nenbody_tpu.ops.boids.boids_partials_tiled, in interpret mode on the
  CPU), both exclude_diagonal values and n != m, at N = 1, 77, 300 and 1,024
  and a batch: counts equal, sums at rtol 3e-5 / atol 1e-6 of the largest;
  a j-block padded with far sentinels gives the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu.config import BoidsConfig as JBoidsConfig
from nenbody_tpu.ops import boids as jboids

from nenbody_tpu_torch.config import BoidsConfig
from nenbody_tpu_torch.ops import boids as boids_ops
from nenbody_tpu_torch.ops import pairwise
from nenbody_tpu_torch.physics import dense

torch.set_num_threads(1)

H100_SMS = 132
NAMES = ("sum1", "cnt1", "repel", "sum3", "cnt3")


def _split_partials(pos_i, vel_i, pos_j, vel_j, cfg, exclude_diagonal):
    """The kernel's split sum: rank s's raw rule sums over j in [s chunk,
    (s + 1) chunk), the last rank's to m (the pair i == j masked by global
    index when exclude_diagonal), added in rank order as the cluster's
    leader adds them, counts as integers; returned with the counts as
    floats."""
    batch, n, m = pos_i[..., 0, 0].numel(), pos_i.shape[-2], pos_j.shape[-2]
    _, _, split, chunk, _ = boids_ops.boids_partials_plan(batch, n, m, H100_SMS)
    total = None
    for s in range(split):
        j0, j1 = s * chunk, m if s == split - 1 else min(m, (s + 1) * chunk)
        if j0 >= j1:
            continue
        part = dense.boids_partials_cross(pos_i, vel_i, pos_j[..., j0:j1, :],
                                          vel_j[..., j0:j1, :], cfg,
                                          exclude_diagonal=exclude_diagonal, i_offset=-j0)
        part = (part[0], part[1].long(), part[2], part[3], part[4].long())
        total = part if total is None else tuple(a + b for a, b in zip(total, part))
    return total[0], total[1].float(), total[2], total[3], total[4].float()


def _max_split(m, t):
    s = 1
    while s < boids_ops.BOIDS_MAX_SPLIT and m >= 2 * s * t:
        s *= 2
    return s


# -- the plan ------------------------------------------------------------------


def _warps(batch, plan):
    t, _, split, _, bi = plan
    return batch * bi * split * t // 32


@pytest.mark.parametrize("sms", [1, 16, 132])
def test_partials_plan_covers_j_once_and_fills_the_card(sms):
    target = boids_ops.BOIDS_MIN_WARPS_PER_SM * sms
    for batch in (1, 3, 64, 1024):
        for n in (1, 2, 31, 77, 128, 300, 1024, 4096, 4097, 16384):
            wide = pairwise.pair_plan(batch, n, n, sms, boids_ops.PARTIALS_MIN_WARPS_PER_SM,
                                      boids_ops.BOIDS_MAX_SPLIT)
            if _warps(batch, wide) < boids_ops.PARTIALS_MIN_WARPS_PER_SM * sms:
                wide = boids_ops.boids_plan(batch, n, sms)  # the aim cannot be met
            for m in (1, 77, n, 2 * n + 3):
                plan = boids_ops.boids_partials_plan(batch, n, m, sms)
                t, r, split, chunk, bi = plan
                where = f"batch={batch} n={n} m={m} sms={sms}: {plan}"
                assert plan == wide, where
                assert t in (32, 64, 128, 256) and r in (1, 2), where
                assert r == 1 or n >= t * r, where
                assert bi == -(-n // (t * r)), where
                assert 1 <= split <= boids_ops.BOIDS_MAX_SPLIT and split & (split - 1) == 0, where
                assert split == 1 and chunk == n or chunk % t == 0, where
                owner = torch.zeros(m, dtype=torch.int64)
                for s in range(split):  # rank s owns [s chunk, (s + 1) chunk), the last the rest
                    owner[s * chunk:m if s == split - 1 else (s + 1) * chunk] += 1
                assert bool((owner == 1).all()), where
                assert split * chunk >= n and (split == 1 or chunk < -(-n // split) + t), where
                if batch * -(-n // 32) * _max_split(n, 32) >= target:
                    assert batch * bi * split * t // 32 >= target, where


def test_partials_plan_is_the_fused_kernels_where_16_warps_an_sm_cannot_be_had():
    """Config 3 (4,096) and reference-100 on one card, a batch of 5 x 333:
    no plan gives 16 warps an SM, so the partials take the fused kernel's
    plan; at 16,384 and 65,536 they take twice the ranks."""
    for batch, n in ((1, 100), (1, 4096), (5, 333)):
        assert boids_ops.boids_partials_plan(batch, n, n, H100_SMS) == boids_ops.boids_plan(
            batch, n, H100_SMS)
    for n in (16384, 65536):
        wide, fused = boids_ops.boids_partials_plan(1, n, n, H100_SMS), boids_ops.boids_plan(
            1, n, H100_SMS)
        assert wide[2] == 2 * fused[2] and _warps(1, wide) >= 16 * H100_SMS


# (label, batch, n, m, the plan on an H100)
PATH_PLANS = [
    ("ring hop at N=65,536 on 4 shards", 1, 16384, 16384, (256, 2, 16, 1024, 32)),
    ("ring Scene at config 3 on one card", 1, 4096, 4096, (256, 1, 16, 256, 16)),
    ("a batch of 64 envs, 512 agents against 1,536", 64, 512, 1536, (128, 1, 4, 128, 4)),
]


@pytest.mark.parametrize("label,batch,n,m,plan", PATH_PLANS, ids=[p[0] for p in PATH_PLANS])
def test_partials_plan_fills_the_card_at_the_path_shapes(label, batch, n, m, plan):
    got = boids_ops.boids_partials_plan(batch, n, m, H100_SMS)
    assert got == plan
    t, r, split, _, bi = got
    assert batch * bi * split * t // 32 >= boids_ops.BOIDS_MIN_WARPS_PER_SM * H100_SMS


def test_partials_plan_at_config_3_on_4_shards_takes_the_most_warps():
    """1,024 x 1,024 cannot give 8 warps an SM with whole tiles per rank:
    the plan takes one-warp blocks split 16 ways (512 warps, the most any
    (T, R, S) gives), against the parent kernel's 4 blocks of 256 threads."""
    t, r, split, chunk, bi = boids_ops.boids_partials_plan(1, 1024, 1024, H100_SMS)
    assert (t, r, split, chunk, bi) == (32, 1, 16, 64, 32)
    assert bi * split * t // 32 == 512 == -(-1024 // 32) * _max_split(1024, 32)


# -- the split sum against the JAX package ------------------------------------


@pytest.mark.parametrize("exclude_diagonal", [True, False])
@pytest.mark.parametrize("batch,n,m,half", [(1, 1, 1, 20.0), (1, 77, 77, 8.0),
                                            (1, 300, 300, 20.0), (1, 1024, 1024, 20.0),
                                            (3, 128, 128, 8.0), (1, 300, 77, 8.0),
                                            (2, 64, 300, 8.0)])
def test_split_partials_match_jax(batch, n, m, half, exclude_diagonal):
    rng = np.random.default_rng(n * 3 + m + batch)
    pos_i = rng.uniform(-half, half, (batch, n, 2)).astype(np.float32)
    vel_i = rng.uniform(-1, 1, (batch, n, 2)).astype(np.float32)
    if n == m:  # a shard against its own block, as on ring hop 0
        pos_j, vel_j = pos_i, vel_i
    else:
        pos_j = rng.uniform(-half, half, (batch, m, 2)).astype(np.float32)
        vel_j = rng.uniform(-1, 1, (batch, m, 2)).astype(np.float32)
    got = _split_partials(*(torch.from_numpy(x) for x in (pos_i, vel_i, pos_j, vel_j)),
                          BoidsConfig(), exclude_diagonal)
    for b in range(batch):
        want = jboids.boids_partials_tiled(jnp.asarray(pos_i[b]), jnp.asarray(vel_i[b]),
                                           jnp.asarray(pos_j[b]), jnp.asarray(vel_j[b]),
                                           JBoidsConfig(), exclude_diagonal)
        for name, g, w in zip(NAMES, got, want):
            w = np.asarray(w)
            if name.startswith("cnt"):
                np.testing.assert_array_equal(g[b].numpy(), w, err_msg=name)
            else:
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(g[b].numpy(), w, rtol=3e-5, atol=1e-6 * scale,
                                           err_msg=name)


def test_split_partials_fire_every_rule_and_mask_only_the_diagonal():
    """The clustered case has neighbours under every threshold, so counts,
    separation and alignment are exercised; exclude_diagonal takes exactly
    one cohesion and one alignment pair from each agent (itself)."""
    rng = np.random.default_rng(4)
    pos = torch.from_numpy(rng.uniform(-8, 8, (2, 300, 2)).astype(np.float32))
    vel = torch.from_numpy(rng.uniform(-1, 1, (2, 300, 2)).astype(np.float32))
    cfg = BoidsConfig()
    assert boids_ops.boids_partials_plan(2, 300, 300, H100_SMS)[2] > 1  # split on an H100
    with_self = _split_partials(pos, vel, pos, vel, cfg, False)
    without = _split_partials(pos, vel, pos, vel, cfg, True)
    assert without[1].min() > 0 and without[4].min() > 0 and without[2].abs().max() > 0
    assert torch.equal(with_self[1] - without[1], torch.ones_like(without[1]))
    assert torch.equal(with_self[4] - without[4], torch.ones_like(without[4]))
    whole = dense.boids_partials_cross(pos, vel, pos, vel, cfg, exclude_diagonal=True)
    for name, g, w in zip(NAMES, without, whole):
        torch.testing.assert_close(g, w, rtol=3e-5, atol=1e-6 * max(1.0, w.abs().max().item()),
                                   msg=name)


def test_split_partials_keep_their_bits_with_sentinel_padding():
    """The ring pads the agent axis with far sentinels (1e17), which fail
    every threshold: a padded j-block keeps the plan's rank boundaries (the
    last rank takes the padding), so each rank adds the same terms in the
    same order and the sums keep their bits."""
    rng = np.random.default_rng(6)
    for n, pad in ((100, 28), (300, 7), (1024, 300)):
        pos = torch.from_numpy(rng.uniform(-20, 20, (n, 2)).astype(np.float32))
        vel = torch.from_numpy(rng.uniform(-1, 1, (n, 2)).astype(np.float32))
        far = torch.full((pad, 2), 1e17)
        got = _split_partials(pos, vel, torch.cat([pos, far]), torch.cat([vel, far]),
                              BoidsConfig(), False)
        want = _split_partials(pos, vel, pos, vel, BoidsConfig(), False)
        for name, g, w in zip(NAMES, got, want):
            assert torch.equal(g, w), (n, pad, name)
