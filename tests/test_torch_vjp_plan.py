"""The gravity VJP kernel's launch plan (ops.pairwise.gravity_vjp_plan, the
twin of csrc/gravity_vjp.cu's) and its split sum on the CPU, against the JAX
package.

- The plan is pair_plan with the VJP's constants, covers every j once in
  rank order with whole tiles per rank, and fills the card at 132 SMs at the
  path shapes: the self form at config 4 (N=65,536), at the trainers' width
  (4,096 envs x 256) and on the 2 x 2 mesh's shards (2,048 x 128), the cross
  form at a ring hop of config 4 on 4 shards (16,384 x 16,384) and on the
  2 x 2 mesh (2,048 x 128 x 128), both its launches.
- The kernel's split sum in plain PyTorch (each rank's closed-form pair
  terms over its j chunk, u_j - u_k taken before any product, added in rank
  order, then scaled by G) matches the JAX package's Pallas VJP
  (nenbody_tpu.ops.pairwise.gravity_vjp_tiled, in interpret mode on the CPU)
  and its custom VJP (jax.vjp of gravity_forces_diff) under
  tests/test_kernels.py:141-155's normalised bound, at N = 1, 77, 300 and
  1,024 and a batch; the cross form's two launches (rows and columns, each
  with its own plan) match jax.vjp of the JAX dense cross forces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu.config import GravityConfig as JGravityConfig
from nenbody_tpu.ops import pairwise as jpairwise
from nenbody_tpu.physics import dense as jdense

from nenbody_tpu_torch.config import GravityConfig
from nenbody_tpu_torch.ops import pairwise

torch.set_num_threads(1)

H100_SMS = 132
VJP_BOUND = 3e-5  # |got - want| / max|want| (tests/test_kernels.py:141-155)


def _pair_sum(xs, us, ys, vs, form, bias):
    """sum over the given j of A(x_k - y_j) w, unscaled, in the kernel's
    order of operations: w = u_j - u_k ("self"), u_k ("rows") or v_j
    ("cols")."""
    rx = xs[..., :, None, 0] - ys[..., None, :, 0]
    ry = xs[..., :, None, 1] - ys[..., None, :, 1]
    d2 = rx * rx + ry * ry + bias
    if form == "self":
        wx = vs[..., None, :, 0] - us[..., :, None, 0]
        wy = vs[..., None, :, 1] - us[..., :, None, 1]
    elif form == "rows":
        wx, wy = us[..., :, None, 0].expand_as(rx), us[..., :, None, 1].expand_as(rx)
    else:
        wx, wy = vs[..., None, :, 0].expand_as(rx), vs[..., None, :, 1].expand_as(rx)
    inv = 1.0 / d2
    dot2 = 2.0 * (wx * rx + wy * ry) * (inv * inv)
    return torch.stack([(wx * inv - rx * dot2).sum(-1), (wy * inv - ry * dot2).sum(-1)], -1)


def _split_vjp(xs, us, ys, vs, form, scale, cfg):
    """The kernel's split sum for one launch: rank s's pair terms over
    j in [s chunk, (s + 1) chunk), added in rank order as the cluster's
    leader adds them, times `scale` (G, or -G for the cross form's rows)."""
    batch, n, m = xs[..., 0, 0].numel(), xs.shape[-2], ys.shape[-2]
    _, _, split, chunk, _ = pairwise.gravity_vjp_plan(batch, n, m, H100_SMS)
    total = torch.zeros_like(xs)
    for s in range(split):
        j0, j1 = s * chunk, min(m, (s + 1) * chunk)
        if j0 < j1:
            total = total + _pair_sum(xs, us, ys[..., j0:j1, :],
                                      None if vs is None else vs[..., j0:j1, :], form, cfg.bias)
    return scale * total


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _hold(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    if scale == 0.0:
        assert not got.any()
        return
    err = np.abs(got.numpy() - want).max() / scale
    assert err < VJP_BOUND, err


# -- the plan ------------------------------------------------------------------


def _max_split(m, t):
    s = 1
    while s < pairwise.PAIR_MAX_SPLIT and m >= 2 * s * t:
        s *= 2
    return s


@pytest.mark.parametrize("sms", [1, 16, 132])
def test_vjp_plan_covers_j_once_and_fills_the_card(sms):
    target = pairwise.GRAVITY_VJP_MIN_WARPS_PER_SM * sms
    for batch in (1, 2, 3, 64, 2048, 4096):
        for n in (1, 2, 31, 32, 77, 100, 128, 129, 256, 300, 1024, 16384, 65537):
            for m in (1, 77, n, 4 * n + 5):
                plan = pairwise.gravity_vjp_plan(batch, n, m, sms)
                t, r, split, chunk, bi = plan
                where = f"batch={batch} n={n} m={m} sms={sms}: {plan}"
                assert plan == pairwise.pair_plan(batch, n, m, sms,
                                                  pairwise.GRAVITY_VJP_MIN_WARPS_PER_SM), where
                assert t in (32, 64, 128, 256) and r in (1, 2), where
                assert r == 1 or n >= t * r, where
                assert t == 32 or 2 * n > t, where  # no block half idle or worse
                assert bi == -(-n // (t * r)), where
                assert 1 <= split <= pairwise.PAIR_MAX_SPLIT and split & (split - 1) == 0, where
                assert split == 1 and chunk == m or chunk % t == 0, where
                owner = torch.zeros(m, dtype=torch.int64)
                for s in range(split):  # rank s owns [s chunk, (s + 1) chunk): in rank order
                    owner[s * chunk:(s + 1) * chunk] += 1
                assert bool((owner == 1).all()) and split * chunk >= m, where
                assert split == 1 or chunk < -(-m // split) + t, where
                if batch * -(-n // 32) * _max_split(m, 32) >= target:
                    assert batch * bi * split * t // 32 >= target, where


# (label, batch, n, m, the plan on an H100)
PATH_PLANS = [
    ("config 4, self", 1, 65536, 65536, (256, 2, 2, 32768, 128)),
    ("trainers' width, self", 4096, 256, 256, (256, 1, 1, 256, 1)),
    ("2 x 2 mesh shard, self and both cross launches", 2048, 128, 128, (128, 1, 1, 128, 1)),
    ("ring hop at config 4 on 4 shards, both cross launches", 1, 16384, 16384,
     (256, 2, 8, 2048, 32)),
]


@pytest.mark.parametrize("label,batch,n,m,plan", PATH_PLANS, ids=[p[0] for p in PATH_PLANS])
def test_vjp_plan_at_the_path_shapes(label, batch, n, m, plan):
    """Each path shape fills the card (at least 8 warps an SM on 132 SMs);
    the 2 x 2 mesh's 128-body shards take 128-thread blocks, none idle."""
    got = pairwise.gravity_vjp_plan(batch, n, m, H100_SMS)
    assert got == plan
    t, r, split, _, bi = got
    assert batch * bi * split * t // 32 >= pairwise.GRAVITY_VJP_MIN_WARPS_PER_SM * H100_SMS
    assert bi * t * r - n < t  # no idle thread beyond the ragged tail


def test_half_idle_blocks_are_passed_over():
    """A batch of shards of n <= 128 bodies: the block is the smallest power
    of two of at least n threads (32 at least), as for gravity and boids."""
    for n, t in ((128, 128), (100, 128), (64, 64), (33, 64), (32, 32), (5, 32)):
        assert pairwise.gravity_vjp_plan(4096, n, n, H100_SMS)[0] == t
        assert pairwise.gravity_plan(4096, n, n, H100_SMS)[0] == t


# -- the split sum against the JAX package ------------------------------------


@pytest.mark.parametrize("batch,n", [(1, 1), (1, 77), (1, 300), (1, 1024), (3, 300)])
def test_split_vjp_sum_matches_jax(batch, n):
    rng = np.random.default_rng(n + 10 * batch)
    pos = rng.uniform(-100, 100, (batch, n, 2)).astype(np.float32)
    u = rng.standard_normal((batch, n, 2)).astype(np.float32)
    cfg, jcfg = GravityConfig(), JGravityConfig()
    if n > 1:
        assert pairwise.gravity_vjp_plan(batch, n, n, H100_SMS)[2] > 1  # split on an H100
    p, c = _t(pos), _t(u)
    got = _split_vjp(p, c, p, c, "self", cfg.g, cfg)
    for b in range(batch):
        want = jpairwise.gravity_vjp_tiled(jnp.asarray(pos[b]), jnp.asarray(u[b]), jcfg)
        _hold(got[b], want)
        _, vjp_fn = jax.vjp(lambda q: jpairwise.gravity_forces_diff(q, jcfg), jnp.asarray(pos[b]))
        _hold(got[b], vjp_fn(jnp.asarray(u[b]))[0])
        if n == 1:  # the self-pair alone: exactly 0
            assert torch.equal(got[b], torch.zeros_like(got[b]))


def test_split_vjp_sum_equals_the_plain_version():
    """The split sum and the port's plain version (one chunk) agree within the
    bound: splitting j changes only the summation order."""
    rng = np.random.default_rng(3)
    p = _t(rng.uniform(-100, 100, (2, 1024, 2)).astype(np.float32))
    c = _t(rng.standard_normal((2, 1024, 2)).astype(np.float32))
    cfg = GravityConfig()
    want = pairwise.gravity_vjp_plain(p, c, cfg)
    got = _split_vjp(p, c, p, c, "self", cfg.g, cfg)
    assert ((got - want).abs().max() / want.abs().max()).item() < VJP_BOUND


@pytest.mark.parametrize("batch,n,m", [(1, 1, 1), (1, 64, 300), (1, 300, 77), (2, 128, 128),
                                       (1, 1024, 1024)])
def test_split_vjp_cross_sums_match_jax(batch, n, m):
    """The cross form's rows (-G, w = u_i, the rows' plan) and columns (+G,
    w = u_i over the i set, the columns' plan) against jax.vjp of the JAX
    dense cross forces."""
    rng = np.random.default_rng(n * 7 + m)
    pos_i = rng.uniform(-100, 100, (batch, n, 2)).astype(np.float32)
    pos_j = rng.uniform(-100, 100, (batch, m, 2)).astype(np.float32)
    u = rng.standard_normal((batch, n, 2)).astype(np.float32)
    cfg, jcfg = GravityConfig(), JGravityConfig()
    xi, yj, c = _t(pos_i), _t(pos_j), _t(u)
    d_i = _split_vjp(xi, c, yj, None, "rows", -cfg.g, cfg)
    d_j = _split_vjp(yj, None, xi, c, "cols", cfg.g, cfg)
    for b in range(batch):
        _, vjp_fn = jax.vjp(lambda a, q: jdense.gravity_forces_cross(a, q, jcfg),
                            jnp.asarray(pos_i[b]), jnp.asarray(pos_j[b]))
        want_i, want_j = vjp_fn(jnp.asarray(u[b]))
        _hold(d_i[b], want_i)
        _hold(d_j[b], want_j)


def test_split_vjp_far_sentinels_add_nothing_measurable():
    """The ring's far sentinels (1e17): 1/d2 = 1e-34 and its square
    underflows to 0, so a padded j block moves no output by more than the
    bound (the terms it adds are below 1e-30)."""
    rng = np.random.default_rng(11)
    p = _t(rng.uniform(-100, 100, (1, 100, 2)).astype(np.float32))
    c = _t(rng.standard_normal((1, 100, 2)).astype(np.float32))
    pad = torch.full((1, 28, 2), 1e17)
    cfg = GravityConfig()
    got = _split_vjp(p, c, torch.cat([p, pad], -2), None, "rows", -cfg.g, cfg)
    want = _split_vjp(p, c, p, None, "rows", -cfg.g, cfg)
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() < VJP_BOUND
    sentinel = _pair_sum(p, c, pad, None, "rows", cfg.bias)
    assert sentinel.abs().max().item() < 1e-30
