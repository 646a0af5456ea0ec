"""The RDMA ring's gravity kernel (csrc/rdma_ring.cu, rdma_gravity_kernel)
on the CPU: its launch plan and a plain model of its summation order,
against the JAX package.

- The plan (parallel/rdma.py::rdma_gravity_plan, the twin of the kernel's
  rdma_gravity_plan; tests/test_torch_cuda_kernels.py holds the two equal on
  the card) gives each (env, T x R rows) unit to a block whose thread t
  holds rows t + r T: every row of every env lies in exactly one slot, a
  thread without a row sits only in an env's last unit (the ragged tail), a
  block of more than one warp is more than half used, and R = 2 only where
  an env fills a whole unit. It aims at RDMA_GRAVITY_MIN_WARPS_PER_SM warps
  an SM with the card's shards counted together; its shapes at config 4
  (N=65,536) and at config-5 width (4,096 envs x 256) on 4 shards of an
  H100 (132 SMs) are pinned.
- The kernel's order in plain float32 numpy: per shard and hop, each unit's
  rows summed from zero over the circulating block's env segment in j
  order (the pair with the kernel's explicit fma, the exact divide where
  the kernel takes rcp.approx and a Newton step, within an ulp), then the
  hops added in ring order, times G. It matches the JAX package's
  rdma_ring_gravity_forces (its Pallas kernel in interpret mode, RDMA
  emulated on the suite's virtual CPU devices) and JAX dense at
  tests/test_rdma_ring.py's gravity tolerance (rtol 2e-5 / atol 1e-6), at
  ragged rows a shard (37, 203, 300), on 1-4 hops and with a batch of envs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu.parallel import mesh as jmesh
from nenbody_tpu.parallel import rdma as jrdma
from nenbody_tpu.physics import dense as jdense

from nenbody_tpu_torch import SimConfig
from nenbody_tpu_torch.parallel import make_mesh, rdma

torch.set_num_threads(1)

H100_SMS = 132
GRAVITY_TOL = dict(rtol=2e-5, atol=1e-6)
# (nb, nl, shards): config 4 on 4 shards and on 4 cards, config-5 width on
# 4 shards, and the -m cuda test's plan edges (rows a shard T R - 1, T R,
# T R + 1)
PINNED = {(1, 16384, 4): (256, 2, 32), (4096, 64, 4): (64, 1, 4096), (1, 16384, 1): (32, 1, 512),
          (33, 511, 4): (256, 1, 66), (33, 512, 4): (256, 2, 33), (33, 513, 4): (256, 2, 66),
          (1, 31, 2): (32, 1, 1), (1, 32, 2): (32, 1, 1), (1, 33, 2): (32, 1, 2)}


def _slots(t, r, units_per_env):
    """The row of each (unit, r, thread) slot of one env: g T R + r T + t."""
    g, m, i = np.meshgrid(np.arange(units_per_env), np.arange(r), np.arange(t), indexing="ij")
    return g * t * r + m * t + i


# -- the plan ------------------------------------------------------------------


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_plan_covers_every_row_once(sms, shards):
    for nb in (1, 3, 33, 4096):
        for nl in (1, 2, 31, 32, 33, 37, 64, 65, 128, 203, 256, 300, 511, 512, 513, 16384):
            t, r, units = rdma.rdma_gravity_plan(nb, nl, shards, sms)
            assert t in (256, 128, 64, 32) and r in (1, 2)
            assert units % nb == 0
            per_env = units // nb
            rows = _slots(t, r, per_env)
            np.testing.assert_array_equal(np.sort(rows[rows < nl]), np.arange(nl))
            # a thread without a row only in the env's last unit
            idle = (rows >= nl).all(axis=1)  # [unit, thread]
            assert not idle[:-1].any()
            assert t == 32 or 2 * nl > t
            assert r == 1 or nl >= t * r


@pytest.mark.parametrize("sms", [16, 132])
def test_plan_aims_at_the_warps_an_sm(sms):
    """The first (T, R) in pair_plan's order whose warps, the card's shards
    together, reach RDMA_GRAVITY_MIN_WARPS_PER_SM an SM; one-warp blocks of one
    row a thread where none does."""
    target = rdma.RDMA_GRAVITY_MIN_WARPS_PER_SM * sms
    for nb, nl, shards in ((1, 16384, 4), (1, 16384, 1), (4096, 64, 4), (33, 512, 4), (7, 300, 3)):
        t, r, units = rdma.rdma_gravity_plan(nb, nl, shards, sms)
        warps = shards * units * t // 32
        order = [(tt, rr) for tt in (256, 128, 64, 32) for rr in (2, 1)
                 if (tt == 32 or 2 * nl > tt) and (rr == 1 or nl >= tt * rr)]
        fills = [(tt, rr) for tt, rr in order
                 if shards * nb * -(-nl // (tt * rr)) * tt // 32 >= target]
        if fills:
            assert (t, r) == fills[0] and warps >= target
        else:
            assert (t, r) == (32, 1)


def test_plan_pinned_shapes_on_an_h100():
    for (nb, nl, shards), want in PINNED.items():
        assert rdma.rdma_gravity_plan(nb, nl, shards, H100_SMS) == want


# -- the kernel's summation order ------------------------------------------------


def _fma(a, b, c):
    """a b + c in float32 with one rounding, as the kernel's explicit fma
    (the float64 product is exact; its sum with c rounds twice, which moves
    a result by an ulp in about 2^-29 of draws)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _kernel_model(pos: np.ndarray, d: int, g: float, bias: float, sms: int = H100_SMS):
    """The kernel's forces for pos [(B,) N, 2], N = d nl, on d shards of one
    card, in float32: each shard's rows in the plan's slots, each hop's
    partial from zero over the circulating block in j order, the hops added
    in ring order, times G; every row written by exactly one slot."""
    lead = pos.shape[:-2]
    nl = pos.shape[-2] // d
    blocks = pos.reshape((-1, d, nl, 2)).astype(np.float32)  # [nb, shard, row, 2]
    nb = blocks.shape[0]
    t, r, units = rdma.rdma_gravity_plan(nb, nl, d, sms)
    rows = _slots(t, r, units // nb).reshape(-1)
    valid = rows < nl
    rows_c = np.where(valid, rows, 0)
    out = np.full(blocks.shape, np.nan, np.float32)
    bias = np.float32(bias)
    for s in range(d):
        xi = np.where(valid[None, :, None], blocks[:, s, rows_c], np.float32(0))  # [nb, slot, 2]
        total = None
        for k in range(d):
            blk = blocks[:, (s - k) % d]
            gx = np.zeros(xi.shape[:-1], np.float32)
            gy = np.zeros_like(gx)
            for j in range(nl):
                dx = blk[:, j, None, 0] - xi[..., 0]
                dy = blk[:, j, None, 1] - xi[..., 1]
                w = np.float32(1) / _fma(dx, dx, _fma(dy, dy, bias))
                gx = _fma(dx, w, gx)
                gy = _fma(dy, w, gy)
            part = np.stack([gx, gy], -1)
            total = part if total is None else total + part
        assert np.isnan(out[:, s, rows[valid]]).all()  # each row once
        out[:, s, rows[valid]] = np.float32(g) * total[:, valid]
    assert not np.isnan(out).any()
    return out.reshape(lead + (d * nl, 2))


CASES = [(nl, d, ()) for nl in (37, 203, 300) for d in (1, 2, 3, 4)] + [(37, 3, (2,)),
                                                                          (203, 2, (3,))]


@pytest.mark.parametrize("nl,d,batch", CASES)
def test_kernel_order_matches_jax_rdma_and_dense(nl, d, batch):
    n = nl * d
    pos = np.random.RandomState(nl + d).uniform(-100, 100, batch + (n, 2)).astype(np.float32)
    cfg, jcfg = SimConfig(n=n, controller="gravity"), JSimConfig(n=n, controller="gravity")
    got = _kernel_model(pos, d, cfg.gravity.g, cfg.gravity.bias)
    jmesh_d = jmesh.make_mesh({"agents": d}, devices=jax.devices()[:d])
    want_rdma = jrdma.rdma_ring_gravity_forces(jnp.asarray(pos), jcfg, mesh=jmesh_d)
    want_dense = jdense.gravity_forces(jnp.asarray(pos), jcfg.gravity)
    for want in (want_rdma, want_dense):
        np.testing.assert_allclose(got, np.asarray(want), **GRAVITY_TOL)
    # and the port's plain version, which the kernel is held against on the card
    plain = rdma.rdma_ring_gravity_forces_plain(
        torch.from_numpy(pos), cfg, mesh=make_mesh({"agents": d}, devices=["cpu"] * d))
    np.testing.assert_allclose(got, plain.numpy(), **GRAVITY_TOL)
