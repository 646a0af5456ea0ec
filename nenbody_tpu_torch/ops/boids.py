"""Flocking rules on hand-written CUDA kernels (counterpart of
nenbody_tpu/ops/boids.py): the fused rules (csrc/boids.cu replaces its
Pallas `_boids_kernel`) and the raw cross-block rule sums of a ring hop
(`boids_partials_tiled`; csrc/boids_partials.cu replaces
`_boids_partials_kernel`).

Reference semantics preserved exactly (see config.BoidsConfig): squared
cohesion threshold, unsquared separation threshold, alignment measured in
velocity space, self excluded by index, guarded means; the result REPLACES
the velocity, and the speed clamp and x += v*dt happen outside (ops.tiled).

With `global_alignment` the kernel skips the alignment fold and the exact
O(N) global mean sum_{j != i} v_j / (n - 1) is added here, in torch
(nenbody_tpu/ops/boids.py:296-302).
"""

from __future__ import annotations

import torch

from ..config import BoidsConfig
from ..physics import dense
from .common import (
    KERNELS, check_batch, check_kernel_args, flat_batch, stream_handle, use_kernel,
)

# Elements of one [..., chunk, N] pair tensor the plain version materializes.
PLAIN_PAIR_BUDGET = 1 << 24


def boids_velocity_plain(
    pos: torch.Tensor, vel: torch.Tensor, cfg: BoidsConfig, skip_alignment: bool = False
) -> torch.Tensor:
    """The kernel's plain PyTorch version: physics.dense's partials and
    finalize, chunked over i for large N; `skip_alignment` leaves rule 3 out
    as the kernel does under global_alignment."""
    n = pos.shape[-2]
    batch = pos[..., 0, 0].numel()
    chunk = max(1, PLAIN_PAIR_BUDGET // max(1, batch * n))
    parts = []
    for i in range(0, n, chunk):
        partials = dense.boids_partials_cross(
            pos[..., i:i + chunk, :], vel[..., i:i + chunk, :], pos, vel, cfg,
            exclude_diagonal=True, i_offset=i, skip_alignment=skip_alignment,
        )
        parts.append(dense.boids_finalize(partials, cfg))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def _boids_cuda(pos, vel, cfg: BoidsConfig, skip_alignment: bool) -> torch.Tensor:
    check_kernel_args("boids", pos, vel)
    if pos.shape != vel.shape:
        raise ValueError(f"boids: pos {tuple(pos.shape)} vs vel {tuple(vel.shape)}")
    p, v = flat_batch(pos), flat_batch(vel)
    batch, n = p.shape[0], p.shape[1]
    check_batch("boids", batch)
    out = torch.empty_like(pos)
    KERNELS["boids"].launch(
        p.data_ptr(), v.data_ptr(), out.data_ptr(), batch, n,
        cfg.cohesion_dist_sq,
        cfg.separation_dist * cfg.separation_dist,
        cfg.alignment_dist * cfg.alignment_dist,
        cfg.cohesion_scale, cfg.separation_scale, cfg.alignment_scale,
        int(skip_alignment), stream_handle(),
    )
    return out


def boids_velocity_tiled(
    pos: torch.Tensor, vel: torch.Tensor, cfg: BoidsConfig
) -> torch.Tensor:
    """The replacement velocity before the speed clamp, pos, vel [..., N, 2]
    -> [..., N, 2]: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    skip = cfg.global_alignment
    if use_kernel(pos, vel):
        nv = _boids_cuda(pos, vel, cfg, skip)
    else:
        nv = boids_velocity_plain(pos, vel, cfg, skip)
    n = pos.shape[-2]
    if skip and n > 1:
        # rule 3 as the exact global mean: sum_{j!=i} v_j / (n-1); identical
        # to the masked fold whenever all speeds <= alignment_dist/2.
        total = vel.sum(dim=-2, keepdim=True)
        nv = nv + cfg.alignment_scale * ((total - vel) / (n - 1))
    return nv


def boids_partials_plain(pos_i, vel_i, pos_j, vel_j, cfg: BoidsConfig,
                         exclude_diagonal: bool = True):
    """The partials kernel's plain PyTorch version:
    physics.dense.boids_partials_cross, chunked over i for large blocks."""
    n, m = pos_i.shape[-2], pos_j.shape[-2]
    batch = pos_i[..., 0, 0].numel()
    chunk = max(1, PLAIN_PAIR_BUDGET // max(1, batch * m))
    parts = [
        dense.boids_partials_cross(pos_i[..., i:i + chunk, :], vel_i[..., i:i + chunk, :],
                                   pos_j, vel_j, cfg, exclude_diagonal=exclude_diagonal,
                                   i_offset=i)
        for i in range(0, n, chunk)
    ]
    if len(parts) == 1:
        return parts[0]
    # the sums are [..., N, 2], the counts [..., N]
    return tuple(torch.cat([p[k] for p in parts], dim=-1 if k in (1, 4) else -2)
                 for k in range(5))


def _boids_partials_cuda(pos_i, vel_i, pos_j, vel_j, cfg: BoidsConfig, exclude_diagonal):
    check_kernel_args("boids_partials", pos_i, vel_i, pos_j, vel_j)
    if (pos_i.shape != vel_i.shape or pos_j.shape != vel_j.shape
            or pos_i.shape[:-2] != pos_j.shape[:-2]):
        raise ValueError(
            f"boids_partials: i-block {tuple(pos_i.shape)}/{tuple(vel_i.shape)} and j-block "
            f"{tuple(pos_j.shape)}/{tuple(vel_j.shape)} must share batch dims"
        )
    pi, vi = flat_batch(pos_i), flat_batch(vel_i)
    pj, vj = flat_batch(pos_j), flat_batch(vel_j)
    batch, n, m = pi.shape[0], pi.shape[1], pj.shape[1]
    check_batch("boids_partials", batch)
    sum1, repel, sum3 = (torch.empty_like(pos_i) for _ in range(3))
    cnt1, cnt3 = (torch.empty(pos_i.shape[:-1], dtype=torch.float32, device=pos_i.device)
                  for _ in range(2))
    KERNELS["boids_partials"].launch(
        pi.data_ptr(), vi.data_ptr(), pj.data_ptr(), vj.data_ptr(), sum1.data_ptr(),
        cnt1.data_ptr(), repel.data_ptr(), sum3.data_ptr(), cnt3.data_ptr(), batch, n, m,
        cfg.cohesion_dist_sq,
        cfg.separation_dist * cfg.separation_dist,
        cfg.alignment_dist * cfg.alignment_dist,
        int(exclude_diagonal), stream_handle(),
    )
    return sum1, cnt1, repel, sum3, cnt3


def boids_partials_tiled(
    pos_i: torch.Tensor,
    vel_i: torch.Tensor,
    pos_j: torch.Tensor,
    vel_j: torch.Tensor,
    cfg: BoidsConfig,
    exclude_diagonal: bool = True,
):
    """Raw rule sums of the j-block [..., M, 2] against the i-block
    [..., N, 2]: (sum1 [..., N, 2], cnt1 [..., N], repel [..., N, 2],
    sum3 [..., N, 2], cnt3 [..., N]), additive across j-blocks; finish with
    physics.dense.boids_finalize. `exclude_diagonal` masks the pairs i == j
    by index (the ring's hop 0, where the blocks alias). The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if use_kernel(pos_i, vel_i, pos_j, vel_j):
        return _boids_partials_cuda(pos_i, vel_i, pos_j, vel_j, cfg, exclude_diagonal)
    return boids_partials_plain(pos_i, vel_i, pos_j, vel_j, cfg, exclude_diagonal)
