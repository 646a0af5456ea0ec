"""Fused flocking rules on the hand-written CUDA kernel (counterpart of
nenbody_tpu/ops/boids.py, whose Pallas `_boids_kernel` the kernel in
nenbody_tpu_torch/csrc/boids.cu replaces).

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
