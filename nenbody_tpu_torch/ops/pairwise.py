"""All-pairs gravity forces on the hand-written CUDA kernel (counterpart of
nenbody_tpu/ops/pairwise.py, whose Pallas `_gravity_kernel` the kernel in
nenbody_tpu_torch/csrc/gravity.cu replaces).

    g_i = G * sum_j (x_j - x_i) / (|x_j - x_i|^2 + bias)

Self-pair included exactly as in the reference. `pos_j` gives the force of
another position set (the cross-block form a ring hop needs). Leading batch
dims go to the kernel as one grid dimension.

The kernel is forward-only for now; its backward (the Pallas
`_gravity_vjp_kernel`) comes with the trainers.
"""

from __future__ import annotations

import torch

from ..config import GravityConfig
from ..physics import dense
from .common import (
    KERNELS, check_batch, check_kernel_args, flat_batch, stream_handle, use_kernel,
)

# Elements of one [..., chunk, M] pair tensor the plain version materializes.
PLAIN_PAIR_BUDGET = 1 << 24


def gravity_forces_plain(
    pos: torch.Tensor, cfg: GravityConfig, pos_j: torch.Tensor | None = None
) -> torch.Tensor:
    """The kernel's plain PyTorch version: physics.dense.gravity_forces_cross,
    chunked over i so that large N fits in memory. Any float dtype (the
    float64 form is the reference for large-N error bounds)."""
    src = pos if pos_j is None else pos_j
    n, m = pos.shape[-2], src.shape[-2]
    batch = pos[..., 0, 0].numel()
    chunk = max(1, PLAIN_PAIR_BUDGET // max(1, batch * m))
    if chunk >= n:
        return dense.gravity_forces_cross(pos, src, cfg)
    return torch.cat(
        [dense.gravity_forces_cross(pos[..., i:i + chunk, :], src, cfg)
         for i in range(0, n, chunk)],
        dim=-2,
    )


def _gravity_cuda(pos, cfg: GravityConfig, pos_j) -> torch.Tensor:
    src = pos if pos_j is None else pos_j
    check_kernel_args("gravity", pos, src)
    if src.shape[:-2] != pos.shape[:-2]:
        raise ValueError(
            f"gravity: batch dims differ, {tuple(pos.shape)} vs {tuple(src.shape)}"
        )
    pi, pj = flat_batch(pos), flat_batch(src)
    batch, n, m = pi.shape[0], pi.shape[1], pj.shape[1]
    check_batch("gravity", batch)
    out = torch.empty_like(pos)
    KERNELS["gravity"].launch(
        pi.data_ptr(), pj.data_ptr(), out.data_ptr(), batch, n, m,
        cfg.g, cfg.bias, int(cfg.approx_reciprocal), stream_handle(),
    )
    return out


def gravity_forces_tiled(
    pos: torch.Tensor, cfg: GravityConfig, pos_j: torch.Tensor | None = None
) -> torch.Tensor:
    """Forces on pos [..., N, 2] (from pos_j [..., M, 2] when given):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if use_kernel(pos) if pos_j is None else use_kernel(pos, pos_j):
        return _gravity_cuda(pos, cfg, pos_j)
    return gravity_forces_plain(pos, cfg, pos_j)
