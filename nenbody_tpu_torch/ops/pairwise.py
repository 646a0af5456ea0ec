"""All-pairs gravity forces and their pullback on hand-written CUDA kernels
(counterpart of nenbody_tpu/ops/pairwise.py: csrc/gravity.cu replaces its
Pallas `_gravity_kernel`, csrc/gravity_vjp.cu its `_gravity_vjp_kernel`).

    g_i = G * sum_j (x_j - x_i) / (|x_j - x_i|^2 + bias)

Self-pair included exactly as in the reference. `pos_j` gives the force of
another position set (the cross-block form a ring hop needs). Leading batch
dims go to the kernel as one grid dimension.

`gravity_forces_diff` is the differentiable form (the JAX custom VJP
`gravity_forces_diff`): a torch.autograd.Function whose backward is the VJP
kernel. Its cross form, `GravityForcesCrossDiff`, has the VJP source's cross
entry point as its backward (d pos_i and d pos_j). `gravity_forces_tiled`
routes through one of them when autograd needs the op.
"""

from __future__ import annotations

import torch

from ..config import GravityConfig
from ..physics import dense
from .common import (
    KERNELS, check_batch, check_kernel_args, flat_batch, needs_grad, stream_handle,
    use_kernel,
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


def _gravity_forward(pos, cfg: GravityConfig, pos_j) -> torch.Tensor:
    if use_kernel(pos) if pos_j is None else use_kernel(pos, pos_j):
        return _gravity_cuda(pos, cfg, pos_j)
    return gravity_forces_plain(pos, cfg, pos_j)


def gravity_forces_tiled(
    pos: torch.Tensor, cfg: GravityConfig, pos_j: torch.Tensor | None = None
) -> torch.Tensor:
    """Forces on pos [..., N, 2] (from pos_j [..., M, 2] when given):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    through `gravity_forces_diff` when autograd needs the op."""
    if needs_grad(pos, pos_j):
        if pos_j is not None:
            return GravityForcesCrossDiff.apply(pos, pos_j, cfg)
        return gravity_forces_diff(pos, cfg)
    return _gravity_forward(pos, cfg, pos_j)


def _gravity_vjp_rows(pos, u, k0: int, k1: int, cfg: GravityConfig) -> torch.Tensor:
    """dL/dx_k for k in [k0, k1): the closed form of gravity_vjp.cu, with
    u_j - u_k taken before any product."""
    xk, uk = pos[..., k0:k1, None, :], u[..., k0:k1, None, :]
    xj, uj = pos[..., None, :, :], u[..., None, :, :]
    rx = xk[..., 0] - xj[..., 0]  # r = x_k - x_j, [..., K, N]
    ry = xk[..., 1] - xj[..., 1]
    d2 = rx * rx + ry * ry + cfg.bias
    sux = uj[..., 0] - uk[..., 0]
    suy = uj[..., 1] - uk[..., 1]
    inv = 1.0 / d2
    dot2 = 2.0 * (sux * rx + suy * ry) * (inv * inv)
    ox = (sux * inv - rx * dot2).sum(dim=-1)
    oy = (suy * inv - ry * dot2).sum(dim=-1)
    return cfg.g * torch.stack([ox, oy], dim=-1)


def gravity_vjp_plain(pos: torch.Tensor, u: torch.Tensor, cfg: GravityConfig) -> torch.Tensor:
    """The VJP kernel's plain PyTorch version: the closed form chunked over
    k so that large N fits in memory. Any float dtype."""
    n = pos.shape[-2]
    batch = pos[..., 0, 0].numel()
    chunk = max(1, PLAIN_PAIR_BUDGET // max(1, batch * n))
    return torch.cat(
        [_gravity_vjp_rows(pos, u, k, min(k + chunk, n), cfg) for k in range(0, n, chunk)],
        dim=-2,
    )


def _gravity_vjp_cuda(pos, u, cfg: GravityConfig) -> torch.Tensor:
    check_kernel_args("gravity_vjp", pos, u)
    if u.shape != pos.shape:
        raise ValueError(f"gravity_vjp: u {tuple(u.shape)} vs pos {tuple(pos.shape)}")
    pb, ub = flat_batch(pos), flat_batch(u)
    batch, n = pb.shape[0], pb.shape[1]
    check_batch("gravity_vjp", batch)
    out = torch.empty_like(pos)
    KERNELS["gravity_vjp"].launch(
        pb.data_ptr(), ub.data_ptr(), out.data_ptr(), batch, n, cfg.g, cfg.bias,
        stream_handle(),
    )
    return out


def gravity_vjp_tiled(pos: torch.Tensor, u: torch.Tensor, cfg: GravityConfig) -> torch.Tensor:
    """Pullback of the forces: cotangent u [..., N, 2] -> dL/dpos [..., N, 2].
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Always the exact divide, whatever cfg.approx_reciprocal says."""
    if use_kernel(pos, u):
        return _gravity_vjp_cuda(pos, u, cfg)
    return gravity_vjp_plain(pos, u, cfg)


class GravityForcesDiff(torch.autograd.Function):
    """Self-interaction forces with the VJP kernel as their backward
    (pairwise.py:244-259 of the JAX package)."""

    @staticmethod
    def forward(ctx, pos: torch.Tensor, cfg: GravityConfig) -> torch.Tensor:
        ctx.cfg = cfg
        ctx.save_for_backward(pos)
        return _gravity_forward(pos, cfg, None)

    @staticmethod
    def backward(ctx, u: torch.Tensor):
        (pos,) = ctx.saved_tensors
        return gravity_vjp_tiled(pos, u.contiguous(), ctx.cfg), None


def gravity_forces_diff(pos: torch.Tensor, cfg: GravityConfig) -> torch.Tensor:
    """gravity_forces_tiled(pos, cfg), differentiable through the VJP kernel."""
    return GravityForcesDiff.apply(pos, cfg)


def gravity_vjp_cross_plain(
    pos_i: torch.Tensor, pos_j: torch.Tensor, u: torch.Tensor, cfg: GravityConfig
):
    """The cross VJP's plain PyTorch version: autograd through
    physics.dense.gravity_forces_cross, chunk by chunk over i so that each
    chunk's [..., chunk, M] pair tensors stay within PLAIN_PAIR_BUDGET
    elements. Any float dtype. Returns (d pos_i, d pos_j)."""
    n, m = pos_i.shape[-2], pos_j.shape[-2]
    batch = pos_i[..., 0, 0].numel()
    chunk = max(1, PLAIN_PAIR_BUDGET // max(1, batch * m))
    d_i = []
    d_j = torch.zeros_like(pos_j)
    with torch.enable_grad():
        pj = pos_j.detach().requires_grad_()
        for i in range(0, n, chunk):
            pi = pos_i[..., i:i + chunk, :].detach().requires_grad_()
            g = dense.gravity_forces_cross(pi, pj, cfg)
            gi, gj = torch.autograd.grad(g, (pi, pj), u[..., i:i + chunk, :])
            d_i.append(gi)
            d_j += gj
    return torch.cat(d_i, dim=-2), d_j


def _gravity_vjp_cross_cuda(pos_i, pos_j, u, cfg: GravityConfig):
    check_kernel_args("gravity_vjp", pos_i, pos_j, u)
    if u.shape != pos_i.shape or pos_j.shape[:-2] != pos_i.shape[:-2]:
        raise ValueError(
            f"gravity_vjp: u {tuple(u.shape)}, pos_i {tuple(pos_i.shape)} and pos_j "
            f"{tuple(pos_j.shape)} must share batch dims"
        )
    pi, pj, ub = flat_batch(pos_i), flat_batch(pos_j), flat_batch(u)
    batch, n, m = pi.shape[0], pi.shape[1], pj.shape[1]
    check_batch("gravity_vjp", batch)
    g_i, g_j = torch.empty_like(pos_i), torch.empty_like(pos_j)
    KERNELS["gravity_vjp"].launch(
        pi.data_ptr(), pj.data_ptr(), ub.data_ptr(), g_i.data_ptr(), g_j.data_ptr(),
        batch, n, m, cfg.g, cfg.bias, stream_handle(), entry="nbt_gravity_vjp_cross",
    )
    return g_i, g_j


def gravity_vjp_cross_tiled(
    pos_i: torch.Tensor, pos_j: torch.Tensor, u: torch.Tensor, cfg: GravityConfig
):
    """Pullback of the forces by pos_j [..., M, 2] on pos_i [..., N, 2]:
    cotangent u [..., N, 2] -> (d pos_i [..., N, 2], d pos_j [..., M, 2]).
    The VJP source's cross entry point for CUDA tensors, the plain version
    for CPU tensors. Always the exact divide."""
    if use_kernel(pos_i, pos_j, u):
        return _gravity_vjp_cross_cuda(pos_i, pos_j, u, cfg)
    return gravity_vjp_cross_plain(pos_i, pos_j, u, cfg)


class GravityForcesCrossDiff(torch.autograd.Function):
    """The forces by pos_j on pos_i with the cross VJP as their backward: a
    ring hop past the first (parallel/ring.py). When the two are one tensor,
    autograd adds the two shares."""

    @staticmethod
    def forward(ctx, pos_i: torch.Tensor, pos_j: torch.Tensor, cfg: GravityConfig):
        ctx.cfg = cfg
        ctx.save_for_backward(pos_i, pos_j)
        return _gravity_forward(pos_i, cfg, pos_j)

    @staticmethod
    def backward(ctx, u: torch.Tensor):
        pos_i, pos_j = ctx.saved_tensors
        g_i, g_j = gravity_vjp_cross_tiled(pos_i, pos_j, u.contiguous(), ctx.cfg)
        return g_i, g_j, None
