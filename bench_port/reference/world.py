"""The world's equations in plain PyTorch: all-pairs gravity, the agents'
headings, the actuated step and the spawn draws.

A restatement of the reference simulation (github.com/Dasch0/nenbody,
src/main.rs:404-441 and 736-747) for the benchmark's comparisons. It
imports nothing of the program under test. Every function takes any float
dtype: the benchmark's control runs them in bfloat16.
"""

from __future__ import annotations

import torch

# pairs of one [rows, M] block of the all-pairs sums
PAIR_BUDGET = 1 << 25


def gravity(pos: torch.Tensor, g: float, bias: float, rows: torch.Tensor | None = None,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-agent gravity, g_i = g * sum_j (x_j - x_i) / (|x_j - x_i|^2 + bias),
    the self-pair included (src/main.rs:425-432). pos [..., N, 2] ->
    [..., N, 2], or [..., R, 2] for the agents `rows` [R] alone; in blocks
    of rows, computed in `dtype` and returned in float32."""
    p = pos.to(dtype)
    pi = p if rows is None else p[..., rows, :]
    n_i, n_j = pi.shape[-2], p.shape[-2]
    batch = p[..., 0, 0].numel()
    chunk = max(1, PAIR_BUDGET // max(1, batch * n_j))
    rows_out = []
    for i in range(0, n_i, chunk):
        blk = pi[..., i:i + chunk, :]
        diff = p[..., None, :, :] - blk[..., :, None, :]
        dx, dy = diff[..., 0], diff[..., 1]
        d2 = dx * dx + dy * dy + bias
        rows_out.append(g * (diff / d2[..., None]).sum(dim=-2))
    return torch.cat(rows_out, dim=-2).float()


def heading(vel: torch.Tensor) -> torch.Tensor:
    """Unit look direction atan2(v_y, v_x) as (cos, sin) (src/main.rs:141-143):
    a zero velocity faces +x."""
    th = torch.atan2(vel[..., 1], vel[..., 0])
    return torch.stack([torch.cos(th), torch.sin(th)], dim=-1)


def integrate(pos, vel, force, action, dt: float, max_accel: float | None,
              dt_on_position: bool = False, dtype: torch.dtype = torch.float32):
    """Semi-implicit Euler with the reference's quirk: v += (g + a) dt, then
    x += v (no dt on the position unless `dt_on_position`); the action `a`
    clipped to [-max_accel, max_accel] (None: no action). Returns float32."""
    p, v, f = pos.to(dtype), vel.to(dtype), force.to(dtype)
    acc = f if action is None else f + action.to(dtype).clamp(-max_accel, max_accel)
    v2 = v + acc * dt
    p2 = p + v2 * (dt if dt_on_position else 1.0)
    return p2.float(), v2.float()


def spawn(generator: torch.Generator, shape, pos_range, vel_range, device):
    """Positions U(pos_range)^2 then velocities U(vel_range)^2 of `shape`
    [..., N, 2] (src/main.rs:736-747), two draws from `generator` in that
    order, each u * (hi - lo) + lo of a float32 uniform."""
    def uniform(lo, hi):
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return u * (hi - lo) + lo

    pos = uniform(*pos_range)
    return pos, uniform(*vel_range)
