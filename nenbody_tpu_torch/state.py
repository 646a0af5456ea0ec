"""Scene state for the PyTorch port (counterpart of nenbody_tpu/state.py).

The reference keeps scene state as four parallel CPU vectors (positions,
velocities, and their `old_*` double-buffer copies, src/main.rs:736-750)
plus derived 4x4 model matrices (src/main.rs:307-314). Here the state is a
small dataclass of `[..., N, 2]` float32 tensors; every update returns a new
state, so the double buffer disappears, and heading is derived on demand
(`rotation_of`, src/main.rs:141-143).

Unlike the JAX package, the state carries no random key: the random stream
is an explicit `torch.Generator` held by the caller (see `Scene`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .config import SimConfig


@dataclasses.dataclass(frozen=True)
class SceneState:
    """Simulation state.

    pos:  [..., N, 2] float32 — agent positions in the 2D plane.
    vel:  [..., N, 2] float32 — agent velocities.
    t:    [...] int32 — step counter.
    """

    pos: torch.Tensor
    vel: torch.Tensor
    t: torch.Tensor

    @property
    def n(self) -> int:
        return self.pos.shape[-2]

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.pos.shape[:-2])

    def replace(self, **changes) -> "SceneState":
        return dataclasses.replace(self, **changes)


def heading(vel: torch.Tensor) -> torch.Tensor:
    """Agent orientation = atan2(v_y, v_x) (`rotation_of`, src/main.rs:141-143)."""
    return torch.atan2(vel[..., 1], vel[..., 0])


def _uniform(shape, lo, hi, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (hi - lo) + lo


def spawn(
    cfg: SimConfig, generator: torch.Generator, device: str | torch.device = "cuda"
) -> SceneState:
    """Create an initial state with the reference spawn distributions.

    Positions ~ U(-100, 100)^2 and velocities ~ U(0, 0.1)^2
    (src/main.rs:736-747), drawn from `generator` (which must live on
    `device`). torch and jax.random give different numbers from one seed;
    only the distributions agree.
    """
    return spawn_batch(cfg, generator, None, device)


def spawn_batch(
    cfg: SimConfig,
    generator: torch.Generator,
    num_envs: int | None,
    device: str | torch.device = "cuda",
) -> SceneState:
    """Spawn `num_envs` independent environments, batched on a leading axis
    (`num_envs=None` gives one unbatched env)."""
    batch = () if num_envs is None else (num_envs,)
    plo, phi = cfg.spawn_pos_range
    vlo, vhi = cfg.spawn_vel_range
    pos = _uniform(batch + (cfg.n, 2), plo, phi, generator, device)
    vel = _uniform(batch + (cfg.n, 2), vlo, vhi, generator, device)
    t = torch.zeros(batch, dtype=torch.int32, device=device)
    return SceneState(pos=pos, vel=vel, t=t)


def model_matrices(state: SceneState) -> torch.Tensor:
    """Derive the reference's per-agent 4x4 model matrices.

    T(pos) @ Rz(atan2(vel)) as in src/main.rs:398-400/437-439 — for parity
    tests and visualizers; the sim itself never materializes these.
    Returns [..., N, 4, 4] float32.
    """
    th = heading(state.vel)
    c, s = torch.cos(th), torch.sin(th)
    z = torch.zeros_like(c)
    one = torch.ones_like(c)
    rows = [
        torch.stack([c, -s, z, state.pos[..., 0]], dim=-1),
        torch.stack([s, c, z, state.pos[..., 1]], dim=-1),
        torch.stack([z, z, one, z], dim=-1),
        torch.stack([z, z, z, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)
