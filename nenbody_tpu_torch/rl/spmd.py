"""A trainer's env batch on a mesh across processes: the JAX trainers'
global arrays after init_distributed (parallel.mesh), for every
trainer's `mesh=`.

Each process holds its block of the env states [B, N, 2]: the envs of its
rows of the mesh's data axis and the agents of its columns of the agent
axis (parallel.mesh.Mesh.own); every process holds a replica of the
policy. `Spmd` is what a trainer's step needs of that layout. Where the
mesh is one process's (or there is none) each of its methods is the plain
operation, so the one-process trainers run as they did:

- Random draws: a spawn or an action noise is drawn whole from the shared
  generator (every process's seeded alike) and this process's block kept,
  so every generator stays in lockstep with the one-process run and the
  draws equal its own.
- Reductions: a sum over the agent axis is this process's sum all-reduced
  over the ranks of its mesh row (parallel.mesh.all_reduce_sum, which is
  differentiable). A mean over the batch is the local sum over the global
  count. In a loss it is this process's share (`share`): the backward of
  every process's share at once is the backward of the whole, the ring's
  exchanges carrying each hop's cotangent back. In a metric or an
  advantage it is the all-reduced value (`mean`, `std`, `total`).
- Gradients: after backward() every process's gradients are summed
  (`sync_grads`), so each replica takes the same optimizer step. A loss
  term of replicated parameters alone (PPO's entropy) enters each share
  divided by the number of processes (`replicated`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..parallel.mesh import (AGENT_AXIS, DATA_AXIS, GlobalTensor, Mesh, agent_axis_of,
                             all_reduce_grads, all_reduce_sum, broadcast_module, data_axis_of)
from ..state import SceneState
from .policy import CentralValueMLP, gaussian_log_prob


class Spmd:
    """This process's block of a trainer's [B, N] batch on `mesh` (n
    agents an env). `on` is False on one process. `agent_sum(x, dim)` and
    `agent_mean(x, dim)` (keepdim) reduce over the global agent axis, and
    are None on one process, where the env's and the critic's own reductions
    run."""

    def __init__(self, mesh: Optional[Mesh], n: int):
        self.mesh, self.n = mesh, n
        self.on = mesh is not None and mesh.distributed
        self.agent_sum: Optional[Callable] = None
        self.agent_mean: Optional[Callable] = None
        if not self.on:
            return
        extra = set(mesh.axis_names) - {DATA_AXIS, AGENT_AXIS}
        if extra:
            raise ValueError(f"training across processes splits envs over {DATA_AXIS!r} and "
                             f"agents over {AGENT_AXIS!r}; the mesh also has {sorted(extra)}")
        self.data_axis, self.agent_axis = data_axis_of(mesh), agent_axis_of(mesh)
        self.rows, self.cols = mesh.own(self.data_axis, self.agent_axis)
        self.d_rows = mesh.shape[self.data_axis] if self.data_axis else 1
        self.d_cols = mesh.shape[self.agent_axis] if self.agent_axis else 1
        if n % self.d_cols:
            raise ValueError(f"agent count {n} must divide evenly over mesh axis "
                             f"{self.agent_axis!r} (size {self.d_cols}) across processes")
        self.processes = len(set(mesh.ranks))
        self.agent_sum, self.agent_mean = self._agent_sum, self._agent_mean

    # -- the layout -----------------------------------------------------------

    def num_envs(self, local_envs: int) -> int:
        """The global env count of a block of `local_envs`."""
        return local_envs * self.d_rows // len(self.rows) if self.on else local_envs

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This process's block of a whole [..., B, N, k] tensor."""
        if not self.on:
            return x
        b, m = x.shape[-3] // self.d_rows, self.n // self.d_cols
        return x[..., b * self.rows.start:b * self.rows.stop,
                 m * self.cols.start:m * self.cols.stop, :]

    def block_state(self, states: SceneState) -> SceneState:
        """This process's block of whole batched env states."""
        if not self.on:
            return states
        b = states.t.shape[-1] // self.d_rows
        return SceneState(pos=self.block(states.pos), vel=self.block(states.vel),
                          t=states.t[..., b * self.rows.start:b * self.rows.stop])

    def lift(self, x: torch.Tensor):
        """A [B, N, k] block as the GlobalTensor the ring takes (no
        collective: every block has one shape)."""
        if not self.on:
            return x
        shape = (self.num_envs(x.shape[0]), self.n, x.shape[-1])
        return GlobalTensor(x, self.mesh, (self.data_axis, self.agent_axis, None),
                            torch.Size(shape))

    @staticmethod
    def local(x):
        """A GlobalTensor's block (a plain tensor as it is)."""
        return getattr(x, "local", x)

    # -- random draws ---------------------------------------------------------

    def noise(self, generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
        """Standard normal noise of like's [..., B, N, k] block, drawn whole."""
        shape = (*like.shape[:-3], self.num_envs(like.shape[-3]), self.n, like.shape[-1])
        return self.block(torch.randn(shape, generator=generator, device=like.device,
                                      dtype=like.dtype))

    def sample_action(self, policy: nn.Module, obs: torch.Tensor, generator: torch.Generator):
        """policy.sample_action with noise(): (action, log_prob)."""
        mean, log_std = policy(obs)
        action = mean + torch.exp(log_std) * self.noise(generator, mean)
        return action, gaussian_log_prob(action, mean, log_std)

    # -- reductions -----------------------------------------------------------

    def _agent_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return all_reduce_sum(x.sum(dim=dim, keepdim=True), self.mesh, AGENT_AXIS)

    def _agent_mean(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return self._agent_sum(x, dim) / self.n

    def _count(self, x: torch.Tensor) -> int:
        """The global element count of a per-agent [..., B, N] block."""
        return x.numel() * self.d_rows * self.d_cols // (len(self.rows) * len(self.cols))

    def share(self, x: torch.Tensor) -> torch.Tensor:
        """x.mean() of the whole batch as this process's share of it (the
        local sum over the global count): a loss's term."""
        return x.sum() / self._count(x) if self.on else x.mean()

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the processes (shares into the whole)."""
        return all_reduce_sum(x, self.mesh) if self.on else x

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """x.mean() of the whole batch, on every process."""
        return self.total(x.sum()) / self._count(x) if self.on else x.mean()

    def std(self, x: torch.Tensor) -> torch.Tensor:
        """x.std(correction=0) of the whole batch in two passes, the mean
        and then the centred sum of squares, so that it does not drift
        from the one-process value."""
        if not self.on:
            return x.std(correction=0)
        return torch.sqrt(self.total(((x - self.mean(x)) ** 2).sum()) / self._count(x))

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """A loss term of the replicated parameters alone, as each
        process's share."""
        return x / self.processes if self.on else x

    def value(self, head: nn.Module, obs: torch.Tensor) -> torch.Tensor:
        """head(obs); a CentralValueMLP pools over the global agent axis."""
        if self.on and isinstance(head, CentralValueMLP):
            return head(obs, agent_mean=self.agent_mean)
        return head(obs)

    # -- the replicas ---------------------------------------------------------

    def sync_grads(self, params) -> None:
        """Sum the replicas' gradients after backward()."""
        all_reduce_grads(params, self.mesh if self.on else None)

    def broadcast(self, *modules: nn.Module) -> None:
        """Rank 0's parameters into every replica, at init."""
        for m in modules:
            broadcast_module(m, self.mesh if self.on else None)
