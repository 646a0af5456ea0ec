"""VisionEnv: gym-style observe/step over the actuated sim (counterpart of
nenbody_tpu/rl/env.py; spawn states with state.spawn or Scene).

Dynamics are the reference gravity world (src/main.rs:404-441) plus a
per-agent control acceleration: v += (gravity + action)*dt; the position
update follows the config's integrator mode. The observation is each
agent's 1D vision line plus the raw ego velocity. Rewards: cohesion, team,
difference (closed-form counterfactual) and visibility.

Unlike the JAX env, which is vmapped for batches, every method here takes
leading batch dims directly ([B, N, 2] states): the kernels run the whole
batch in one launch.

Every method is differentiable on every backend: dense is plain autograd;
on the kernel backend the wrappers route the forces through
pairwise.GravityForcesDiff (the VJP kernel) and the observation through
raycast.RenderRowsDiff (the disc eye's backward kernel) or
wireframe.RenderRowsWireframeDiff (the wireframe eye's winner pullback),
by cfg.vision.sprite_mode, whenever autograd needs them (rl/apg.py), and
launch forward-only otherwise. The JAX trainers' `_batched_observe_fast`
and `_batched_observe_diff` have no counterpart: the eye kernels take the
batch whole.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import SimConfig
from ..physics import dense
from ..state import SceneState


class VisionEnv:
    """Pure functions of the state; the backend routing is Scene's (dense =
    plain torch, otherwise the kernels on CUDA tensors)."""

    def __init__(
        self,
        cfg: SimConfig,
        max_accel: float = 0.05,
        speed_penalty: float = 0.0,
        smooth_clip: bool = False,
        reward_mode: str = "cohesion",
    ):
        if cfg.vision is None:
            raise ValueError("VisionEnv requires cfg.vision")
        if reward_mode not in ("cohesion", "team", "difference", "visibility"):
            raise ValueError(
                f"reward_mode must be one of cohesion/team/difference/"
                f"visibility, got {reward_mode!r}"
            )
        if reward_mode == "difference" and cfg.n < 2:
            raise ValueError(
                "reward_mode='difference' needs n >= 2: the counterfactual "
                "G(z_{-i}) removes agent i from a cohesion objective over "
                "the OTHER agents, which is 0/0 for a single agent"
            )
        from ..scene import _render_fn, _resolve_backend

        self.cfg = cfg
        self.reward_mode = reward_mode
        self.max_accel = max_accel
        # quadratic speed cost (see the JAX env: short-horizon trainers
        # otherwise learn to accelerate and never brake)
        self.speed_penalty = speed_penalty
        # actuator model: hard clip (default) or max_accel*tanh(a/max_accel)
        self.smooth_clip = smooth_clip
        self.backend = _resolve_backend(cfg)
        if self.backend in ("ring", "gspmd"):
            # mesh-level wrappers: per-env dynamics reduce to the kernels,
            # and the trainers' mesh= puts the ring around them
            self.backend = "pallas"
        self._render = _render_fn(dataclasses.replace(cfg, backend=self.backend))

    @property
    def obs_width(self) -> int:
        return self.cfg.vision.width + 2  # vision line + ego velocity

    def actuate(self, action: torch.Tensor) -> torch.Tensor:
        """Bound raw policy actions to [-max_accel, max_accel] through the
        configured actuator (hard clip or smooth tanh)."""
        if self.smooth_clip:
            return self.max_accel * torch.tanh(action / self.max_accel)
        return action.clamp(-self.max_accel, self.max_accel)

    def observe(self, state: SceneState) -> torch.Tensor:
        """[..., N, W+2]: the eye line plus the raw ego velocity;
        differentiable through perception when the state requires grad."""
        lines = self._render(state.pos, state.vel)[0]
        return torch.cat([lines, state.vel], dim=-1)

    def _forces(self, pos: torch.Tensor) -> torch.Tensor:
        if self.backend == "dense":
            return dense.gravity_forces(pos, self.cfg.gravity)
        from ..ops import pairwise

        # through the VJP kernel's autograd Function when autograd needs it
        return pairwise.gravity_forces_tiled(pos, self.cfg.gravity)

    def dynamics(self, state: SceneState, action: torch.Tensor) -> SceneState:
        """Physics-only transition (no observation), differentiable on every
        backend."""
        return self.integrate(state, action, self._forces(state.pos))

    def integrate(self, state: SceneState, action: torch.Tensor, g: torch.Tensor) -> SceneState:
        """The transition given the gravity forces g: v += (g + actuated
        action) * dt, then the position by the config's integrator mode (the
        trainers' mesh path computes g on the ring)."""
        accel = self.actuate(action)
        gcfg = self.cfg.gravity
        vel = state.vel + (g + accel) * gcfg.dt
        pos = state.pos + vel * (gcfg.dt if gcfg.dt_on_position else 1.0)
        return state.replace(pos=pos, vel=vel, t=state.t + 1)

    def step(
        self, state: SceneState, action: torch.Tensor
    ) -> Tuple[SceneState, torch.Tensor, torch.Tensor]:
        """action: [..., N, 2] control acceleration, clipped to max_accel.

        Returns (next_state, obs, reward[..., N]).
        """
        next_state = self.dynamics(state, action)
        obs = self.observe(next_state)
        if self.reward_mode == "visibility":
            return next_state, obs, self.reward_obs(obs)
        return next_state, obs, self.reward(next_state)

    def reward(self, state: SceneState) -> torch.Tensor:
        """[..., N] per-agent reward, by reward_mode:

        cohesion   (default) -|x_i - centroid|^2 / 1e4.
        team       every agent receives the team objective G = mean of the
                   cohesion terms.
        difference D_i = G(z) - G(z_{-i}), the team objective minus the team
                   objective with agent i removed, in closed form via the
                   parallel-axis theorem: with d_i = x_i - c and
                   S = sum_j |d_j|^2, sum_{j!=i} |x_j - c_{-i}|^2
                   = S - N|d_i|^2/(N-1).
        visibility observation-defined (see reward_obs).

        A quadratic speed cost subtracts from every mode when set."""
        if self.reward_mode == "visibility":
            return self.reward_obs(self.observe(state))
        centroid = state.pos.mean(dim=-2, keepdim=True)
        d = state.pos - centroid
        d2 = (d * d).sum(dim=-1)
        if self.reward_mode == "cohesion":
            r = -d2 / 1e4
        else:
            n = state.pos.shape[-2]
            team = -d2.mean(dim=-1, keepdim=True) / 1e4  # G, [..., 1]
            if self.reward_mode == "team":
                r = team.expand(d2.shape)
            else:  # difference rewards
                s = d2.sum(dim=-1, keepdim=True)
                g_without = -(s - n * d2 / (n - 1)) / ((n - 1) * 1e4)
                r = team - g_without
        if self.speed_penalty:
            r = r - self.speed_penalty * (state.vel ** 2).sum(dim=-1)
        return r

    def reward_obs(self, obs: torch.Tensor) -> torch.Tensor:
        """[..., N]: visibility shaping — mean sprite signal over the eye
        line ("keep the swarm in view")."""
        lines = obs[..., : self.cfg.vision.width]
        return (lines - self.cfg.vision.background).mean(dim=-1)
