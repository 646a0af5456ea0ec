"""Scripted vision-reactive controllers (counterpart of
nenbody_tpu/rl/scripted.py): plain functions obs -> action with no
training, usable as baselines or experts, and ScriptedPolicy, which makes
one a policy module for sample_action.

They read the VisionEnv observation [..., W+2] (eye line, then the ego
velocity) and return world-frame accelerations [..., 2]: the eye looks
along the velocity, so each rotates its ego-frame steering by the heading.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from ..vision.camera import pixel_centers_for_width


def _split(obs: torch.Tensor):
    """obs [..., W+2] -> (lines [..., W], vel [..., 2])."""
    return obs[..., :-2], obs[..., -2:]


def _ego_to_world(forward: torch.Tensor, lateral: torch.Tensor, vel: torch.Tensor):
    """Steering (forward, lateral-right) in the eye frame -> world accel.
    The eye's right is (dir_y, -dir_x); a stopped agent faces +x (atan2(0,
    0) = 0 in both libraries)."""
    th = torch.atan2(vel[..., 1], vel[..., 0])
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([forward * c + lateral * s, forward * s - lateral * c], dim=-1)


def _saliency_offset(lines: torch.Tensor, background: float):
    """(mass [...], offset [...]): the above-background brightness and its
    brightness-weighted NDC position (the renderer's pixel centres, so a
    target dead ahead reads offset 0)."""
    u = pixel_centers_for_width(lines.shape[-1], lines.device).to(lines.dtype)
    sal = torch.clamp(lines - background, min=0.0)
    mass = sal.sum(dim=-1)
    return mass, (sal * u).sum(dim=-1) / torch.clamp(mass, min=1e-6)


def seek_brightest(obs: torch.Tensor, gain: float = 1.0, background: float = 0.2):
    """Phototaxis: turn by the brightness-weighted offset from centre, push
    forward when anything is in view. Returns accel [..., 2]."""
    lines, vel = _split(obs)
    mass, offset = _saliency_offset(lines, background)
    seen = (mass > 1e-4).to(lines.dtype)
    return gain * _ego_to_world(0.5 * seen, offset * seen, vel)


def avoid_crowding(obs: torch.Tensor, gain: float = 1.0, background: float = 0.2):
    """Anti-phototaxis: steer away from the occupied side and brake when the
    view is crowded, a separation rule from pixels alone."""
    lines, vel = _split(obs)
    mass, offset = _saliency_offset(lines, background)
    crowd = torch.tanh(mass / (0.25 * lines.shape[-1]))
    return gain * _ego_to_world(-0.5 * crowd, -offset * crowd, vel)


class ScriptedPolicy(nn.Module):
    """A scripted controller as a policy: obs -> (controller(obs, **kw),
    log_std = -8, all but deterministic), so it plugs into sample_action
    (the JAX `as_apply_fn`)."""

    def __init__(self, controller: Callable[..., torch.Tensor], **kwargs):
        super().__init__()
        self.controller, self.kwargs = controller, kwargs

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean = self.controller(obs, **self.kwargs)
        return mean, torch.full((2,), -8.0, device=obs.device)


SCRIPTED = {
    "seek": seek_brightest,
    "avoid": avoid_crowding,
}
