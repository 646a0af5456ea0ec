"""Serving artifacts (counterpart of nenbody_tpu/utils/export.py): the
perception -> policy -> dynamics step exported with torch.export and saved
as a `.pt2` program, the trained weights inside it, which a deployment
process loads and calls without the policy checkpoint, the net definition
or the env config:

    blob = export_policy_step(env, policy, num_envs=None)
    step = load_policy_step(blob)          # or a path
    pos, vel, action = step(pos, vel)      # one closed-loop step

The loading site needs only `import nenbody_tpu_torch` (load_policy_step
lives here), which registers the kernels' custom ops (ops/library.py) that
the program calls. The program runs on its inputs' device: the kernels on
the card, their plain versions on the CPU; its weights stay on the device
they were exported from. Shapes are static: export one artifact per
serving shape. The JAX `make_fleet_step` (a step over a device mesh) waits
for the port's multi-device export.
"""

from __future__ import annotations

import io
import os
from typing import Callable, Optional

import torch
from torch import nn

from ..config import SimConfig
from ..ops import library
from ..physics import dense
from ..state import SceneState


def _check_steps(steps: int) -> None:
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")


def _state(pos: torch.Tensor, vel: torch.Tensor) -> SceneState:
    return SceneState(pos=pos, vel=vel,
                      t=torch.zeros(pos.shape[:-2], dtype=torch.int32, device=pos.device))


class PolicyStep(nn.Module):
    """forward(pos, vel) -> (next_pos, next_vel, action): `steps`
    deterministic closed-loop steps of `env` under `policy` (observe, the
    policy's mean action, the env's dynamics), the last step's action
    returned; the eye and the forces through the custom ops. pos, vel
    [..., N, 2]."""

    def __init__(self, env, policy: nn.Module, steps: int = 1):
        super().__init__()
        _check_steps(steps)
        self.env, self.policy, self.steps = env, policy, steps

    def forward(self, pos: torch.Tensor, vel: torch.Tensor):
        cfg = self.env.cfg
        action = None
        for _ in range(self.steps):
            shade, _ = library.render_rows(pos, vel, cfg.vision)
            action, _ = self.policy(torch.cat([shade, vel], dim=-1))
            g = library.gravity_forces(pos, cfg.gravity)
            nxt = self.env.integrate(_state(pos, vel), action, g)
            pos, vel = nxt.pos, nxt.vel
        return pos, vel, action


class SimStep(nn.Module):
    """forward(pos, vel) -> (next_pos, next_vel): `steps` controller steps
    (gravity or boids; the forces through the custom ops)."""

    def __init__(self, cfg: SimConfig, steps: int = 1):
        super().__init__()
        _check_steps(steps)
        if cfg.controller == "random":
            raise ValueError(
                "sim export supports gravity/boids; the random controller "
                "consumes a random stream the (pos, vel) artifact cannot carry"
            )
        self.cfg, self.steps = cfg, steps

    def forward(self, pos: torch.Tensor, vel: torch.Tensor):
        cfg = self.cfg
        state = _state(pos, vel)
        for _ in range(self.steps):
            if cfg.controller == "gravity":
                state = dense.gravity_integrate(
                    state, library.gravity_forces(state.pos, cfg.gravity), cfg)
            else:
                state = dense.boids_integrate(
                    state, library.boids_velocity(state.pos, state.vel, cfg.boids), cfg)
        return state.pos, state.vel


def make_policy_step(env, policy: nn.Module, steps: int = 1) -> PolicyStep:
    """The serving unit as a module (also usable live)."""
    return PolicyStep(env, policy, steps)


def make_sim_step(cfg: SimConfig, steps: int = 1) -> SimStep:
    """`steps` controller steps as a module; the random controller is
    refused (it consumes a random stream)."""
    return SimStep(cfg, steps)


def _serialize(module: nn.Module, n: int, num_envs: Optional[int],
               device: torch.device) -> bytes:
    lead = () if num_envs is None else (num_envs,)
    spec = torch.zeros(lead + (n, 2), device=device)
    with torch.no_grad():
        program = torch.export.export(module.eval(), (spec, spec.clone()), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_policy_step(env, policy: nn.Module, num_envs: Optional[int] = None,
                       steps: int = 1, mesh=None) -> bytes:
    """The `.pt2` bytes of make_policy_step for (num_envs?, N, 2) inputs on
    the policy's device, its weights inside the program. `mesh` (the JAX
    fleet step) is not ported: ValueError."""
    if mesh is not None:
        raise ValueError("a mesh export (the fleet step) is not ported yet: "
                         "ROADMAP queue 1 item 17")
    device = next(policy.parameters()).device
    return _serialize(make_policy_step(env, policy, steps), env.cfg.n, num_envs, device)


def export_sim_step(cfg: SimConfig, num_envs: Optional[int] = None, steps: int = 1,
                    device: str | torch.device = "cuda") -> bytes:
    """The `.pt2` bytes of `steps` controller steps (no policy): (pos, vel)
    -> (pos, vel), the sim-as-a-service artifact, traced on `device`."""
    return _serialize(make_sim_step(cfg, steps), cfg.n, num_envs, torch.device(device))


def load_policy_step(blob) -> Callable:
    """bytes or path -> the artifact's callable: (pos, vel) -> (pos, vel,
    action) for policy artifacts, (pos, vel) -> (pos, vel) for sim ones.
    Calls run without autograd and with cuDNN's TF32 off (as the port's
    ConvPolicy runs its convs)."""
    if isinstance(blob, (bytes, bytearray)):
        program = torch.export.load(io.BytesIO(bytes(blob)))
    else:
        program = torch.export.load(os.fspath(blob))
    module = program.module()

    def step(pos: torch.Tensor, vel: torch.Tensor):
        cudnn = torch.backends.cudnn
        with torch.no_grad(), cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                                          deterministic=cudnn.deterministic, allow_tf32=False):
            return module(pos, vel)

    return step
