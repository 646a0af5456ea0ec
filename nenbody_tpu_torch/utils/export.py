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
serving shape.

The fleet step (`make_fleet_step`, `export_policy_step(..., mesh=)`) runs
[B, N, 2] envs over a (data?, agents) mesh of one process: the envs split
over data, the agent-axis ring (parallel/ring.py, whose hops and peer
copies go through the custom ops under torch.export) over agents, the
policy baked in. It traces into one program with the same kernels in the same order, so
the loaded step equals the live one bit for bit. The artifact records the
mesh's shape and devices; `load_policy_step` refuses a machine that lacks
them, unless the caller passes a mesh of that shape (which may repeat a
device), onto whose devices the program is moved.
"""

from __future__ import annotations

import io
import json
import os
from typing import Callable, Optional

import torch
from torch import nn

from ..config import SimConfig
from ..ops import library
from ..parallel import ring
from ..parallel.mesh import Mesh, agent_axis_of, data_axis_of
from ..physics import dense
from ..state import SceneState

MESH_RECORD = "nenbody_mesh.json"  # the fleet artifact's extra file: mesh shape and devices


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


class FleetStep(nn.Module):
    """forward(pos, vel) [B, N, 2] -> (next_pos, next_vel, action): `steps`
    deterministic closed-loop steps of a fleet of envs on `mesh` (the JAX
    make_fleet_step): the envs over its data axis, observation and gravity
    on the agent-axis ring (through the custom ops under torch.export: the
    same kernels in the same order), the policy on the inputs' device. The observation threads through the loop as the
    trainers' rollout carries it: one render before the first step and one
    after each step but the last (whose observation nothing reads)."""

    def __init__(self, env, policy: nn.Module, mesh: Mesh, steps: int = 1):
        super().__init__()
        _check_steps(steps)
        if agent_axis_of(mesh) is None:
            raise ValueError("the fleet step runs the agent-axis ring: the mesh needs an "
                             f"'agents' axis, got {mesh.axis_names}")
        if mesh.distributed:
            raise ValueError("a mesh across processes has no one-program fleet step")
        self.env, self.policy, self.mesh, self.steps = env, policy, mesh, steps

    def forward(self, pos: torch.Tensor, vel: torch.Tensor):
        cfg, mesh = self.env.cfg, self.mesh
        data_axis = data_axis_of(mesh)

        def observe(pos, vel):
            shade, _ = ring.ring_render_rows(pos, vel, cfg.vision, mesh=mesh,
                                             data_axis=data_axis)
            return torch.cat([shade, vel], dim=-1)

        obs = observe(pos, vel)
        for i in range(self.steps):
            action, _ = self.policy(obs)
            g = ring.ring_gravity_forces(pos, cfg, mesh=mesh, data_axis=data_axis)
            nxt = self.env.integrate(_state(pos, vel), action, g)
            pos, vel = nxt.pos, nxt.vel
            if i < self.steps - 1:
                obs = observe(pos, vel)
        return pos, vel, action


def make_policy_step(env, policy: nn.Module, steps: int = 1) -> PolicyStep:
    """The serving unit as a module (also usable live)."""
    return PolicyStep(env, policy, steps)


def make_fleet_step(env, policy: nn.Module, mesh: Mesh, steps: int = 1) -> FleetStep:
    """The fleet step over `mesh` as a module (also usable live)."""
    return FleetStep(env, policy, mesh, steps)


def make_sim_step(cfg: SimConfig, steps: int = 1) -> SimStep:
    """`steps` controller steps as a module; the random controller is
    refused (it consumes a random stream)."""
    return SimStep(cfg, steps)


def _serialize(module: nn.Module, n: int, num_envs: Optional[int],
               device: torch.device, record: Optional[dict] = None) -> bytes:
    lead = () if num_envs is None else (num_envs,)
    spec = torch.zeros(lead + (n, 2), device=device)
    with torch.no_grad():
        program = torch.export.export(module.eval(), (spec, spec.clone()), strict=False)
    buf = io.BytesIO()
    extra = {MESH_RECORD: json.dumps(record)} if record is not None else None
    torch.export.save(program, buf, extra_files=extra)
    return buf.getvalue()


def export_policy_step(env, policy: nn.Module, num_envs: Optional[int] = None,
                       steps: int = 1, mesh: Optional[Mesh] = None) -> bytes:
    """The `.pt2` bytes of make_policy_step for (num_envs?, N, 2) inputs on
    the policy's device, its weights inside the program. With `mesh`, the
    fleet step (make_fleet_step) for [num_envs, N, 2] inputs, which needs
    num_envs (dividing the mesh's data axis); the artifact records the
    mesh's shape and devices."""
    device = next(policy.parameters()).device
    if mesh is None:
        return _serialize(make_policy_step(env, policy, steps), env.cfg.n, num_envs, device)
    if num_envs is None:
        raise ValueError("mesh export serves an env fleet: pass num_envs")
    from ..rl.train import check_mesh_envs

    check_mesh_envs(mesh, num_envs)
    record = {"shape": mesh.shape, "devices": [str(d) for d in mesh.devices]}
    return _serialize(make_fleet_step(env, policy, mesh, steps), env.cfg.n, num_envs, device,
                      record)


def export_sim_step(cfg: SimConfig, num_envs: Optional[int] = None, steps: int = 1,
                    device: str | torch.device = "cuda") -> bytes:
    """The `.pt2` bytes of `steps` controller steps (no policy): (pos, vel)
    -> (pos, vel), the sim-as-a-service artifact, traced on `device`."""
    return _serialize(make_sim_step(cfg, steps), cfg.n, num_envs, torch.device(device))


def _bind_mesh(program, record: dict, mesh: Optional[Mesh]):
    """The fleet program on this machine: as exported where its devices
    are all here; else on `mesh`'s devices, position by position (a mesh of
    the recorded shape, which may repeat a device)."""
    recorded = [torch.device(d) for d in record["devices"]]
    if mesh is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        missing = sorted({str(d) for d in recorded if d.type == "cuda" and d.index >= cards})
        if missing:
            raise RuntimeError(
                f"the artifact's mesh {record['shape']} needs "
                f"{len({str(d) for d in recorded})} distinct devices "
                f"{sorted({str(d) for d in recorded})}, and this machine has {cards} visible "
                f"card(s): pass mesh= of that shape (make_mesh(shape, devices=...) may repeat "
                f"a device) to run it here")
        return program
    if mesh.shape != record["shape"]:
        raise ValueError(f"the artifact's mesh is {record['shape']}, got {mesh.shape}")
    moves = {}
    for old, new in zip(recorded, mesh.devices):
        if moves.setdefault(str(old), str(new)) != str(new):
            raise ValueError(f"mesh= must put each of the artifact's devices on one device: "
                             f"{old} on {moves[str(old)]} and {new}")
    if any(old != new for old, new in moves.items()):
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, moves)
    return program


def load_policy_step(blob, mesh: Optional[Mesh] = None) -> Callable:
    """bytes or path -> the artifact's callable: (pos, vel) -> (pos, vel,
    action) for policy and fleet artifacts, (pos, vel) -> (pos, vel) for
    sim ones. A fleet artifact needs its mesh's devices, or `mesh`, a mesh
    of its shape to run on instead (_bind_mesh). Calls run without autograd
    and with cuDNN's TF32 off (as the port's ConvPolicy runs its convs)."""
    extra = {MESH_RECORD: ""}
    if isinstance(blob, (bytes, bytearray)):
        program = torch.export.load(io.BytesIO(bytes(blob)), extra_files=extra)
    else:
        program = torch.export.load(os.fspath(blob), extra_files=extra)
    if extra[MESH_RECORD]:
        program = _bind_mesh(program, json.loads(extra[MESH_RECORD]), mesh)
    elif mesh is not None:
        raise ValueError("a one-device artifact takes no mesh")
    module = program.module()

    def step(pos: torch.Tensor, vel: torch.Tensor):
        cudnn = torch.backends.cudnn
        with torch.no_grad(), cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                                          deterministic=cudnn.deterministic, allow_tf32=False):
            return module(pos, vel)

    return step
