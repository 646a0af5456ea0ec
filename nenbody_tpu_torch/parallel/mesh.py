"""Device meshes for the port's multi-device backends (counterpart of
nenbody_tpu/parallel/mesh.py).

The port is single-controller, as the JAX package is: one process holds
GLOBAL tensors, and the ring (parallel/ring.py) and the compiler-free gspmd
twin (parallel/auto.py) split them into blocks, one per device of a named
`Mesh`, run each block on its device, and gather the results back to the
tensors' device. A block moves between devices with `send`, a non-blocking
peer copy (within one node, the NVLink copy NCCL's send/recv would make).

A mesh may name the same device more than once: the counterpart of
`jax_num_cpu_devices=8` in tests/conftest.py, with which the CPU tests and
chip_smoke.py run 2-4 ring hops on one device. `default_mesh()` and the
CLI's `--mesh` use the visible CUDA devices only, and raise where there is
none. Multi-host meshes (`init_distributed`, `global_state`,
`host_local_state` of the JAX package, over torch.distributed) are not
ported yet (ROADMAP queue 1 item 17).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Optional, Sequence

import torch

from ..state import SceneState

AGENT_AXIS = "agents"
DATA_AXIS = "data"


def _device(d) -> torch.device:
    """torch.device(d), with a CUDA index filled in ('cuda' -> 'cuda:0')."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A named grid of devices (jax.sharding.Mesh's counterpart): `devices`
    in row-major order over `axis_names`; `shape` maps each axis name to its
    size."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str], sizes: Sequence[int]):
        if math.prod(sizes) != len(devices):
            raise ValueError(f"{len(devices)} devices for axis sizes {tuple(sizes)}")
        self.devices = [_device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))

    def grid(self, data_axis: Optional[str], agent_axis: Optional[str]) -> List[List[torch.device]]:
        """The devices as rows over `data_axis` and columns over
        `agent_axis` (one row or column where the axis is None), every other
        axis at index 0."""
        rows = self.shape[data_axis] if data_axis is not None else 1
        cols = self.shape[agent_axis] if agent_axis is not None else 1
        strides, s = {}, 1
        for name in reversed(self.axis_names):
            strides[name] = s
            s *= self.shape[name]

        def at(r: int, c: int) -> torch.device:
            flat = (r * strides[data_axis] if data_axis is not None else 0) + (
                c * strides[agent_axis] if agent_axis is not None else 0)
            return self.devices[flat]

        return [[at(r, c) for c in range(cols)] for r in range(rows)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device; raises where there is none."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "no CUDA device is visible: a mesh of the card's devices needs a GPU "
            "(pass devices= to make_mesh for another device list)"
        )
    return [torch.device("cuda", i) for i in range(count)]


def make_mesh(axis_sizes: Optional[dict] = None, devices: Optional[Sequence] = None) -> Mesh:
    """Build a named mesh. Default: every visible CUDA device on the agent
    axis.

    axis_sizes: ordered {axis_name: size} (-1 for "all remaining devices"),
    e.g. {"data": 2, "agents": 4}. `devices` may repeat a device."""
    devices = list(devices if devices is not None else visible_devices())
    if axis_sizes is None:
        axis_sizes = {AGENT_AXIS: len(devices)}
    names = tuple(axis_sizes)
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = len(devices) // known
    total = math.prod(sizes)
    if total > len(devices):
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} devices, "
                         f"have {len(devices)}")
    return Mesh(devices[:total], names, sizes)


@functools.lru_cache(maxsize=1)
def default_mesh() -> Mesh:
    """All visible CUDA devices on the agent axis (cached)."""
    return make_mesh()


def data_axis_of(mesh: Optional[Mesh]) -> Optional[str]:
    """DATA_AXIS when the mesh has one, else None (agents-only meshes keep
    the env batch whole on every agent shard)."""
    if mesh is not None and DATA_AXIS in mesh.axis_names:
        return DATA_AXIS
    return None


def agent_axis_of(mesh: Optional[Mesh]) -> Optional[str]:
    """AGENT_AXIS when the mesh has one, else None (data-only meshes keep
    each env's agents on one device)."""
    if mesh is not None and AGENT_AXIS in mesh.axis_names:
        return AGENT_AXIS
    return None


def on_device(device: torch.device):
    """Make `device` current for the kernels launched in the block (they
    launch on the current CUDA device's current stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def send(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`x` on `device`: `x` itself where it is there already (a mesh that
    repeats a device), else a non-blocking copy that the destination's
    stream orders after the work that produced `x` (an event recorded on the
    source's current stream, waited on by the destination's). Autograd's
    transpose of the copy is the copy back."""
    if x.device == device:
        return x
    if x.is_cuda and device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(x.device))
        torch.cuda.current_stream(device).wait_event(ready)
    return x.to(device, non_blocking=True)


def split_blocks(x: torch.Tensor, grid: List[List[torch.device]], batch_dim: Optional[int],
                 agent_dim: Optional[int] = -2) -> List[List[torch.Tensor]]:
    """x cut into contiguous blocks[r][c] on grid[r][c] (the kernels take
    contiguous tensors): `batch_dim` (None: whole) over the rows,
    `agent_dim` (None: whole) over the columns, in order; a remainder goes
    to the first blocks (torch.tensor_split)."""
    rows = torch.tensor_split(x, len(grid), dim=batch_dim) if batch_dim is not None else [x] * len(grid)
    return [
        [send(b.contiguous(), dev) for b, dev in zip(
            torch.tensor_split(row, len(devs), dim=agent_dim) if agent_dim is not None
            else [row] * len(devs), devs)]
        for row, devs in zip(rows, grid)
    ]


def gather_blocks(blocks: List[List[torch.Tensor]], device: torch.device,
                  batch_dim: Optional[int], agent_dim: Optional[int] = -2) -> torch.Tensor:
    """The inverse of split_blocks: the blocks concatenated on `device`
    (a dimension that was not split is read from the first block)."""
    rows = [torch.cat([send(b, device) for b in row], dim=agent_dim) if agent_dim is not None
            else send(row[0], device) for row in blocks]
    return torch.cat(rows, dim=batch_dim) if batch_dim is not None else rows[0]


def shard_state_specs(batch: bool, agent_axis: Optional[str] = AGENT_AXIS,
                      data_axis: Optional[str] = None) -> Dict[str, tuple]:
    """The mesh axis each dimension of a SceneState's leaves is split over
    (None: kept whole): pos/vel (data?, agents?, None), t (data?,)."""
    lead = (data_axis,) if batch else ()
    return {"pos": (*lead, agent_axis, None), "vel": (*lead, agent_axis, None), "t": lead}


def _leaf_dims(spec: tuple, data_axis, agent_axis):
    batch_dim = 0 if data_axis is not None and spec and spec[0] == data_axis else None
    agent_dim = -2 if agent_axis is not None and agent_axis in spec else None
    return batch_dim, agent_dim


def place_state_on_mesh(states: SceneState, mesh: Mesh) -> List[List[SceneState]]:
    """Split a batched SceneState onto the mesh's (data?, agents?) layout:
    blocks[r][c] on the mesh's device (r, c). Agents-only meshes keep the
    env batch whole on every agent shard; data-only meshes keep each env's
    agents whole."""
    data_axis, agent_axis = data_axis_of(mesh), agent_axis_of(mesh)
    grid = mesh.grid(data_axis, agent_axis)
    specs = shard_state_specs(batch=True, agent_axis=agent_axis, data_axis=data_axis)
    leaves = {name: split_blocks(getattr(states, name), grid,
                                 *_leaf_dims(spec, data_axis, agent_axis))
              for name, spec in specs.items()}
    return [[SceneState(**{name: leaves[name][r][c] for name in specs})
             for c in range(len(grid[0]))] for r in range(len(grid))]


def gather_state(blocks: List[List[SceneState]], mesh: Mesh, device: torch.device) -> SceneState:
    """The inverse of place_state_on_mesh: one batched SceneState on
    `device`."""
    data_axis, agent_axis = data_axis_of(mesh), agent_axis_of(mesh)
    specs = shard_state_specs(batch=True, agent_axis=agent_axis, data_axis=data_axis)
    return SceneState(**{
        name: gather_blocks([[getattr(b, name) for b in row] for row in blocks], device,
                            *_leaf_dims(spec, data_axis, agent_axis))
        for name, spec in specs.items()})
