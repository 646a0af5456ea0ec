"""Device meshes for the port's multi-device backends (counterpart of
nenbody_tpu/parallel/mesh.py).

Within one process the port is single-controller, as the JAX package is:
the process holds GLOBAL tensors, and the ring (parallel/ring.py) and the
compiler-free gspmd twin (parallel/auto.py) split them into blocks, one per
device of a named `Mesh`, run each block on its device, and gather the
results back to the tensors' device. A block moves between devices with
`send`, a non-blocking peer copy (within one node, the NVLink copy NCCL's
send/recv would make).

A mesh may name the same device more than once: the counterpart of
`jax_num_cpu_devices=8` in tests/conftest.py, with which the CPU tests and
chip_smoke.py run 2-4 ring hops on one device. `default_mesh()` and the
CLI's `--mesh` use the visible CUDA devices only, and raise where there is
none.

Across processes (SURVEY.md section 5.8's cross-host half) a process group
takes the place of jax.distributed: `init_distributed()` once per process
joins torch.distributed (NCCL for CUDA devices, gloo for CPU ones) and
records every process's devices, after which `make_mesh()` spans them all
in rank-major order (each device of the mesh knows the rank that owns it).
`global_state` lifts a process's local block of a SceneState into
`GlobalTensor`s on such a mesh and `host_local_state` takes the block back;
the ring and the gspmd backend take GlobalTensors, run the hops of their
own process's shards, and move blocks across a process boundary over the
group (`exchange`, `gather_global`).

The collectives the trainers need there are differentiable, as XLA's are
for the JAX package: `exchange` is an autograd Function whose backward is
the same exchange the other way (each received block's cotangent goes back
to the rank that sent it), and `all_reduce_sum` sums over the ranks of a
mesh row, a column or the whole mesh (its backward all-reduces the
cotangent over the same ranks; `Mesh.process_group` builds the groups once
a mesh). `all_reduce_grads` sums a replicated module's gradients after
backward() and `broadcast_module` copies rank 0's parameters at init, as
DDP does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..state import SceneState
from ..utils import profiling

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
    size. `ranks` (None on a one-process mesh) names the process that owns
    each device: a device of another rank is a label here, never used."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str], sizes: Sequence[int],
                 ranks: Optional[Sequence[int]] = None):
        if math.prod(sizes) != len(devices):
            raise ValueError(f"{len(devices)} devices for axis sizes {tuple(sizes)}")
        self.devices = [_device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.ranks = list(ranks) if ranks is not None else None
        self._groups = None  # process_group's, built on first use

    @property
    def distributed(self) -> bool:
        """True when the mesh spans more than one process."""
        return self.ranks is not None and len(set(self.ranks)) > 1

    def _coords(self, flat: int) -> Dict[str, int]:
        coords = {}
        for name in reversed(self.axis_names):
            flat, coords[name] = divmod(flat, self.shape[name])
        return coords

    def span(self, axis: str, rank: Optional[int] = None) -> range:
        """The indices along `axis` of the devices that process `rank`
        (this one by default) owns: the whole axis on a one-process mesh.
        Raises where they are not contiguous."""
        if not self.distributed:
            return range(self.shape[axis])
        rank = dist.get_rank() if rank is None else rank
        idx = sorted({self._coords(i)[axis] for i, r in enumerate(self.ranks) if r == rank})
        if not idx or idx[-1] - idx[0] + 1 != len(idx):
            raise ValueError(f"process {rank}'s devices are not one block of mesh axis {axis!r}")
        return range(idx[0], idx[-1] + 1)

    def _grid(self, items: list, data_axis: Optional[str], agent_axis: Optional[str]) -> list:
        rows = self.shape[data_axis] if data_axis is not None else 1
        cols = self.shape[agent_axis] if agent_axis is not None else 1
        strides, s = {}, 1
        for name in reversed(self.axis_names):
            strides[name] = s
            s *= self.shape[name]
        # every other axis at this process's first index (0 on one process)
        base = sum(strides[name] * self.span(name).start for name in self.axis_names
                   if name not in (data_axis, agent_axis))

        def at(r: int, c: int):
            flat = base + (r * strides[data_axis] if data_axis is not None else 0) + (
                c * strides[agent_axis] if agent_axis is not None else 0)
            return items[flat]

        return [[at(r, c) for c in range(cols)] for r in range(rows)]

    def grid(self, data_axis: Optional[str], agent_axis: Optional[str]) -> List[List[torch.device]]:
        """The devices as rows over `data_axis` and columns over
        `agent_axis` (one row or column where the axis is None), every other
        axis at index 0 (on a distributed mesh, at this process's first
        index along it)."""
        return self._grid(self.devices, data_axis, agent_axis)

    def rank_grid(self, data_axis: Optional[str], agent_axis: Optional[str]) -> List[List[int]]:
        """The owning rank of each device of grid(data_axis, agent_axis)."""
        ranks = self.ranks if self.ranks is not None else [0] * len(self.devices)
        return self._grid(ranks, data_axis, agent_axis)

    def own(self, data_axis: Optional[str], agent_axis: Optional[str]) -> Tuple[range, range]:
        """(rows, columns) of grid(data_axis, agent_axis) that this process
        owns: one block, all of the grid on a one-process mesh."""
        rows = self.span(data_axis) if data_axis is not None else range(1)
        cols = self.span(agent_axis) if agent_axis is not None else range(1)
        if self.distributed:
            me, ranks = dist.get_rank(), self.rank_grid(data_axis, agent_axis)
            if any(ranks[r][c] != me for r in rows for c in cols):
                raise ValueError(f"process {me}'s devices are not one block of the mesh's "
                                 f"({data_axis}, {agent_axis}) grid")
        return rows, cols

    def process_group(self, axis: Optional[str]):
        """The process group of the ranks whose devices differ from this
        process's only along `axis` (a mesh row for AGENT_AXIS, a column for
        DATA_AXIS; every rank of the mesh for None), or None where that is
        this process alone (nothing to reduce; so for an axis the mesh does
        not have). A collective on first use: every process builds every
        group of the mesh, in one order."""
        if not self.distributed or (axis is not None and axis not in self.shape):
            return None
        if self._groups is None:
            self._groups = self._make_groups()
        return self._groups[axis]

    def _make_groups(self) -> dict:
        lines = {}  # (axis, the other axes' coordinates) -> ranks along the axis
        for axis in (*self.axis_names, None):
            for i, r in enumerate(self.ranks):
                key = () if axis is None else tuple(
                    v for k, v in self._coords(i).items() if k != axis)
                lines.setdefault((axis, key), set()).add(r)
        every = sorted(set(self.ranks))
        made = {}
        for ranks in sorted({tuple(sorted(r)) for r in lines.values()}):
            if len(ranks) == 1:
                made[ranks] = None
            elif list(ranks) == every and len(every) == dist.get_world_size():
                made[ranks] = dist.group.WORLD
            else:  # dist.new_group is called by every process, for every group
                made[ranks] = dist.new_group(list(ranks))
        me, groups = dist.get_rank(), {}
        for (axis, _), ranks in lines.items():
            if me in ranks:
                ranks = tuple(sorted(ranks))
                if groups.setdefault(axis, ranks) != ranks:
                    raise ValueError(f"process {me}'s devices meet different ranks along mesh "
                                     f"axis {axis!r}: no one group reduces over it")
        return {axis: made[ranks] for axis, ranks in groups.items()}

    def __repr__(self) -> str:
        ranks = f", ranks={self.ranks}" if self.ranks is not None else ""
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]}{ranks})"


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device; raises where there is none."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "no CUDA device is visible: a mesh of the card's devices needs a GPU "
            "(pass devices= to make_mesh for another device list)"
        )
    return [torch.device("cuda", i) for i in range(count)]


# -- processes ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Group:
    """What init_distributed records: the group's backend and every
    process's devices, by rank."""

    backend: str
    devices: Tuple[Tuple[torch.device, ...], ...]


_GROUP: Optional[_Group] = None  # torch.distributed's default group is per process too


def _local_devices(local_device_ids: Optional[Sequence] = None,
                   backend: Optional[str] = None) -> Tuple[List[torch.device], str]:
    """(this process's devices on the mesh, the backend) as
    init_distributed resolves them, before it joins any group.
    local_device_ids: ints name CUDA devices, a str or torch.device any
    device; a device may repeat. Default: every visible card (an error
    where there is none: no silent move to the CPU), and under NCCL the
    card of torchrun's LOCAL_RANK where that is set; gloo keeps every
    visible card. backend: default "nccl" for CUDA devices, "gloo" for CPU
    ones. NCCL takes one card a process, so the default on several cards
    without LOCAL_RANK raises under it."""
    if local_device_ids is not None:
        local = [torch.device("cuda", d) if isinstance(d, int) else _device(d)
                 for d in local_device_ids]
    else:
        local = visible_devices()
    if backend is None:
        backend = "nccl" if local[0].type == "cuda" else "gloo"
    rank = os.environ.get("LOCAL_RANK")
    if local_device_ids is None and backend == "nccl" and rank is not None:  # torchrun's
        if not 0 <= int(rank) < len(local):
            raise ValueError(f"LOCAL_RANK={rank}, and {len(local)} card(s) are visible")
        local = [local[int(rank)]]
    if backend == "nccl" and any(d.type != "cuda" for d in local):
        raise ValueError(f"the nccl backend moves CUDA tensors only; devices {local}")
    if backend == "nccl" and len(set(local)) > 1:
        raise ValueError(f"under the nccl backend a process takes one card, got {local}: set "
                         f"LOCAL_RANK (torchrun sets it) or pass local_device_ids=[this rank's "
                         f"card], or backend='gloo'")
    return local, backend


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (jax.distributed.initialize's counterpart,
    over torch.distributed.init_process_group).

    coordinator_address: "host:port" of rank 0 (a tcp:// init), with
    num_processes (the world size) and process_id (this rank); None reads
    the env:// variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) that
    torchrun sets. local_device_ids and backend: as _local_devices resolves
    them. Under `torchrun --nproc-per-node N` a bare init_distributed()
    takes the card of LOCAL_RANK and joins on NCCL. Under NCCL a process
    takes one card (a mesh device may repeat it): the ring's hop sends from
    its last shard and receives into its first in one batch, which NCCL
    refuses across two cards of one process; so with several cards a
    process, pass backend="gloo". NCCL also refuses two ranks on one card:
    pass backend="gloo" there, which moves CUDA blocks through pinned host
    memory (the transport only; every partial still runs on the card).
    After this, make_mesh() spans every process's devices in rank-major
    order."""
    global _GROUP
    local, backend = _local_devices(local_device_ids, backend)
    if local[0].type == "cuda":
        torch.cuda.set_device(local[0])
    init_method = "env://"
    if coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, [str(d) for d in local])
    _GROUP = _Group(backend, tuple(tuple(torch.device(d) for d in ds) for ds in every))


def is_distributed() -> bool:
    """True once init_distributed has joined a group of more than one
    process."""
    return _GROUP is not None and dist.is_initialized() and dist.get_world_size() > 1


def _staged(x: torch.Tensor) -> bool:
    """gloo moves host tensors: a CUDA tensor goes through pinned host
    memory."""
    return x.is_cuda and _GROUP is not None and _GROUP.backend == "gloo"


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    if _staged(x):
        # a non-blocking copy on x's stream, then a sync of that stream: the
        # autograd engine runs a CUDA backward on its own thread, whose
        # exchanges must not wait on the host thread's stream
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        torch.cuda.current_stream(x.device).synchronize()
        return host
    return x


def _wire_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    if device.type == "cuda" and _GROUP is not None and _GROUP.backend == "gloo":
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=device)


def _exchange(sends, recvs) -> List[torch.Tensor]:
    """sends (tensor, peer, tag); recvs (shape, dtype, device, peer, tag)."""
    wire = [_to_wire(x) for x, _, _ in sends]
    bufs = [_wire_buffer(shape, dtype, dev) for shape, dtype, dev, _, _ in recvs]
    ops = [dist.P2POp(dist.isend, x, peer, tag=tag) for x, (_, peer, tag) in zip(wire, sends)]
    ops += [dist.P2POp(dist.irecv, b, peer, tag=tag)
            for b, (_, _, _, peer, tag) in zip(bufs, recvs)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(dev, non_blocking=True) for b, (_, _, dev, _, _) in zip(bufs, recvs)]


class _Exchange(torch.autograd.Function):
    """exchange as an autograd node: the transpose of sending a block to a
    peer is receiving its cotangent from that peer, so the backward is the
    same exchange with sends and receives swapped (the JAX backward ring's
    circulating `gblk`). Every process reaches its nodes in one order: each
    hop's node depends on the previous hop's outputs."""

    @staticmethod
    def forward(ctx, send_to, recvs, *xs):
        # an output that got no gradient still sends its zeros back
        ctx.set_materialize_grads(True)
        ctx.send_to, ctx.recvs = send_to, recvs
        ctx.sent = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(_exchange([(x, peer, tag) for x, (peer, tag) in zip(xs, send_to)], recvs))

    @staticmethod
    def backward(ctx, *grads):
        back = _exchange(
            [(g, peer, tag) for g, (_, _, _, peer, tag) in zip(grads, ctx.recvs)],
            [(shape, dtype, dev, peer, tag)
             for (shape, dtype, dev), (peer, tag) in zip(ctx.sent, ctx.send_to)])
        return (None, None, *back)


def exchange(sends: Sequence[Tuple[torch.Tensor, int, int]],
             recvs: Sequence[Tuple[torch.Tensor, torch.device, int, int]]) -> List[torch.Tensor]:
    """One dist.batch_isend_irecv: each (tensor, peer rank, tag) of `sends`
    goes out, and each (tensor like the one expected, device, peer rank,
    tag) of `recvs` comes back on `device`, all at once, so no rank waits
    on another's order. A failed transfer raises (Work.wait).
    Differentiable (_Exchange) when a sent tensor requires grad: every
    process must then take part in the backward, as in the forward."""
    send_to = tuple((peer, tag) for _, peer, tag in sends)
    meta = tuple((like.shape, like.dtype, dev, peer, tag) for like, dev, peer, tag in recvs)
    xs = [x for x, _, _ in sends]
    if recvs and torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return list(_Exchange.apply(send_to, meta, *xs))
    return _exchange([(x, peer, tag) for x, (peer, tag) in zip(xs, send_to)], meta)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`, a new tensor on x's device."""
    wire = _to_wire(x)
    if wire.data_ptr() == x.data_ptr():
        wire = wire.clone()
    dist.all_reduce(wire, group=group)
    return wire.to(x.device, non_blocking=True)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over a group, on every member: each member's x
    reaches every member's y, so x's cotangent is the sum of the y
    cotangents over the same group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """x summed over the processes of `mesh` that share this process's
    place but for `axis` (Mesh.process_group: AGENT_AXIS sums a mesh row's
    agent blocks, DATA_AXIS a column's env blocks, None every process's);
    x itself where that is this process alone. Differentiable. A collective:
    every process of the group calls it."""
    group = mesh.process_group(axis)
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    out: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


def all_reduce_grads(params, mesh: Optional[Mesh]) -> None:
    """Sum the gradients of a replicated module's parameters over every
    process of `mesh`, after backward(): each process's loss is its share
    of the global mean, so the sum is the gradient of the whole. A missing
    gradient counts as zero, so every process reduces the same buffers (one
    flat all-reduce per dtype). Nothing on one process."""
    if mesh is None or not mesh.distributed:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    group = mesh.process_group(None)
    with profiling.span("mesh.all_reduce_grads"):
        for grads in _by_dtype([p.grad for p in params]).values():
            flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))


def broadcast_module(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Copy the parameters and buffers of the mesh's first rank into every
    process's replica (DDP's broadcast at construction), so that replicas
    built from one seed stay equal bit for bit whatever each process's
    init drew. Nothing on one process."""
    if mesh is None or not mesh.distributed:
        return
    group, src = mesh.process_group(None), min(mesh.ranks)
    with torch.no_grad():
        for ts in _by_dtype([*module.parameters(), *module.buffers()]).values():
            wire = _to_wire(torch.cat([t.reshape(-1) for t in ts]))
            dist.broadcast(wire, src, group=group)
            flat = wire.to(ts[0].device)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


@dataclasses.dataclass(frozen=True)
class GlobalTensor:
    """A tensor split over the processes of a distributed mesh (a global
    jax.Array's counterpart): `local` is this process's block, `spec` the
    mesh axis each dimension is split over (shard_state_specs' form), and
    `shape` the global shape. The port's own small type rather than a
    DTensor: a process here owns several devices of the mesh (two shards of
    one card, or of the CPU), where a DTensor's DeviceMesh has one device
    per rank."""

    local: torch.Tensor
    mesh: Mesh
    spec: tuple
    shape: torch.Size

    def dim(self) -> int:
        return len(self.shape)

    def with_local(self, local: torch.Tensor) -> "GlobalTensor":
        """Another global tensor of this layout whose block is `local` (its
        last dimension may differ)."""
        return GlobalTensor(local, self.mesh, self.spec,
                            torch.Size((*self.shape[:-1], local.shape[-1])))


def _block(mesh: Mesh, spec: tuple, shape: Sequence[int], rank: Optional[int] = None):
    """The slices of a global `shape` that process `rank` holds."""
    return tuple(slice(None) if axis is None else
                 slice(size // mesh.shape[axis] * mesh.span(axis, rank).start,
                       size // mesh.shape[axis] * mesh.span(axis, rank).stop)
                 for axis, size in zip(spec, shape))


def lift(local: torch.Tensor, mesh: Mesh, spec: tuple) -> GlobalTensor:
    """`local`, this process's block, as a GlobalTensor split per `spec`
    (each process contributes its block; a collective: every process
    calls it). Each split dimension must divide evenly over the devices
    of its axis, and every process's block must have one shape, as the JAX
    global arrays require."""
    if not mesh.distributed:
        raise ValueError("global tensors need a mesh that spans processes (init_distributed, "
                         "then make_mesh())")
    spec = tuple(spec) + (None,) * (local.dim() - len(spec))
    shapes = [None] * dist.get_world_size()
    dist.all_gather_object(shapes, tuple(local.shape))
    if len(set(shapes)) > 1:
        raise ValueError(f"the processes' blocks differ in shape {shapes}: the split "
                         f"dimensions must divide evenly over the processes")
    size = []
    for axis, n in zip(spec, local.shape):
        if axis is None:
            size.append(n)
            continue
        own = len(mesh.span(axis))
        if n % own:
            raise ValueError(f"a block of {n} does not divide evenly over this process's "
                             f"{own} devices of mesh axis {axis!r}")
        size.append(n // own * mesh.shape[axis])
    return GlobalTensor(local, mesh, spec, torch.Size(size))


def gather_global(x: GlobalTensor) -> torch.Tensor:
    """The whole of `x` on every process, on its block's device (an
    all-gather over the group: every process calls it)."""
    wire = _to_wire(x.local)
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, wire)
    out = torch.empty(x.shape, dtype=wire.dtype, device=wire.device)
    for rank, part in enumerate(parts):
        out[_block(x.mesh, x.spec, x.shape, rank)] = part
    return out.to(x.local.device)


def _map_state(state, fn, batch: bool, data_axis: Optional[str]) -> SceneState:
    specs = shard_state_specs(batch=batch, data_axis=data_axis)
    return SceneState(**{name: fn(getattr(state, name), spec) for name, spec in specs.items()})


def global_state(state: SceneState, mesh: Mesh, batch: bool = False,
                 data_axis: Optional[str] = None) -> SceneState:
    """Lift a per-process SceneState into one of GlobalTensors: each
    process contributes its local block of the agent axis (and of the env
    axis over `data_axis` when `batch`), split per shard_state_specs. The
    inverse of host_local_state. The port's state has no random key, so
    JAX's typed-key branch has no counterpart here."""
    return _map_state(state, lambda x, spec: lift(x, mesh, spec), batch, data_axis)


def host_local_state(state: SceneState, mesh: Mesh, batch: bool = False,
                     data_axis: Optional[str] = None) -> SceneState:
    """Project a SceneState of GlobalTensors back to this process's local
    blocks (for host-side logging and checkpoints): global_state's exact
    inverse."""
    def lower(x: GlobalTensor, spec) -> torch.Tensor:
        if x.mesh is not mesh:
            raise ValueError("host_local_state: the state lives on another mesh")
        return x.local

    return _map_state(state, lower, batch, data_axis)


def make_mesh(axis_sizes: Optional[dict] = None, devices: Optional[Sequence] = None) -> Mesh:
    """Build a named mesh. Default: every visible CUDA device on the agent
    axis; after init_distributed, every process's devices in rank-major
    order (a mesh across processes).

    axis_sizes: ordered {axis_name: size} (-1 for "all remaining devices"),
    e.g. {"data": 2, "agents": 4}. `devices` (this process's only) may
    repeat a device."""
    ranks = None
    if devices is None and is_distributed():
        devices = [d for ds in _GROUP.devices for d in ds]
        ranks = [r for r, ds in enumerate(_GROUP.devices) for _ in ds]
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
    return Mesh(devices[:total], names, sizes, ranks[:total] if ranks is not None else None)


@functools.lru_cache(maxsize=1)
def default_mesh() -> Mesh:
    """All visible CUDA devices on the agent axis (cached)."""
    return make_mesh()


def local_mesh(mesh: Optional[Mesh], what: str) -> Mesh:
    """`mesh`, else default_mesh(), for `what`, which runs on one process
    (datagen and BC, whose chunks reach the host whole, as the JAX
    `_drain` fetches them; the fleet step; plain tensors): raises where the
    mesh spans processes, as the default mesh does after init_distributed.
    The ring's and gspmd's entry points, Scene and the trainers take a mesh
    across processes, with GlobalTensors or each process's block."""
    mesh = mesh or default_mesh()
    if mesh.distributed:
        raise ValueError(f"{what} runs on one process, and this mesh spans "
                         f"{len(set(mesh.ranks))}: pass a mesh of this process's devices "
                         f"(make_mesh(devices=...))")
    return mesh


def local_blocks(state: SceneState) -> SceneState:
    """This process's blocks of a SceneState of GlobalTensors (a state of
    plain tensors as it is)."""
    return SceneState(**{f.name: getattr(getattr(state, f.name), "local", getattr(state, f.name))
                         for f in dataclasses.fields(state)})


def like_global(local: SceneState, like: SceneState) -> SceneState:
    """`local`'s leaves as GlobalTensors of `like`'s layout, their blocks
    of one shape (`local` itself where `like` is plain)."""
    def leaf(name: str):
        x, y = getattr(local, name), getattr(like, name)
        return GlobalTensor(x, y.mesh, y.spec, y.shape) if isinstance(y, GlobalTensor) else x

    return SceneState(**{f.name: leaf(f.name) for f in dataclasses.fields(local)})


def stack_global(xs: Sequence, like=None):
    """torch.stack of tensors or of GlobalTensors (their blocks stacked, a
    new leading dimension kept whole); `like` gives an empty stack's
    layout."""
    first = xs[0] if xs else like
    if not isinstance(first, GlobalTensor):
        return torch.stack(xs) if xs else first.new_empty((0, *first.shape))
    local = (torch.stack([x.local for x in xs]) if xs
             else first.local.new_empty((0, *first.local.shape)))
    return GlobalTensor(local, first.mesh, (None, *first.spec),
                        torch.Size((len(xs), *first.shape)))


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
    transpose of the copy is the copy back. Under torch.export, which
    cannot trace the events, the same copy as ops/library.py's custom op."""
    if x.device == device:
        return x
    if torch.compiler.is_exporting():
        from ..ops import library

        return library.to_device(x, device)
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
