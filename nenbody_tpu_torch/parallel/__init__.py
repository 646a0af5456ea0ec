"""Multi-device backends of the port (counterpart of nenbody_tpu/parallel):
named device meshes (mesh), the agent-axis ring (ring, Scene
backend="ring") and its dense cross-check (auto, backend="gspmd"). The RDMA
ring kernels of nenbody_tpu/parallel/rdma.py, which need two or more cards,
are not ported yet (ROADMAP queue 2)."""

from .mesh import (
    AGENT_AXIS,
    DATA_AXIS,
    Mesh,
    agent_axis_of,
    data_axis_of,
    default_mesh,
    gather_state,
    make_mesh,
    place_state_on_mesh,
    shard_state_specs,
)

__all__ = [
    "AGENT_AXIS",
    "DATA_AXIS",
    "Mesh",
    "agent_axis_of",
    "data_axis_of",
    "default_mesh",
    "gather_state",
    "make_mesh",
    "place_state_on_mesh",
    "shard_state_specs",
]
