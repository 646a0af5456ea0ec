"""Multi-device backends of the port (counterpart of nenbody_tpu/parallel):
named device meshes (mesh), the agent-axis ring (ring, Scene
backend="ring"), its dense cross-check (auto, backend="gspmd"), and the
RDMA ring (rdma: gravity, boids and the disc eye, one kernel launch per
card walking every hop; a mesh may name one card several times)."""

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
from .rdma import rdma_ring_boids_velocity, rdma_ring_gravity_forces, rdma_ring_render_rows

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
    "rdma_ring_boids_velocity",
    "rdma_ring_gravity_forces",
    "rdma_ring_render_rows",
    "shard_state_specs",
]
