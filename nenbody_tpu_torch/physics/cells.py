"""Cell-list (spatial-hash) boids backend for sparse regimes (the port's
counterpart of nenbody_tpu/physics/cells.py, plain PyTorch: the JAX module
is jnp, not a Pallas kernel).

The flocking rules are radius-limited (BoidsConfig: cohesion d^2 < 1000,
separation d < 5, alignment |dv| < 500, src/main.rs:450-452), so in
LOW-density scenes almost every (i, j) pair fails every threshold and the
O(N^2) folds waste their work. This backend buckets agents into hashed grid
cells of side >= the rule radius and evaluates each agent only against the
9 neighbour cells' occupants: O(N * 9K) with K the bucket capacity.

DESIGN.md §4c records why this loses at the reference's spawn density
(about 1,600 agents per cohesion cell: the exactness capacity K erases the
asymptotic gain), hence opt-in (`backend="cells"`), with the fused boids
kernel remaining the default.

Exactness (pinned by tests/test_torch_cells.py against the JAX module):
- every true neighbour within radius r lies in one of the 9 cells around
  the agent's cell, whose hash bucket IS scanned;
- hash collisions only ADD candidates (filtered by the exact thresholds)
  and never remove them; duplicate buckets among an agent's 9 neighbour
  hashes are scanned once, so no pair counts twice;
- the one approximation is the bucket capacity K: buckets holding more
  than K agents silently drop the overflow. `cells_stats` reports the
  largest occupancy so K can be sized exactly; the Scene stepper uses
  cfg.boids.cells_capacity.

The hash and the candidate order are the JAX module's bit for bit: the
uint32 wrap-around products are computed in int64 and masked to 32 bits
(negative cell coordinates wrap as `astype(uint32)` does), the agents are
sorted by bucket with a stable sort (as `jnp.argsort`), and the bucket
ranges come from searchsorted on both sides.

The velocity-space alignment rule (src/main.rs:497 measures |v_j - v_i|)
dispatches statically on the config: when 2*max_speed < alignment_dist
(the reference's regime) the speed clamp makes the mask all-true for every
stepper-produced state, so the exact O(N) mean identity applies. Only when
the alignment radius discriminates does rule 3 get the same cell-list
machinery over velocity coordinates. States injected with |v| > max_speed
void the static bound (the stepper's clamp restores it after one step).

Memory: the candidate tensors are [rows, 9K] per rule; agents are taken in
chunks of at most CELLS_PAIR_BUDGET candidate slots, so a step at the
reference's density (K about 2,000 at N=65,536) stays within a few GB.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import BoidsConfig, SimConfig
from ..state import SceneState
from . import dense

# Knuth/Murmur-flavored odd multipliers; uint32 wrap-around is the hash.
_HASH_PX = 2654435761
_HASH_PY = 2246822519
_MASK32 = 0xFFFFFFFF

_NEIGHBOR_OFFSETS = tuple((dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

# Candidate slots (agents x 9K) one chunk of boids_velocity_cells gathers:
# about ten [chunk, 9K] temporaries of 4-8 bytes live at once.
CELLS_PAIR_BUDGET = 1 << 25


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c,
    with every partial product below 2^49 (no int64 overflow)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _bucket_hash(cx: torch.Tensor, cy: torch.Tensor, table_size: int) -> torch.Tensor:
    """Hash integer cell coords into [0, table_size) (table_size pow2):
    the JAX `(cx.astype(uint32) * PX ^ cy.astype(uint32) * PY) & (T - 1)`."""
    ux = cx.to(torch.int64) & _MASK32  # two's complement: astype(uint32)
    uy = cy.to(torch.int64) & _MASK32
    h = _mul_u32(ux, _HASH_PX) ^ _mul_u32(uy, _HASH_PY)
    return (h & (table_size - 1)).to(torch.int32)


def _auto_table_size(n: int) -> int:
    """Power-of-two table with ~2x load headroom, clamped to sane bounds."""
    return max(64, min(1 << 16, 1 << (2 * n - 1).bit_length()))


def _cells(coords: torch.Tensor, cell_size: float) -> Tuple[torch.Tensor, torch.Tensor]:
    inv_s = 1.0 / cell_size
    cx = torch.floor(coords[:, 0] * inv_s).to(torch.int32)
    cy = torch.floor(coords[:, 1] * inv_s).to(torch.int32)
    return cx, cy


class CellTable(NamedTuple):
    """Points sorted by bucket: each point's cell, the sort order, and each
    bucket's first slot and occupancy in that order."""

    cx: torch.Tensor  # [N] int32
    cy: torch.Tensor  # [N] int32
    order: torch.Tensor  # [N] int64, points sorted by bucket (stable)
    start: torch.Tensor  # [T] int64
    count: torch.Tensor  # [T] int64
    table_size: int


def cell_table(coords: torch.Tensor, cell_size: float,
               table_size: Optional[int] = None) -> CellTable:
    """The hashed cell list of `coords` [N, 2] at cells of side `cell_size`."""
    n = coords.shape[0]
    h_size = table_size or _auto_table_size(n)
    cx, cy = _cells(coords, cell_size)
    h = _bucket_hash(cx, cy, h_size)
    order = torch.argsort(h, stable=True)  # agents sorted by bucket
    hs = h[order].contiguous()
    buckets = torch.arange(h_size, dtype=hs.dtype, device=hs.device)
    start = torch.searchsorted(hs, buckets, side="left")
    count = torch.searchsorted(hs, buckets, side="right") - start
    return CellTable(cx, cy, order, start, count, h_size)


def table_candidates(table: CellTable, rows: slice, capacity: int):
    """(cand [R, 9K] int64 indices, valid [R, 9K] bool) of the points
    `rows` of the table's point set (see neighbor_candidates)."""
    n = table.order.shape[0]
    cx, cy = table.cx[rows], table.cy[rows]
    r = cx.shape[0]
    # the 9 neighbour-cell buckets of each point, deduplicated (collisions
    # can alias two neighbour cells to one bucket; scanning it twice would
    # double-count every occupant)
    nh = torch.stack(
        [_bucket_hash(cx + dx, cy + dy, table.table_size) for dx, dy in _NEIGHBOR_OFFSETS],
        dim=1,
    ).long()  # [R, 9]
    seen_before = torch.triu(torch.ones((9, 9), dtype=torch.bool, device=cx.device), 1)
    dup = ((nh[:, :, None] == nh[:, None, :]) & seen_before[None]).any(dim=1)  # [R, 9]

    st = table.start[nh]  # [R, 9]
    ct = torch.where(dup, torch.zeros_like(st), table.count[nh])
    ar = torch.arange(capacity, dtype=torch.int64, device=cx.device)
    slot = st[:, :, None] + ar[None, None, :]  # [R, 9, K] positions in `order`
    valid = ar[None, None, :] < ct[:, :, None]
    cand = table.order[slot.clamp(0, n - 1)]
    return cand.reshape(r, -1), valid.reshape(r, -1)


def neighbor_candidates(
    coords: torch.Tensor,  # [N, 2] points (position OR velocity space)
    cell_size: float,
    capacity: int,
    table_size: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate neighbour indices per point via a hashed cell list.

    Returns (cand [N, 9*capacity] int64 indices, valid [N, 9*capacity]
    bool). Every point within `cell_size` of point i is guaranteed a
    candidate slot as long as no scanned bucket holds more than `capacity`
    points; the caller must still apply its exact radius test (candidates
    include the full 3x3 cell block plus hash-collision strangers) and a
    self-exclusion.
    """
    table = cell_table(coords, cell_size, table_size)
    return table_candidates(table, slice(None), capacity)


def cells_stats(
    coords: torch.Tensor, cell_size: float, table_size: Optional[int] = None
) -> dict:
    """Bucket-occupancy diagnostics for sizing `capacity` (host-side ints).

    max_occupancy is the exactness bound: capacity >= max_occupancy makes
    the cell-list rules exact for this point set."""
    n = coords.shape[0]
    h_size = table_size or _auto_table_size(n)
    cx, cy = _cells(coords, cell_size)
    h = _bucket_hash(cx, cy, h_size)
    occ = torch.bincount(h.long(), minlength=h_size)
    used = int((occ > 0).sum())
    return {
        "table_size": h_size,
        "max_occupancy": int(occ.max()),
        "mean_occupancy": float(torch.tensor(n, dtype=torch.float32) / max(1, used)),
        "used_buckets": used,
    }


def _rule_sums(coords: torch.Tensor, cand: torch.Tensor, valid: torch.Tensor,
               ids: torch.Tensor, radius_sq: float, second_sq: Optional[float] = None):
    """For the rows `ids` of `coords`: (count, (sum x_j, sum y_j)) over the
    candidates within radius_sq, and with second_sq also -(sum dx, sum dy)
    over those within second_sq (the separation rule)."""
    cx_p = coords[:, 0][cand]  # [R, 9K], componentwise
    cy_p = coords[:, 1][cand]
    dx = cx_p - coords[ids, 0:1]
    dy = cy_p - coords[ids, 1:2]
    d2 = dx * dx + dy * dy
    m = valid & (cand != ids[:, None])
    m1 = m & (d2 < radius_sq)
    zero = torch.zeros((), dtype=coords.dtype, device=coords.device)
    cnt = m1.sum(dim=-1).to(coords.dtype)
    total = torch.stack([torch.where(m1, cx_p, zero).sum(-1),
                         torch.where(m1, cy_p, zero).sum(-1)], dim=-1)
    if second_sq is None:
        return cnt, total
    m2 = m & (d2 < second_sq)
    repel = -torch.stack([torch.where(m2, dx, zero).sum(-1),
                          torch.where(m2, dy, zero).sum(-1)], dim=-1)
    return cnt, total, repel


def boids_velocity_cells(
    pos: torch.Tensor,
    vel: torch.Tensor,
    cfg: BoidsConfig,
    capacity: Optional[int] = None,
    table_size: Optional[int] = None,
) -> torch.Tensor:
    """Replacement velocity (pre-clamp), cell-list evaluation; pos, vel
    [..., N, 2], batched too.

    Matches dense.boids_accels exactly (up to fp32 summation order) whenever
    `capacity` covers the densest scanned bucket in BOTH spaces: position
    cells of side sqrt(cohesion_dist_sq) and, unless the alignment identity
    applies, velocity cells of side alignment_dist."""
    if pos.dim() == 3:
        return torch.stack([boids_velocity_cells(p, v, cfg, capacity, table_size)
                            for p, v in zip(pos, vel)])
    n = pos.shape[0]
    k = capacity or cfg.cells_capacity
    chunk = max(1, CELLS_PAIR_BUDGET // (9 * k))
    identity = cfg.global_alignment or 2.0 * cfg.max_speed < cfg.alignment_dist

    # position-space rules (cohesion + separation): one cell list at the
    # LARGER radius serves both exactly (separation's 5 lies far inside the
    # cohesion cell's sqrt(1000))
    pos_table = cell_table(pos, math.sqrt(cfg.cohesion_dist_sq), table_size)
    vel_table = None if identity else cell_table(vel, cfg.alignment_dist, table_size)
    parts = []
    for lo in range(0, n, chunk):
        rows = slice(lo, min(n, lo + chunk))
        ids = torch.arange(rows.start, rows.stop, device=pos.device)
        cand, valid = table_candidates(pos_table, rows, k)
        cnt1, sum1, repel = _rule_sums(pos, cand, valid, ids, cfg.cohesion_dist_sq,
                                       cfg.separation_dist * cfg.separation_dist)
        if vel_table is None:
            parts.append((sum1, cnt1, repel))
            continue
        cand_v, valid_v = table_candidates(vel_table, rows, k)
        cnt3, sum3 = _rule_sums(vel, cand_v, valid_v, ids,
                                cfg.alignment_dist * cfg.alignment_dist)
        parts.append((sum1, cnt1, repel, sum3, cnt3))
    cols = [torch.cat(c) for c in zip(*parts)]
    if identity:
        # exact O(N) identity: when the speed clamp bounds |v| <= max_speed,
        # |v_j - v_i| <= 2*max_speed < alignment_dist makes the mask
        # all-true; cnt3 = n-1, sum3 = total - v_i
        sum3 = vel.sum(dim=0, keepdim=True) - vel
        cnt3 = torch.full((n,), n - 1, dtype=pos.dtype, device=pos.device)
        cols += [sum3, cnt3]
    return dense.boids_finalize(tuple(cols), cfg)


def boids_step(state: SceneState, cfg: SimConfig, generator=None) -> SceneState:
    """Scene stepper for backend='cells' (boids only)."""
    return dense.boids_integrate(state, boids_velocity_cells(state.pos, state.vel, cfg.boids),
                                 cfg)


STEPPERS = {
    "boids": boids_step,
    "random": dense.random_step,  # no pairwise interaction to bucket
}
