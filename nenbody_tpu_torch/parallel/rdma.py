"""The RDMA ring: gravity, boids and the disc eye over a mesh's agent axis,
each in ONE kernel launch per card that walks every hop (counterpart of
nenbody_tpu/parallel/rdma.py; csrc/rdma_ring.cu replaces its Pallas kernels
_rdma_gravity_kernel, _rdma_boids_kernel and _rdma_vision_kernel).

parallel/ring.py runs the same ring as one launch of a single-device kernel
per shard and hop, with the blocks moved between hops by the host. Here the
kernel itself stores each shard's circulating block into its right
neighbour's comm slot (a peer store where the neighbour is another card)
and a capacity handshake on flags in device memory makes slot reuse safe;
the schedule is in the kernel's header. Shard s meets block (s - k) mod D at
hop k, the JAX ppermute's order, and each hop adds the partial of the
shard's rows against the circulating block:

- gravity: the unscaled force sums, times G after;
- boids: the eight raw rule sums of physics.dense.boids_partials_cross,
  the pair i == j excluded on hop 0 (where a shard meets its own block),
  then dense.boids_finalize;
- the disc eye: the JAX RDMA kernel's raycast (off = (u_p - u_c) f t / r,
  covered iff in depth and off^2 < 1), merged into (best depth, winner
  off^2): within a hop the least depth, then the least off^2 among its
  targets; across hops a strict <, so an earlier hop keeps an exact tie;
  then the decode of rdma.py:641-647. Plain disc sprites only: antialias
  and the wireframe sprite raise, as in the JAX package. The kernel culls
  as csrc/disc_eye.cu does: rdma_disc_maybe_visible and
  rdma_disc_pixel_ranges are its two culls in plain PyTorch, with its
  float32 expressions, and rdma_disc_cover the exact test they must keep.

The functions take GLOBAL tensors [(B,) N, 2] and return them on the
inputs' device; a leading env batch folds into each shard's block env-major,
each env meeting only its own segment. Any N: far sentinels pad the agent
axis to a multiple of D (ring._pad_agents) and the kernel masks ragged
tiles (the JAX tile arguments, its pad to 256-multiples and its width rule
are TPU rules, dropped). On CPU tensors the plain versions run the same hop
partials in the same order in PyTorch; on CUDA tensors the kernel runs, or
the call raises: there is no fallback to parallel/ring.py. The mesh may name
one card several times (its shards then share the card's grid); shards on
different cards need peer access.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..config import BoidsConfig, GravityConfig, SimConfig, VisionConfig
from ..ops import boids as boids_ops
from ..ops import common, pairwise, raycast
from ..physics import dense
from ..vision import camera, render
from .mesh import AGENT_AXIS, Mesh, default_mesh, gather_blocks, on_device, send, split_blocks
from .ring import _pad_agents

MAX_SHARDS = 16  # rdma_ring.cu's
TABLE_COLS = 10  # pointers per shard in the kernel's table: in[2], eye_dir, out[5], slots, flags
# the boids kernel: at most BOIDS_THREADS threads a block, BOIDS_R rows a thread
BOIDS_THREADS, BOIDS_R = 256, 2
# the gravity kernel's plan aims at this many warps an SM: its grid cannot
# split j, and on an H100 at config 4 (N=65,536 on 4 shards) 128 blocks of
# 256 threads x 2 rows, 1,024 warps for 132 SMs, beat 256 blocks of 1 row
# (1.78 against 1.95 ms, PERF.md), which an aim of 8 picks
RDMA_GRAVITY_MIN_WARPS_PER_SM = 7
# the eye kernel: threads per block, and a unit's most eyes, row segment and
# (eye, pixel) keys
EYE_THREADS, EYE_MAX, SEG_MAX, KEY_PIXELS = 256, 64, 256, 2048


def _check_rank(pos: torch.Tensor) -> None:
    if pos.dim() not in (2, 3):
        raise ValueError(f"pos must be [N, 2] or [B, N, 2], got rank {pos.dim()}")


def _shard_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    return mesh.grid(None, axis)[0]


def _on_cuda(devs: Sequence[torch.device], *inputs: torch.Tensor) -> bool:
    """True where the shards' blocks lie on CUDA devices (the kernel), False
    where on the CPU (the plain versions); raise for a device mix of the
    inputs or of the mesh, and for inputs that autograd would follow: the
    kernels have no gradient, as the JAX ones (parallel.ring's functions
    are differentiable)."""
    common.use_kernel(*inputs)
    if common.needs_grad(*inputs):
        raise ValueError("the RDMA ring has no gradient; use parallel.ring for one")
    types = {d.type for d in devs}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        return True
    raise ValueError(f"the RDMA ring takes a mesh of CPU or of CUDA devices, got {types}")


def _split(x: torch.Tensor, devs, agent_dim: int = -2) -> List[torch.Tensor]:
    return split_blocks(x, [list(devs)], None, agent_dim)[0]


def _gather(blocks: Sequence[torch.Tensor], home: torch.device) -> torch.Tensor:
    return gather_blocks([list(blocks)], home, None)


def _circulating(blocks: Sequence[torch.Tensor], s: int, k: int) -> torch.Tensor:
    """The block shard s holds at hop k, on shard s's device."""
    return send(blocks[(s - k) % len(blocks)], blocks[s].device)


# -- the kernel launch ----------------------------------------------------------


def _join(cards: Sequence[torch.device]) -> None:
    """Order every card's current stream after the work enqueued so far on
    every other card's (a no-op for one card)."""
    if len(cards) < 2:
        return
    events = []
    for c in cards:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(c))
        events.append(ev)
    for c in cards:
        for ev in events:
            torch.cuda.current_stream(c).wait_event(ev)


def _launch_ring(name: str, planes: Sequence[Sequence[torch.Tensor]],
                 outs: Sequence[Sequence[torch.Tensor]], nb: int, nl: int, threads: int,
                 units: int, args: tuple, eye_dirs: Optional[Sequence[torch.Tensor]] = None,
                 rows: int = 1):
    """One launch of kernel `name` per card over the D shards whose payload
    planes (float32, contiguous, on the shard's device) are planes[s] and
    whose outputs are outs[s]: the comm slots and the flags on each shard's
    device, a persistent grid of P blocks per shard sized so that every
    block of a card is resident (P <= `units`, the units of a shard; `rows`
    names the gravity kernel's instantiation, as its launch does), peer
    access between neighbours on different cards."""
    devs = [p[0].device for p in planes]
    d = len(devs)
    if d > MAX_SHARDS:
        raise ValueError(f"{name}: at most {MAX_SHARDS} shards, got {d}")
    for s in range(d):
        for t in (*planes[s], *outs[s], *([] if eye_dirs is None else [eye_dirs[s]])):
            if t.device != devs[s] or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name}: shard {s} needs contiguous float32 tensors on "
                                 f"{devs[s]}")
        if devs[s] != devs[(s + 1) % d]:
            common.enable_peer_access(devs[s], devs[(s + 1) % d])
    cards = list(dict.fromkeys(devs))
    local = {c: [s for s in range(d) if devs[s] == c] for c in cards}
    fit = min(common.resident_blocks(name, threads, c, rows) // len(local[c]) for c in cards)
    if fit < 1:
        raise RuntimeError(f"{name}: the grid of {d} shards cannot be resident on "
                           f"{[str(c) for c in cards]}")
    p = min(fit, max(1, units))
    slot_floats = 2 * sum(-(-t.numel() // 4) * 4 for t in planes[0])  # rdma_ring.cu's layout
    slots = [torch.empty(slot_floats, dtype=torch.float32, device=dev) for dev in devs]
    flags = [torch.zeros(2 * p, dtype=torch.int32, device=dev) for dev in devs]
    _join(cards)  # every card's flags are zero before any card's launch
    table = (ctypes.c_uint64 * (d * TABLE_COLS))()
    for s in range(d):
        ptrs = [t.data_ptr() for t in planes[s]] + [0] * (2 - len(planes[s]))
        ptrs.append(0 if eye_dirs is None else eye_dirs[s].data_ptr())
        ptrs += [t.data_ptr() for t in outs[s]] + [0] * (5 - len(outs[s]))
        ptrs += [slots[s].data_ptr(), flags[s].data_ptr()]
        table[s * TABLE_COLS:(s + 1) * TABLE_COLS] = ptrs
    for c in cards:
        ids = (ctypes.c_int * len(local[c]))(*local[c])
        with on_device(c):
            common.KERNELS[name].launch(ctypes.addressof(table), ctypes.addressof(ids),
                                        len(local[c]), d, p, nb, nl, *args,
                                        common.stream_handle())
    _join(cards)  # the slots and flags outlive every card's kernel


def _card_shape(devs: Sequence[torch.device]) -> Tuple[int, int]:
    """(shards on the most crowded card, SMs of a card): what the RDMA
    kernels' unit plans count, the shards of a card sharing its grid."""
    sms = torch.cuda.get_device_properties(devs[0]).multi_processor_count
    return max(devs.count(d) for d in devs), sms


def _row_threads(rows: int, most: int) -> int:
    return min(most, -(-rows // 32) * 32)


def _lead(block: torch.Tensor) -> int:
    return block[..., 0, 0].numel()


# -- gravity (#14) ------------------------------------------------------------


def rdma_gravity_plan(nb: int, nl: int, shards_per_card: int, sms: int) -> Tuple[int, int, int]:
    """(T, R, units): the RDMA gravity kernel's blocks of T threads, R rows
    a thread, and the units (env, T R rows) of one shard, for nb envs of nl
    rows a shard with `shards_per_card` shards on a card of `sms` SMs:
    pairwise.pair_plan without a split of j (S = 1) over the envs of the
    card's shards together, aiming at RDMA_GRAVITY_MIN_WARPS_PER_SM warps an
    SM.
    The plain twin of csrc/rdma_ring.cu's rdma_gravity_plan, which must
    agree (nbt_rdma_gravity_plan); the wrapper launches from this one."""
    t, r, _, _, bi = pairwise.pair_plan(nb * shards_per_card, nl, nl, sms,
                                        RDMA_GRAVITY_MIN_WARPS_PER_SM, max_split=1)
    return t, r, nb * bi


def _plain_rdma_gravity(blocks: Sequence[torch.Tensor], cfg: GravityConfig) -> List[torch.Tensor]:
    """The kernel's plain version: per shard, the unscaled force sums of
    each hop's circulating block (pairwise.gravity_forces_plain with G = 1,
    the exact divide), added in hop order."""
    unit = dataclasses.replace(cfg, g=1.0, approx_reciprocal=False)
    sums = []
    for s in range(len(blocks)):
        acc = None
        for k in range(len(blocks)):
            part = pairwise.gravity_forces_plain(blocks[s], unit, pos_j=_circulating(blocks, s, k))
            acc = part if acc is None else acc + part
        sums.append(acc)
    return sums


def _rdma_gravity_cuda(blocks: Sequence[torch.Tensor], cfg: GravityConfig) -> List[torch.Tensor]:
    """The kernel, launched from rdma_gravity_plan (N=65,536 on 4 shards of
    an H100: T=256, R=2, 32 units a shard)."""
    nb, nl = _lead(blocks[0]), blocks[0].shape[-2]
    t, r, units = rdma_gravity_plan(nb, nl, *_card_shape([b.device for b in blocks]))
    outs = [torch.empty_like(b) for b in blocks]
    _launch_ring("rdma_gravity", [[b] for b in blocks], [[o] for o in outs], nb, nl, t, units,
                 (t, r, cfg.bias), rows=r)
    return outs


def _gravity(pos, cfg: SimConfig, mesh, axis, plain: bool) -> torch.Tensor:
    _check_rank(pos)
    devs = _shard_devices(mesh or default_mesh(), axis)
    n = pos.shape[-2]
    on_cuda = _on_cuda(devs, pos)
    (pos_p,), _ = _pad_agents([pos], n, len(devs))
    blocks = _split(pos_p, devs)
    run = _rdma_gravity_cuda if on_cuda and not plain else _plain_rdma_gravity
    return (_gather(run(blocks, cfg.gravity), pos.device) * cfg.gravity.g)[..., :n, :]


def rdma_ring_gravity_forces(
    pos: torch.Tensor,
    cfg: SimConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
) -> torch.Tensor:
    """Gravity forces for pos [(B,) N, 2] through the RDMA ring: the
    semantics of ring.ring_gravity_forces and the dense oracle (the
    self-pair included with the bias-softened denominator). On CUDA tensors
    the reciprocal is within an ulp of the exact divide, as csrc/gravity.cu's,
    whatever cfg.gravity.approx_reciprocal says, and the squared distance
    and the sums are fused multiply-adds; the plain version divides and
    rounds each product."""
    return _gravity(pos, cfg, mesh, axis, plain=False)


def rdma_ring_gravity_forces_plain(
    pos: torch.Tensor,
    cfg: SimConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
) -> torch.Tensor:
    """rdma_ring_gravity_forces' plain version on the mesh's devices, CUDA
    ones too (the kernel's yardstick): nothing launches."""
    return _gravity(pos, cfg, mesh, axis, plain=True)


# -- boids (#15) --------------------------------------------------------------


def _plain_rdma_boids(pos_b: Sequence[torch.Tensor], vel_b: Sequence[torch.Tensor],
                      cfg: BoidsConfig) -> List[tuple]:
    """The kernel's plain version: per shard, the raw rule sums of each
    hop's circulating (pos, vel) block (ops.boids.boids_partials_plain),
    added in hop order; the diagonal is masked where the circulating block
    is the shard's own (hop 0: the only hop where i == j happens)."""
    d = len(pos_b)
    sums = []
    for s in range(d):
        acc = None
        for k in range(d):
            part = boids_ops.boids_partials_plain(
                pos_b[s], vel_b[s], _circulating(pos_b, s, k), _circulating(vel_b, s, k), cfg,
                exclude_diagonal=(s - k) % d == s)
            acc = part if acc is None else tuple(a + p for a, p in zip(acc, part))
        sums.append(acc)
    return sums


def _rdma_boids_cuda(pos_b, vel_b, cfg: BoidsConfig) -> List[tuple]:
    """The kernel: T threads a block (a multiple of 32, at most
    BOIDS_THREADS), BOIDS_R rows a thread, one unit per T BOIDS_R rows of
    an env (N=65,536 on 4 shards: T=256, 32 units a shard)."""
    nb, nl = _lead(pos_b[0]), pos_b[0].shape[-2]
    outs = [tuple(torch.empty(p.shape[:-1] + shape, dtype=torch.float32, device=p.device)
                  for shape in ((2,), (), (2,), (2,), ())) for p in pos_b]
    threads = _row_threads(-(-nl // BOIDS_R), BOIDS_THREADS)
    _launch_ring("rdma_boids", list(zip(pos_b, vel_b)), outs, nb, nl, threads,
                 nb * -(-nl // (threads * BOIDS_R)),
                 (threads, cfg.cohesion_dist_sq, cfg.separation_dist * cfg.separation_dist,
                  cfg.alignment_dist * cfg.alignment_dist))
    return outs


def _boids(pos, vel, cfg: SimConfig, mesh, axis, plain: bool) -> torch.Tensor:
    _check_rank(pos)
    devs = _shard_devices(mesh or default_mesh(), axis)
    n = pos.shape[-2]
    on_cuda = _on_cuda(devs, pos, vel)
    (pos_p, vel_p), n_pad = _pad_agents([pos, vel], n, len(devs))
    pos_b, vel_b = _split(pos_p, devs), _split(vel_p, devs)
    if on_cuda and not plain:
        if n_pad > 1 << 24:  # the JAX kernel's float32 agent index is exact up to 2^24
            raise ValueError(f"rdma_boids: at most 2^24 agents, as the JAX RDMA kernel, got "
                             f"{n_pad}")
        sums = _rdma_boids_cuda(pos_b, vel_b, cfg.boids)
    else:
        sums = _plain_rdma_boids(pos_b, vel_b, cfg.boids)
    return _gather([dense.boids_finalize(s, cfg.boids) for s in sums], pos.device)[..., :n, :]


def rdma_ring_boids_velocity(
    pos: torch.Tensor,
    vel: torch.Tensor,
    cfg: SimConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
) -> torch.Tensor:
    """The replacement velocity (before the speed clamp) for pos, vel
    [(B,) N, 2] through the RDMA ring: the semantics of
    ring.ring_boids_velocity and dense.boids_accels. The (pos, vel) payload
    circulates; far sentinels stay inert in all three thresholded rules."""
    return _boids(pos, vel, cfg, mesh, axis, plain=False)


def rdma_ring_boids_velocity_plain(
    pos: torch.Tensor,
    vel: torch.Tensor,
    cfg: SimConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
) -> torch.Tensor:
    """rdma_ring_boids_velocity's plain version on the mesh's devices:
    nothing launches."""
    return _boids(pos, vel, cfg, mesh, axis, plain=True)


# -- the disc eye (#16) -------------------------------------------------------


def _rdma_disc_project(eye_pos, eye_dir, tgt, cfg: VisionConfig):
    """(f, valid, u_c, inv_du) [..., E, M], the JAX RDMA kernel's
    projection (rdma.py:540-549): forward depth f, near < f < far, the
    footprint centre u_c = l / (f t) and f t / r (f taken as 1 out of
    depth)."""
    t = camera.tan_half_fov(cfg)
    rel = tgt[..., None, :, :] - eye_pos[..., :, None, :]  # [..., E, M, 2]
    relx, rely = rel[..., 0], rel[..., 1]
    hx, hy = eye_dir[..., :, None, 0], eye_dir[..., :, None, 1]
    f = relx * hx + rely * hy
    lat = relx * hy - rely * hx
    valid = (f > cfg.near) & (f < cfg.far)
    fs = torch.where(valid, f, torch.ones_like(f))
    return f, valid, lat / (fs * t), fs * (t / cfg.sprite_radius)


def rdma_disc_cover(eye_pos, eye_dir, tgt, cfg: VisionConfig):
    """(f, o2, covered): the exact test of the JAX RDMA kernel
    (rdma.py:540-557) for the eyes [..., E, 2] against the targets
    [..., M, 2]: forward depth f [..., E, M], off^2 = ((u_p - u_c) f t /
    r)^2 at each pixel centre u_p, and covered = near < f < far and off^2 <
    1 ([..., E, M, W])."""
    f, valid, u_c, inv_du = _rdma_disc_project(eye_pos, eye_dir, tgt, cfg)
    off = (camera.pixel_centers(cfg, device=f.device) - u_c[..., None]) * inv_du[..., None]
    o2 = off * off
    return f, o2, valid[..., None] & (o2 < 1.0)


# The RDMA eye kernel's frustum test without a divide is csrc/pair_math.cuh's
# disc_may_be_visible, the single-device disc eye's; the CPU tests prove it
# keeps every target that rdma_disc_cover covers a pixel with.
rdma_disc_maybe_visible = raycast.disc_maybe_visible


def rdma_disc_pixel_ranges(eye_pos, eye_dir, tgt, cfg: VisionConfig):
    """(lo, hi, reach_plus) [..., E, M]: the pixels [lo, hi] (int64) of eye
    e's line that the RDMA eye kernel tests target m on (lo > hi: none, a
    target out of depth), and the distance from u_c within which it runs
    the exact test on a pixel centre, with the kernel's float32 expressions
    (draw_targets): the pixel span (ops.raycast.pixel_span) of a reach of
    1 / (f t / r). off^2 < 1 needs |fl(u_p - u_c)| fl(f t / r) < 1 and so
    |fl(u_p - u_c)| < r / (f t), within the span's slack."""
    _, valid, u_c, inv_du = _rdma_disc_project(eye_pos, eye_dir, tgt, cfg)
    lo, hi, reach_plus = raycast.pixel_span(u_c, torch.reciprocal(inv_du), cfg.width)
    return torch.where(valid, lo, 1), torch.where(valid, hi, 0), reach_plus


def _disc_hop_plain(eye_pos, eye_dir, tgt, cfg: VisionConfig):
    """One hop's (depth, off^2) [..., E, W] of the eyes against the target
    block, in the JAX RDMA kernel's arithmetic (rdma_disc_cover): the least
    covered depth, and the least off^2 among the targets at it (depth far
    where nothing covers the pixel)."""
    f, o2, covered = rdma_disc_cover(eye_pos, eye_dir, tgt, cfg)
    field = torch.where(covered, f[..., None], torch.full_like(o2, cfg.far))
    depth = field.amin(dim=-2)
    o2_win = torch.where(field == depth[..., None, :], o2, torch.ones_like(o2)).amin(dim=-2)
    return depth, o2_win


def _plain_rdma_vision(pos_b, dir_b, cfg: VisionConfig) -> List[tuple]:
    """The kernel's plain version: per shard, each hop's (depth, off^2)
    (_disc_hop_plain, chunked over eyes within render.PLAIN_PIXEL_BUDGET),
    merged in hop order by a strict < on depth."""
    d = len(pos_b)
    rows = []
    for s in range(d):
        e = pos_b[s].shape[-2]
        shape = pos_b[s].shape[:-1] + (cfg.width,)
        best_d = torch.full(shape, cfg.far, dtype=torch.float32, device=pos_b[s].device)
        best_o2 = torch.ones_like(best_d)
        for k in range(d):
            tgt = _circulating(pos_b, s, k)
            chunk = max(1, render.PLAIN_PIXEL_BUDGET
                        // max(1, _lead(tgt) * tgt.shape[-2] * cfg.width))
            parts = [_disc_hop_plain(pos_b[s][..., i:i + chunk, :], dir_b[s][..., i:i + chunk, :],
                                     tgt, cfg) for i in range(0, e, chunk)]
            depth, o2 = (torch.cat([p[j] for p in parts], dim=-2) for j in range(2))
            better = depth < best_d
            best_o2 = torch.where(better, o2, best_o2)
            best_d = torch.where(better, depth, best_d)
        rows.append((best_d, best_o2))
    return rows


def rdma_eye_plan(nb: int, nl: int, w: int, shards_per_card: int, sms: int):
    """(eyes, units): the RDMA eye kernel's unit of `eyes` eyes by a segment
    of min(w, SEG_MAX) pixels of their rows, and the units of one shard.
    eyes is the largest power of two up to EYE_MAX whose keys fit
    KEY_PIXELS, halved while the card's shards would give an SM fewer than
    two units (each eye's targets then spread over more warps)."""
    seg = min(w, SEG_MAX)
    segments = -(-w // seg)
    units = lambda e: nb * -(-nl // e) * segments
    eyes = EYE_MAX
    while eyes > 1 and eyes * seg > KEY_PIXELS:
        eyes //= 2
    while eyes > 1 and shards_per_card * units(eyes) < 2 * sms:
        eyes //= 2
    return eyes, units(eyes)


def _rdma_vision_cuda(pos_b, dir_b, cfg: VisionConfig) -> List[tuple]:
    nb, nl, w = _lead(pos_b[0]), pos_b[0].shape[-2], cfg.width
    eyes, units = rdma_eye_plan(nb, nl, w, *_card_shape([p.device for p in pos_b]))
    outs = [tuple(torch.empty(p.shape[:-1] + (w,), dtype=torch.float32, device=p.device)
                  for _ in range(2)) for p in pos_b]
    t = camera.tan_half_fov(cfg)
    _launch_ring("rdma_vision", [[p] for p in pos_b], outs, nb, nl, EYE_THREADS, units,
                 (eyes, w, t, t / cfg.sprite_radius, cfg.near, cfg.far, cfg.sprite_radius),
                 eye_dirs=dir_b)
    return outs


def _rows(pos, vel, vcfg: VisionConfig, mesh, axis, plain: bool):
    if vcfg.sprite_mode != "disc" or vcfg.antialias:
        raise ValueError("the RDMA vision prototype renders plain disc sprites")
    _check_rank(pos)
    devs = _shard_devices(mesh or default_mesh(), axis)
    n = pos.shape[-2]
    on_cuda = _on_cuda(devs, pos, vel)
    (pos_p, vel_p), _ = _pad_agents([pos, vel], n, len(devs))
    pos_b, dir_b = _split(pos_p, devs), _split(camera.unit_heading(vel_p), devs)
    run = _rdma_vision_cuda if on_cuda and not plain else _plain_rdma_vision
    rows = run(pos_b, dir_b, vcfg)
    depth = _gather([r[0] for r in rows], pos.device)
    o2 = _gather([r[1] for r in rows], pos.device)
    # the disc decode (rdma.py:641-647)
    val = vcfg.sprite_albedo * (1.0 - 0.25 * o2.clamp(max=1.0))
    shade = torch.where(depth < vcfg.far, val, torch.full_like(val, vcfg.background))
    return shade[..., :n, :], depth[..., :n, :]


def rdma_ring_render_rows(
    pos: torch.Tensor,
    vel: torch.Tensor,
    vcfg: VisionConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(shade, depth) [(B,) N, W] disc-vision rows through the RDMA ring:
    the eyes' rows stay with their shard, the position blocks circulate and
    each hop depth-merges into the rows (plain disc sprites: no antialias,
    no wireframe). Any N and width."""
    return _rows(pos, vel, vcfg, mesh, axis, plain=False)


def rdma_ring_render_rows_plain(
    pos: torch.Tensor,
    vel: torch.Tensor,
    vcfg: VisionConfig,
    mesh: Optional[Mesh] = None,
    axis: str = AGENT_AXIS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """rdma_ring_render_rows' plain version on the mesh's devices: nothing
    launches."""
    return _rows(pos, vel, vcfg, mesh, axis, plain=True)
