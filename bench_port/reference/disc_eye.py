"""The disc eye in plain PyTorch: each agent's W-pixel line, where the
nearest covering agent wins each pixel and is shaded by the squared radial
vignette, over the clear colour elsewhere, and with antialias blended by
its box-filter coverage of the pixel.

A restatement of the reference's eye (github.com/Dasch0/nenbody,
src/main.rs:693-704 and shaders/scene.frag:15-16, seen through a 1D
pinhole camera, gfx.rs:358-369) for the benchmark's comparisons; it
imports nothing of the program under test. The equations, per eye e with
unit heading d and target m at relative offset r:

    f = r . d          l = r . (d_y, -d_x)       t = tan(hfov / 2)
    visible  <=>  near < f < far  and  |u| <= 1 + du,  u = l / (f t),  du = R / (f t)
    covers pixel p (centre u_p)  <=>  visible and |off| < 1 (+ 1/(W du) with antialias),
                                      off = (u_p - u) / du
    winner: least f, ties to the lower m
    shade = albedo (1 - off_c^2 / 4), off_c = clamp(off, -1, 1);
            antialias: bg + clamp((1 - |off|) du W / 2 + 1/2, 0, 1) (shade - bg)

`winners` finds each pixel's winner without materialising every (eye,
target, pixel) triple: it keeps the visible pairs, lists the pixels each
may cover, tests those exactly and keeps the least (depth, target) key per
pixel. `shade` then evaluates the winner's pixel as a differentiable
function of the positions and headings, which is what the gradient of the
line is: the winner itself is piecewise constant.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

# (eye, target) pairs projected at once
PAIR_BUDGET = 1 << 24
NO_KEY = torch.iinfo(torch.int64).max


@dataclass(frozen=True)
class Eye:
    width: int
    hfov_deg: float = 90.0
    near: float = 1.0
    far: float = 10000.0
    sprite_radius: float = 1.0
    background: float = 0.2
    sprite_albedo: float = 1.0
    antialias: bool = False

    @property
    def tan_half(self) -> float:
        return math.tan(math.radians(self.hfov_deg) * 0.5)

    @classmethod
    def of(cls, vision: dict, antialias: bool) -> "Eye":
        keys = ("width", "hfov_deg", "near", "far", "sprite_radius", "background",
                "sprite_albedo")
        return cls(**{k: vision[k] for k in keys if k in vision}, antialias=antialias)


def pixel_centres(width: int, device, dtype=torch.float32) -> torch.Tensor:
    """NDC u of each pixel centre, 2 (k + 1/2) / W - 1."""
    return 2.0 * (torch.arange(width, dtype=dtype, device=device) + 0.5) / width - 1.0


def project(rx, ry, dx, dy, eye: Eye):
    """(u, du, f, visible) of relative offsets (rx, ry) in cameras of unit
    heading (dx, dy), broadcast against each other."""
    f = rx * dx + ry * dy
    lat = rx * dy - ry * dx
    in_depth = (f > eye.near) & (f < eye.far)
    ft = torch.where(in_depth, f, torch.ones_like(f)) * eye.tan_half
    u = lat / ft
    du = eye.sprite_radius / ft
    return u, du, f, in_depth & (u.abs() <= 1.0 + du)


def _depth_key(f: torch.Tensor) -> torch.Tensor:
    """Positive float32 depths as int64, in the same order."""
    return f.float().contiguous().view(torch.int32).to(torch.int64)


def winners(pos: torch.Tensor, dirs: torch.Tensor, eye: Eye, dtype=torch.float32,
            stats: dict | None = None) -> torch.Tensor:
    """[B, N, W] int64: the index of the target that wins each pixel of each
    agent's line, -1 where none covers it, for agents at `pos` [B, N, 2]
    with unit headings `dirs` seeing each other (the agent itself never
    shows: its depth is 0). Computed in `dtype`. With `stats`, adds the
    number of covering (eye, target, pixel) triples under "covered" and of
    pixels that a target wins under "won" (work/disc_eye*.py count them)."""
    b_all, n, _ = pos.shape
    w = eye.width
    dev = pos.device
    out = torch.full((b_all, n, w), -1, dtype=torch.int64, device=dev)
    u_p = pixel_centres(w, dev, dtype)
    step = max(1, PAIR_BUDGET // (n * n))
    with torch.no_grad():
        for b0 in range(0, b_all, step):
            p = pos[b0:b0 + step].to(dtype)
            d = dirs[b0:b0 + step].to(dtype)
            nb = p.shape[0]
            rx = p[:, None, :, 0] - p[:, :, None, 0]  # [b, eye, target]
            ry = p[:, None, :, 1] - p[:, :, None, 1]
            u, du, f, vis = project(rx, ry, d[:, :, None, 0], d[:, :, None, 1], eye)
            flat = vis.flatten().nonzero().squeeze(1)
            del rx, ry, vis
            u, du, f = u.flatten()[flat], du.flatten()[flat], f.flatten()[flat]
            safe = du.clamp(min=1e-30)
            hp = (1.0 / w) / safe
            thr = 1.0 + hp if eye.antialias else torch.ones_like(safe)
            # the pixels whose centres may lie within thr du of u, widened
            # well past rounding; the exact test below decides each
            reach = (thr * safe).double() * (1 + 1e-4) + 1e-6
            ud = u.double()
            lo = ((ud - reach + 1.0) * (0.5 * w) - 0.5).floor().clamp(0, w - 1).long()
            hi = ((ud + reach + 1.0) * (0.5 * w) - 0.5).ceil().clamp(0, w - 1).long()
            count = (hi - lo + 1).clamp(min=0)
            pair = torch.repeat_interleave(torch.arange(flat.numel(), device=dev), count)
            first = torch.cumsum(count, 0) - count
            pix = lo[pair] + (torch.arange(pair.numel(), device=dev) - first[pair])
            off = (u_p[pix] - u[pair]) / safe[pair]
            cover = off.abs() < thr[pair]
            pair, pix = pair[cover], pix[cover]
            if stats is not None:
                stats["covered"] = stats.get("covered", 0) + int(pair.numel())
            tgt = flat[pair] % n
            key = (_depth_key(f[pair]) << 32) | tgt
            slot = (flat[pair] // n) * w + pix  # (env, eye) row, pixel
            keys = torch.full((nb * n * w,), NO_KEY, dtype=torch.int64, device=dev)
            keys.scatter_reduce_(0, slot, key, "amin", include_self=True)
            hit = keys != NO_KEY
            if stats is not None:
                stats["won"] = stats.get("won", 0) + int(hit.sum())
            out[b0:b0 + nb] = torch.where(hit, keys & 0xFFFFFFFF,
                                          torch.full_like(keys, -1)).view(nb, n, w)
    return out


def shade(pos: torch.Tensor, dirs: torch.Tensor, winner: torch.Tensor, eye: Eye,
          dtype=torch.float32):
    """(shade, depth) [B, N, W] of the lines whose winners are `winner`,
    differentiable in pos and dirs (through the winner's offset, size and
    depth). Computed in `dtype`, returned in float32."""
    b, n, w = winner.shape
    hit = winner >= 0
    idx = winner.clamp(min=0).view(b, n * w, 1).expand(-1, -1, 2)
    p, d = pos.to(dtype), dirs.to(dtype)
    tgt = p.gather(1, idx).view(b, n, w, 2)
    rx = tgt[..., 0] - p[:, :, None, 0]
    ry = tgt[..., 1] - p[:, :, None, 1]
    u, du, f, _ = project(rx, ry, d[:, :, None, 0], d[:, :, None, 1], eye)
    safe = du.clamp(min=1e-30)
    off = (pixel_centres(w, pos.device, dtype) - u) / safe
    oc = off.clamp(-1.0, 1.0)
    s = eye.sprite_albedo * (1.0 - 0.25 * oc * oc)
    if eye.antialias:
        cov = ((1.0 - off.abs()) * ((0.5 * w) * safe) + 0.5).clamp(0.0, 1.0)
        s = eye.background + cov * (s - eye.background)
    s = torch.where(hit, s, torch.full_like(s, eye.background))
    depth = torch.where(hit, f, torch.full_like(f, eye.far))
    return s.float(), depth.float()


def lines(pos: torch.Tensor, vel: torch.Tensor, eye: Eye, dtype=torch.float32,
          stats: dict | None = None):
    """(shade, depth) [B, N, W] of every agent's line of its own env, the
    agents at `pos` looking along `vel`; differentiable in pos and vel."""
    dirs = heading_of(vel, dtype)
    return shade(pos, dirs, winners(pos.detach(), dirs.detach(), eye, dtype, stats), eye,
                 dtype)


def heading_of(vel: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    v = vel.to(dtype)
    th = torch.atan2(v[..., 1], v[..., 0])
    return torch.stack([torch.cos(th), torch.sin(th)], dim=-1)
