"""Dense PyTorch eye renderer, disc sprites — the port's vision oracle and
the plain version of the CUDA eye kernel (counterpart of the disc subset of
nenbody_tpu/vision/render.py: `_agent_row`, `render_rows`, `merge_rows`,
`render_lines*`).

Same contract as the JAX renderer: the nearest covering agent wins each
pixel (the reference's depth test, src/main.rs:608-632), shaded with the
squared-radial vignette (shaders/scene.frag:15-16: shade = albedo *
(1 - off^2/4)), with the clear color for uncovered pixels (src/main.rs:543)
and, with antialias, box-filter edge coverage (the 8x MSAA analog).

The wireframe sprite, per-agent albedo, textures and RGB are not ported yet
(ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import VisionConfig
from ..state import SceneState
from . import camera

# Elements of one [..., chunk, M, W] tensor render_eyes materializes.
PLAIN_PIXEL_BUDGET = 1 << 24


def eye_rows(
    eye_pos: torch.Tensor,  # [..., E, 2] eye positions
    eye_dir: torch.Tensor,  # [..., E, 2] unit headings
    tgt: torch.Tensor,  # [..., M, 2] target positions (including self)
    cfg: VisionConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render E eye lines against M targets: (shade, depth) [..., E, W].

    `_agent_row` of the JAX renderer with the eye axis written out. The
    self-target is culled for free: rel=0 gives forward depth 0 < near.
    """
    rel = tgt[..., None, :, :] - eye_pos[..., :, None, :]  # [..., E, M, 2]
    u_c, du, f, visible = camera.project(rel, eye_dir, cfg)  # [..., E, M]
    u_p = camera.pixel_centers(cfg, device=eye_pos.device)  # [W]

    # Normalized offset of each pixel within each target's splat, [..., E, M, W].
    safe_du = du.clamp(min=1e-30)
    off = (u_p - u_c[..., None]) / safe_du[..., None]
    if cfg.antialias:
        # pixel half-width in off units; edges cover fractionally
        hp = (1.0 / cfg.width) / safe_du
        cover = visible[..., None] & (off.abs() < 1.0 + hp[..., None])
    else:
        cover = visible[..., None] & (off.abs() < 1.0)

    # Depth test: nearest covering target wins the pixel; argmin returns the
    # first minimum, so a depth tie goes to the lowest target index.
    depth_field = torch.where(cover, f[..., None], torch.full_like(off, float("inf")))
    winner = depth_field.argmin(dim=-2)  # [..., E, W]
    best = depth_field.gather(-2, winner[..., None, :]).squeeze(-2)
    hit = torch.isfinite(best)

    # Vignette: uv distance from sprite center is |off|/2 (uv spans [0,1]);
    # frag does mix(tex, 0, mag^2) => shade = albedo * (1 - off^2/4).
    o = off.gather(-2, winner[..., None, :]).squeeze(-2)  # [..., E, W]
    oc = o.clamp(-1.0, 1.0)
    shade = cfg.sprite_albedo * (1.0 - 0.25 * oc * oc)
    if cfg.antialias:
        # exact 1D box-filter coverage of the splat edge over the pixel
        # footprint (the MSAA analog); interior pixels saturate to 1.
        s_win = (0.5 * cfg.width) * safe_du.gather(-1, winner)
        covf = ((1.0 - o.abs()) * s_win + 0.5).clamp(0.0, 1.0)
        shade = cfg.background + covf * (shade - cfg.background)

    bg = torch.full_like(shade, cfg.background)
    shade = torch.where(hit, shade, bg)
    depth = torch.where(hit, best, torch.full_like(best, cfg.far))
    return shade, depth


def render_eyes(
    eye_pos: torch.Tensor,
    eye_dir: torch.Tensor,
    tgt: torch.Tensor,
    cfg: VisionConfig,
    chunk: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`eye_rows` chunked over eyes so that the [..., chunk, M, W]
    intermediates stay within PLAIN_PIXEL_BUDGET elements (the dense analog
    of the reference's GRANULARITY=100 command-buffer batching,
    src/main.rs:584). Leading batch dims are kept whole."""
    e, m = eye_pos.shape[-2], tgt.shape[-2]
    batch = eye_pos[..., 0, 0].numel()
    if chunk is None:
        chunk = max(1, PLAIN_PIXEL_BUDGET // max(1, batch * m * cfg.width))
    if chunk >= e:
        return eye_rows(eye_pos, eye_dir, tgt, cfg)
    rows = [
        eye_rows(eye_pos[..., i:i + chunk, :], eye_dir[..., i:i + chunk, :], tgt, cfg)
        for i in range(0, e, chunk)
    ]
    return torch.cat([r[0] for r in rows], dim=-2), torch.cat([r[1] for r in rows], dim=-2)


def check_disc(cfg: VisionConfig) -> None:
    """Raise for the sprite modes the port does not render yet."""
    if cfg.sprite_mode != "disc":
        raise NotImplementedError(
            "sprite_mode='wireframe' is not ported yet (ROADMAP queue 1 "
            "items 4 and 11, queue 2 kernels 7-9); the port renders disc "
            "sprites"
        )


def render_rows(
    pos: torch.Tensor,
    vel: torch.Tensor,
    cfg: VisionConfig,
    chunk: int | None = None,
    targets: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render every agent's eye line. pos, vel: [..., N, 2].

    Returns (shade [..., N, W], depth [..., N, W]). Work is O(N^2 * W).
    `targets` (default: pos itself) renders the eyes against a different
    position set; partial renders merge with `merge_rows`.
    """
    check_disc(cfg)
    tgt = pos if targets is None else targets
    return render_eyes(pos, camera.unit_heading(vel), tgt, cfg, chunk)


def merge_rows(a, b):
    """Depth-min merge of two partial renders (shade, depth) — associative
    and commutative up to depth ties, so partial renders against disjoint
    target blocks compose into the full render."""
    sa, da = a
    sb, db = b
    take_b = db < da
    return torch.where(take_b, sb, sa), torch.where(take_b, db, da)


def render_lines(state: SceneState, cfg: VisionConfig) -> torch.Tensor:
    """`observe()`: the [..., N, W] float32 observation tensor."""
    return render_rows(state.pos, state.vel, cfg)[0]


def render_lines_with_depth(
    state: SceneState, cfg: VisionConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(shade [..., N, W], depth [..., N, W])."""
    return render_rows(state.pos, state.vel, cfg)
