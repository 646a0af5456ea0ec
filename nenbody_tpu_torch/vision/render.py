"""Dense PyTorch eye renderer — the port's vision oracle and the plain
version of the CUDA eye kernels (counterpart of nenbody_tpu/vision/render.py:
`_agent_row`, `_agent_row_wireframe`, `render_rows`, `merge_rows`,
`render_lines*`, `render_single_row` and the appearance functions:
`sample_texture`, `checker_texture`, `default_agent_colors`, `to_rgb`,
`render_rows_rgb`).

Same contract as the JAX renderer: the nearest covering agent wins each
pixel (the reference's depth test, src/main.rs:608-632), shaded with the
squared-radial vignette (shaders/scene.frag:15-16), with the clear color for
uncovered pixels (src/main.rs:543) and, with antialias, box-filter edge
coverage (the 8x MSAA analog). Two sprite models: the disc splat
(`eye_rows`) and the reference's exact LineStrip triangle
(`eye_rows_wireframe`).

Appearance: `albedo` [..., M] gives each target its own base brightness in
place of cfg.sprite_albedo, and `texture` [Ht, Wt] (one skin shared by every
env) is sampled bilinearly at the winner's uv before the vignette and before
the antialias blend (shaders/scene.frag:11-16's tex * (1 - mag^2)): the disc
at (0.5 + 0.5 off, 0.5) along its splat, the wireframe at the winning edge's
interpolated uv. Both renderers evaluate the appearance at each pixel's
winner only; the JAX dense renderer shades every (edge, target, pixel) and
then selects, which gives the same values.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import VisionConfig
from ..state import SceneState
from ..utils import profiling
from . import camera

# Elements of one [..., chunk, M, W] tensor render_eyes materializes.
PLAIN_PIXEL_BUDGET = 1 << 24


def eye_rows(
    eye_pos: torch.Tensor,  # [..., E, 2] eye positions
    eye_dir: torch.Tensor,  # [..., E, 2] unit headings
    tgt: torch.Tensor,  # [..., M, 2] target positions (including self)
    cfg: VisionConfig,
    albedo: torch.Tensor | None = None,  # [..., M] per-target albedo
    texture: torch.Tensor | None = None,  # [Ht, Wt] sampled at the splat uv
    count: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render E eye lines against M targets: (shade, depth) [..., E, W].

    `_agent_row` of the JAX renderer with the eye axis written out. The
    self-target is culled for free: rel=0 gives forward depth 0 < near.
    `albedo` and `texture` as in the module docstring. With `count`, adds
    the (eye, target) pairs that cover a pixel and the covered (eye,
    target, pixel) triples to the recorder's `eye.pairs_covering` and
    `eye.triples` (utils/profiling.py; nothing outside recording()).
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
    if count:
        profiling.count("eye.pairs_covering", cover.any(dim=-1).sum())
        profiling.count("eye.triples", cover.sum())

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
    alb = cfg.sprite_albedo if albedo is None else winner_albedo(albedo, winner)
    if texture is not None:
        alb = alb * sample_texture(texture, torch.stack([0.5 + 0.5 * oc,
                                                         torch.full_like(oc, 0.5)], dim=-1))
    shade = alb * (1.0 - 0.25 * oc * oc)
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


def winner_albedo(albedo: torch.Tensor, winner: torch.Tensor) -> torch.Tensor:
    """albedo [..., M] read at each pixel's winning target winner [..., E, W]
    (a valid index everywhere; the caller masks misses)."""
    return albedo[..., None, :].expand(winner.shape[:-1] + albedo.shape[-1:]).gather(-1, winner)


def render_eyes(
    eye_pos: torch.Tensor,
    eye_dir: torch.Tensor,
    tgt: torch.Tensor,
    cfg: VisionConfig,
    chunk: int | None = None,
    albedo: torch.Tensor | None = None,
    texture: torch.Tensor | None = None,
    count: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`eye_rows` chunked over eyes so that the [..., chunk, M, W]
    intermediates stay within PLAIN_PIXEL_BUDGET elements (the dense analog
    of the reference's GRANULARITY=100 command-buffer batching,
    src/main.rs:584). Leading batch dims are kept whole. `count` as in
    eye_rows."""
    e, m = eye_pos.shape[-2], tgt.shape[-2]
    batch = eye_pos[..., 0, 0].numel()
    if chunk is None:
        chunk = max(1, PLAIN_PIXEL_BUDGET // max(1, batch * m * cfg.width))
    if chunk >= e:
        return eye_rows(eye_pos, eye_dir, tgt, cfg, albedo, texture, count)
    rows = [
        eye_rows(eye_pos[..., i:i + chunk, :], eye_dir[..., i:i + chunk, :], tgt, cfg, albedo,
                 texture, count)
        for i in range(0, e, chunk)
    ]
    return torch.cat([r[0] for r in rows], dim=-2), torch.cat([r[1] for r in rows], dim=-2)


# The reference's sprite geometry (src/main.rs:130-139): wireframe triangle
# verts with their uv coords, drawn as a LineStrip with index buffer
# [0, 1, 2, 0] (three edges). uv shades through the squared-radial vignette
# mix(tex, 0, |uv - 0.5|^2) of shaders/scene.frag:15-16.
SPRITE_VERTS = ((-1.0, -1.0), (1.0, 0.0), (-1.0, 1.0))
SPRITE_UVS = ((0.0, 0.0), (0.0, 1.0), (1.0, 1.0))
SPRITE_EDGES = ((0, 1), (1, 2), (2, 0))
# per edge: uv at its first vert and the uv step to its second (exact floats)
EDGE_UV = tuple(
    (SPRITE_UVS[a][0], SPRITE_UVS[a][1],
     SPRITE_UVS[b][0] - SPRITE_UVS[a][0], SPRITE_UVS[b][1] - SPRITE_UVS[a][1])
    for a, b in SPRITE_EDGES
)
# off-screen sentinel of an invalid edge's u-interval (outside [-1, 1])
OFF_SCREEN = 4.0


def sprite_view(eye_pos, eye_dir, tgt, hdg, cfg: VisionConfig):
    """The target sprites' 3 verts in the eyes' view frames.

    eye_pos, eye_dir, tgt, hdg: [..., 2], broadcast against each other
    (eyes [..., E, 1, 2] against targets [..., 1, M, 2] for a dense render;
    eyes against per-pixel winners for the pullback). Returns (f, l, live):
    forward and lateral coordinates of each vert (lists of 3 tensors of the
    broadcast shape) and the coincident-target cull, by exact equality
    (_agent_row_wireframe:171-173 of the JAX renderer: the eye's own sprite
    never shows). Each sprite turns to its target's heading (model matrix
    T(pos) * Rz(atan2(vel)), src/main.rs:398-400)."""
    r = cfg.sprite_radius
    cth, sth = hdg[..., 0], hdg[..., 1]
    px, py = tgt[..., 0], tgt[..., 1]
    ex, ey = eye_pos[..., 0], eye_pos[..., 1]
    dx, dy = eye_dir[..., 0], eye_dir[..., 1]
    f, l = [], []
    for vx, vy in SPRITE_VERTS:
        relx = (px + ((vx * r) * cth - (vy * r) * sth)) - ex
        rely = (py + ((vx * r) * sth + (vy * r) * cth)) - ey
        f.append(relx * dx + rely * dy)
        l.append(relx * dy - rely * dx)  # right = (dy, -dx)
    live = (px != ex) | (py != ey)
    return f, l, live


def edge_fragment(fa, la, fb, lb, live, u_p, cfg: VisionConfig):
    """One sprite edge (a, b) against the pixel centres u_p.

    fa, la, fb, lb, live broadcast against u_p (add a trailing pixel axis
    for [..., M] per-target fields). The pixel ray l = u*tan(hfov/2)*f hits
    the edge at tau = (ut*fa - la) / (dl - ut*df), depth fa + tau*df.
    Returns (depth, tau, lo, hi): depth +inf on a miss; (lo, hi) the edge's
    slab-clipped u-interval with antialias (the OFF_SCREEN sentinels when
    the edge is invalid), else None.

    Antialias (_agent_row_wireframe:187-233): tau is clipped to the
    [near, far] slab, the covered u-interval read off the clipped endpoints,
    and the fragment evaluated at the pixel centre clamped into it;
    operands are sanitised before each divide, so that autograd never meets
    inf * 0. `fk < far` stays strict: a slab-clipped fragment can land at
    exactly far."""
    df = fb - fa
    dl = lb - la
    lo = hi = None
    if cfg.antialias:
        t = camera.tan_half_fov(cfg)
        hp = 1.0 / cfg.width
        big = df.abs() > 1e-30
        safe_df = torch.where(big, df, 1e-30)
        t_near = (cfg.near - fa) / safe_df
        t_far = (cfg.far - fa) / safe_df
        tau_lo = torch.where(big, torch.maximum(t_near.minimum(t_far), torch.zeros_like(df)), 0.0)
        tau_hi = torch.where(big, torch.minimum(t_near.maximum(t_far), torch.ones_like(df)), 1.0)
        in_slab = (fa > cfg.near) & (fa < cfg.far)
        valid = live & torch.where(big, tau_lo < tau_hi, in_slab)
        f_lo = torch.where(valid, fa + tau_lo * df, 1.0)
        f_hi = torch.where(valid, fa + tau_hi * df, 1.0)
        u_a = (la + tau_lo * dl) / (t * f_lo.clamp(min=1e-30))
        u_b = (la + tau_hi * dl) / (t * f_hi.clamp(min=1e-30))
        e_lo, e_hi = torch.minimum(u_a, u_b), torch.maximum(u_a, u_b)
        lo = torch.where(valid, e_lo, OFF_SCREEN)
        hi = torch.where(valid, e_hi, -OFF_SCREEN)
        utc = torch.minimum(torch.maximum(u_p, e_lo), e_hi) * t
        num = utc * fa - la
        den = dl - utc * df
        ok = den.abs() > 1e-12
        tau = num / torch.where(ok, den, 1.0)
        tau = torch.minimum(torch.maximum(tau, tau_lo), tau_hi)
        fk = fa + tau * df
        cover = (e_hi > u_p - hp) & (e_lo < u_p + hp)
        hit = ok & valid & cover & (fk < cfg.far)
    else:
        ut = u_p * camera.tan_half_fov(cfg)
        num = ut * fa - la
        den = dl - ut * df
        ok = den.abs() > 1e-12  # edge parallel to the ray
        tau = num / torch.where(ok, den, 1.0)
        fk = fa + tau * df
        hit = ok & live & (tau >= 0.0) & (tau <= 1.0) & (fk > cfg.near) & (fk < cfg.far)
    return torch.where(hit, fk, float("inf")), tau, lo, hi


def fragment_shade(tau, uv, cfg: VisionConfig, alb=None, texture=None):
    """albedo * (1 - |uv - 0.5|^2) at uv = uv_a + tau * duv: uv = (ua_x,
    ua_y, du_x, du_y), floats or tensors broadcasting against tau. `alb`
    (a tensor broadcasting against tau) replaces cfg.sprite_albedo; a
    `texture` multiplies it by the skin sampled at uv."""
    uvx = uv[0] + tau * uv[2]
    uvy = uv[1] + tau * uv[3]
    base = cfg.sprite_albedo if alb is None else alb
    if texture is not None:
        base = base * sample_texture(texture, torch.stack([uvx, uvy], dim=-1))
    ux = uvx - 0.5
    uy = uvy - 0.5
    return base * (1.0 - (ux * ux + uy * uy))


def coverage(sp_lo, sp_hi, u_p, cfg: VisionConfig):
    """Box-filter share of the pixel footprint [u_p - hp, u_p + hp] that the
    sprite's u-interval [sp_lo, sp_hi] covers (the MSAA analog)."""
    hp = 1.0 / cfg.width
    return ((torch.minimum(sp_hi, u_p + hp) - torch.maximum(sp_lo, u_p - hp))
            / (2.0 * hp)).clamp(0.0, 1.0)


def eye_rows_wireframe(
    eye_pos: torch.Tensor,  # [..., E, 2] eye positions
    eye_dir: torch.Tensor,  # [..., E, 2] unit headings
    tgt: torch.Tensor,  # [..., M, 2] target positions (including self)
    tgt_hdg: torch.Tensor,  # [..., M, 2] target unit headings
    cfg: VisionConfig,
    albedo: torch.Tensor | None = None,  # [..., M] per-target albedo
    texture: torch.Tensor | None = None,  # [Ht, Wt] sampled at the edge uv
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render E eye lines against M exact reference sprites: (shade, depth,
    winner) [..., E, W], winner the winning target's index (-1 where no
    sprite covers the pixel).

    `_agent_row_wireframe` of the JAX renderer with the eye axis written
    out. The depth test takes the argmin over the flattened [3M] (edge,
    target) axis, edge-major, so a depth tie goes to the lower edge first
    and then to the lower target. The winner's albedo and texture sample
    shade it (module docstring); with antialias its shade then box-filters
    against the background by the winning sprite's coverage (the union of
    its 3 edge intervals)."""
    f, l, live = sprite_view(eye_pos[..., :, None, :], eye_dir[..., :, None, :],
                             tgt[..., None, :, :], tgt_hdg[..., None, :, :], cfg)
    u_p = camera.pixel_centers(cfg, device=eye_pos.device)  # [W]
    m = tgt.shape[-2]
    depths, taus = [], []
    sp_lo = sp_hi = None
    for a, b in SPRITE_EDGES:
        d_e, tau, lo, hi = edge_fragment(f[a][..., None], l[a][..., None], f[b][..., None],
                                         l[b][..., None], live[..., None], u_p, cfg)
        depths.append(d_e)
        taus.append(tau)
        if cfg.antialias:
            sp_lo = lo if sp_lo is None else torch.minimum(sp_lo, lo)
            sp_hi = hi if sp_hi is None else torch.maximum(sp_hi, hi)
    flat_d = torch.stack(depths, dim=-3).flatten(-3, -2)  # [..., E, 3M, W]
    k = flat_d.argmin(dim=-2)  # [..., E, W], the first minimum: edge-major
    best = flat_d.gather(-2, k[..., None, :]).squeeze(-2)
    tau_w = torch.stack(taus, dim=-3).flatten(-3, -2).gather(-2, k[..., None, :]).squeeze(-2)
    del flat_d, depths, taus
    hit = torch.isfinite(best)
    if texture is not None:
        tau_w = torch.where(hit, tau_w, 0.0)  # a miss's tau may be huge; keep its uv tame
    winner = k % m
    table = torch.tensor(EDGE_UV, dtype=torch.float32, device=eye_pos.device)[k // m]
    alb = None if albedo is None else winner_albedo(albedo, winner)
    sh = fragment_shade(tau_w, table.unbind(-1), cfg, alb, texture)
    if cfg.antialias:
        cov = coverage(sp_lo.squeeze(-1).gather(-1, winner), sp_hi.squeeze(-1).gather(-1, winner),
                       u_p, cfg)
        sh = cfg.background + cov * (sh - cfg.background)
    shade = torch.where(hit, sh, torch.full_like(sh, cfg.background))
    depth = torch.where(hit, best, torch.full_like(best, cfg.far))
    return shade, depth, torch.where(hit, winner, -1)


def render_eyes_wireframe(
    eye_pos: torch.Tensor,
    eye_dir: torch.Tensor,
    tgt: torch.Tensor,
    tgt_hdg: torch.Tensor,
    cfg: VisionConfig,
    chunk: int | None = None,
    albedo: torch.Tensor | None = None,
    texture: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`eye_rows_wireframe` chunked over eyes so that each chunk's
    [..., chunk, 3M, W] intermediates stay within PLAIN_PIXEL_BUDGET
    elements. Returns (shade, depth, winner)."""
    e, m = eye_pos.shape[-2], tgt.shape[-2]
    batch = eye_pos[..., 0, 0].numel()
    if chunk is None:
        chunk = max(1, PLAIN_PIXEL_BUDGET // max(1, batch * 3 * m * cfg.width))
    if chunk >= e:
        return eye_rows_wireframe(eye_pos, eye_dir, tgt, tgt_hdg, cfg, albedo, texture)
    rows = [
        eye_rows_wireframe(eye_pos[..., i:i + chunk, :], eye_dir[..., i:i + chunk, :], tgt,
                           tgt_hdg, cfg, albedo, texture)
        for i in range(0, e, chunk)
    ]
    return tuple(torch.cat([r[i] for r in rows], dim=-2) for i in range(3))


def render_rows(
    pos: torch.Tensor,
    vel: torch.Tensor,
    cfg: VisionConfig,
    chunk: int | None = None,
    targets: torch.Tensor | None = None,
    target_vel: torch.Tensor | None = None,
    albedo: torch.Tensor | None = None,
    texture: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render every agent's eye line. pos, vel: [..., N, 2].

    Returns (shade [..., N, W], depth [..., N, W]). Work is O(N^2 * W).
    `targets` (default: pos itself) renders the eyes against a different
    position set; partial renders merge with `merge_rows`. With
    sprite_mode='wireframe' the targets' sprites orient to their headings,
    so `target_vel` must accompany `targets`. `albedo` [..., M] (one per
    target) and `texture` [Ht, Wt] set the sprites' appearance (module
    docstring).
    """
    dirs = camera.unit_heading(vel)
    tgt = pos if targets is None else targets
    if cfg.sprite_mode == "wireframe":
        tvel = vel if targets is None else target_vel
        if tvel is None:
            raise ValueError("wireframe sprites need target_vel with targets")
        hdg = dirs if targets is None else camera.unit_heading(tvel)
        return render_eyes_wireframe(pos, dirs, tgt, hdg, cfg, chunk, albedo, texture)[:2]
    return render_eyes(pos, dirs, tgt, cfg, chunk, albedo, texture)


def render_single_row(
    pos: torch.Tensor,
    vel: torch.Tensor,
    eye: int,
    cfg: VisionConfig,
    albedo: torch.Tensor | None = None,
    texture: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One agent's eye line at any width, pos, vel [N, 2] -> (shade [W],
    depth [W]): the first-person viewport's pixel source (the reference
    re-renders the scene from the selected eye into the imgui viewport,
    src/main.rs:979-998). `albedo`/`texture` as in render_rows."""
    dirs = camera.unit_heading(vel)
    one = slice(eye, eye + 1)
    if cfg.sprite_mode == "wireframe":
        shade, depth, _ = eye_rows_wireframe(pos[one], dirs[one], pos, dirs, cfg, albedo, texture)
    else:
        shade, depth = eye_rows(pos[one], dirs[one], pos, cfg, albedo, texture)
    return shade[0], depth[0]


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


BACKGROUND_RGB = (0.1, 0.2, 0.3)  # clear color, src/main.rs:543
SPRITE_RGB = (0.85, 0.80, 0.70)  # skin-texture mean stand-in


def to_rgb(shade: torch.Tensor, depth: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """Colorize (shade, depth) rows into [..., W, 3] RGB: the reference's
    RGBA eye texture minus alpha (always 1, scene.frag:16). Sprite pixels
    take the sprite color scaled by the vignetted shade, misses the clear
    color."""
    hit = (depth < cfg.far)[..., None]
    bg = torch.tensor(BACKGROUND_RGB, dtype=shade.dtype, device=shade.device)
    sprite = torch.tensor(SPRITE_RGB, dtype=shade.dtype, device=shade.device)
    norm = shade[..., None] / max(cfg.sprite_albedo, 1e-6)
    return torch.where(hit, sprite * norm, bg)


def sample_texture(texture: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear texture sample, the sampler the reference binds for its
    skin.png (clamp-to-edge, linear filter; src/main.rs:358-376): texture
    [Ht, Wt], uv [..., 2] (uv.x along the width) -> [...]. A direct gather;
    differentiable in the texture and, between texel centres, in uv. The
    eye kernels sample with the same expressions in the same order. Texels
    are read by index_select, whose gradient adds by index_add_."""
    ht, wt = texture.shape
    x = uv[..., 0].clamp(0.0, 1.0) * (wt - 1)
    y = uv[..., 1].clamp(0.0, 1.0) * (ht - 1)
    x0 = x.detach().floor().long()
    y0 = y.detach().floor().long()
    x1 = (x0 + 1).clamp(max=wt - 1)
    y1 = (y0 + 1).clamp(max=ht - 1)
    fx = x - x0
    fy = y - y0
    flat = texture.reshape(-1)
    texel = lambda iy, ix: flat.index_select(0, (iy * wt + ix).reshape(-1)).reshape(iy.shape)
    t00, t01, t10, t11 = texel(y0, x0), texel(y0, x1), texel(y1, x0), texel(y1, x1)
    return t00 * (1 - fx) * (1 - fy) + t01 * fx * (1 - fy) + t10 * (1 - fx) * fy + t11 * fx * fy


def checker_texture(size: int = 32, cells: int = 4, lo: float = 0.35, hi: float = 1.0,
                    device: str | torch.device = "cpu") -> torch.Tensor:
    """Procedural [size, size] float32 checkerboard: a stand-in for the
    reference's skin.png (any [Ht, Wt] tensor in [0, 1] works)."""
    i = torch.arange(size, device=device) * cells // size
    board = (i[:, None] + i[None, :]) % 2
    return (lo + (hi - lo) * board).to(torch.float32)


def default_agent_colors(n: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """[n, 3] deterministic distinct colors (a golden-ratio hue walk): the
    stand-in for giving every agent its own skin (the reference shares one
    skin.png across agents, src/main.rs:322-356)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    h = (i * 0.61803398875) % 1.0  # golden-ratio spacing: maximally spread
    # compact HSV->RGB with s=0.65, v=1.0
    k = torch.stack([(5.0 + h * 6.0) % 6.0, (3.0 + h * 6.0) % 6.0, (1.0 + h * 6.0) % 6.0])
    f = 1.0 - 0.65 * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)
    return f.T.contiguous()


def render_rows_rgb(
    pos: torch.Tensor,
    vel: torch.Tensor,
    cfg: VisionConfig,
    colors: torch.Tensor,
    backend: str = "dense",
) -> torch.Tensor:
    """[..., N, W, 3] color observation with per-agent appearance: one
    render per channel against that channel's clear color
    (src/main.rs:543), the channel of each agent's color [..., N, 3] its
    albedo. backend='pallas' renders on the eye kernels (ops.raycast or
    ops.wireframe by sprite mode), 'dense' on this module."""
    chans = []
    for c in range(3):
        ccfg = dataclasses.replace(cfg, background=float(BACKGROUND_RGB[c]))
        alb = colors[..., c].contiguous()
        if backend == "pallas" and cfg.sprite_mode == "wireframe":
            from ..ops import wireframe

            sh, _ = wireframe.render_rows_wireframe_tiled(pos, vel, ccfg, albedo=alb)
        elif backend == "pallas":
            from ..ops import raycast

            sh, _ = raycast.render_rows_tiled(pos, vel, ccfg, albedo=alb)
        elif backend == "dense":
            sh, _ = render_rows(pos, vel, ccfg, albedo=alb)
        else:
            raise ValueError(f"render_rows_rgb: backend 'dense' or 'pallas', got {backend!r}")
        chans.append(sh)
    return torch.stack(chans, dim=-1)
