"""Pure-NumPy frame composition: top-down scene view + eye-line widget (the
port's copy of nenbody_tpu/viz/frame.py, which it cannot import: importing
any module of the JAX package runs its __init__, which imports jax). The
same arrays give the same bytes in both.

Reproduces what the reference shows on screen (SURVEY.md layer 4):
- a top-down scene view following agent 0 (src/main.rs:940-942), drawing
  each agent as the wireframe triangle sprite of init_geometry_data
  (verts (-1,-1),(1,0),(-1,1) drawn as a LineStrip, src/main.rs:130-139)
  rotated to its heading and translated to its position, over the clear
  color (0.1, 0.2, 0.3) (src/main.rs:543);
- the selected agent's 1D vision line stretched into a 2D image strip
  (the NenbodyUi eye widget, src/main.rs:82-96).

Everything is float32 RGB in [0, 1]; callers quantize for file output.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

CLEAR_COLOR = (0.1, 0.2, 0.3)  # src/main.rs:543
SPRITE_VERTS = np.array([[-1.0, -1.0], [1.0, 0.0], [-1.0, 1.0]], np.float32)
SPRITE_EDGES = [(0, 1), (1, 2), (2, 0)]  # index buffer [0,1,2,0], main.rs:137
AGENT_COLOR = (0.85, 0.80, 0.70)
SELECTED_COLOR = (1.0, 0.45, 0.25)


def _draw_polyline(img: np.ndarray, p0: np.ndarray, p1: np.ndarray, color) -> None:
    """Batch line rasterizer: p0, p1 [M, 2] in pixel coords (x, y)."""
    h, w, _ = img.shape
    seg = p1 - p0
    steps = int(max(2, np.ceil(np.abs(seg).max()) + 1)) if seg.size else 2
    t = np.linspace(0.0, 1.0, steps, dtype=np.float32)[None, :, None]
    pts = p0[:, None, :] + seg[:, None, :] * t  # [M, steps, 2]
    pts = pts.reshape(-1, 2)
    xi = np.round(pts[:, 0]).astype(np.int64)
    yi = np.round(pts[:, 1]).astype(np.int64)
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    img[yi[ok], xi[ok]] = color


def render_topdown(
    pos: np.ndarray,
    vel: np.ndarray,
    size: Tuple[int, int] = (540, 960),
    center: Optional[np.ndarray] = None,
    half_extent: float = 120.0,
    selected: Optional[int] = None,
    sprite_scale: float = 1.0,
) -> np.ndarray:
    """Top-down RGB frame [H, W, 3]. Follows agent 0 unless `center` given
    (the reference's scene camera follows entity 0, src/main.rs:940-942)."""
    h, w = size
    img = np.empty((h, w, 3), np.float32)
    img[:] = CLEAR_COLOR
    pos = np.asarray(pos, np.float32)
    vel = np.asarray(vel, np.float32)
    n = pos.shape[0]
    if center is None:
        center = pos[0]
    aspect = w / h
    ex, ey = half_extent * aspect, half_extent

    th = np.arctan2(vel[:, 1], vel[:, 0])  # rotation_of, src/main.rs:141-143
    c, s = np.cos(th), np.sin(th)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)  # [N,2,2]
    verts = (SPRITE_VERTS[None] * sprite_scale) @ rot.transpose(0, 2, 1) + pos[:, None]

    def to_px(p):  # world -> pixel (y up -> row down)
        x = (p[..., 0] - center[0] + ex) / (2 * ex) * (w - 1)
        y = (1 - (p[..., 1] - center[1] + ey) / (2 * ey)) * (h - 1)
        return np.stack([x, y], -1)

    vpx = to_px(verts)  # [N, 3, 2]
    for a, b in SPRITE_EDGES:
        _draw_polyline(img, vpx[:, a].reshape(-1, 2), vpx[:, b].reshape(-1, 2), AGENT_COLOR)
    if selected is not None:
        for a, b in SPRITE_EDGES:
            _draw_polyline(
                img, vpx[selected : selected + 1, a], vpx[selected : selected + 1, b],
                SELECTED_COLOR,
            )
    return img


def first_person_view(
    shade_row: np.ndarray,
    depth_row: np.ndarray,
    size: Tuple[int, int] = (270, 480),
    far: float = 10000.0,
    sprite_albedo: float = 1.0,
    thickness="perspective",
    sprite_radius: float = 1.0,
    hfov_deg: float = 90.0,
) -> np.ndarray:
    """The first-person viewport: the 2D scene re-rendered from an agent's
    perspective camera (the reference's third render pass into the imgui
    viewport texture, src/main.rs:979-998, target main.rs:707-717).

    The scene is planar and the eye camera lies IN the plane with up=+z
    (main.rs:770), so every sprite projects exactly onto the horizon row;
    the faithful 2D frame is the clear color with the 1D render across the
    vertical center. thickness:
      - an int: fixed line thickness in pixels (the raw LineStrip look —
        the reference's fragments rasterize at ~1px);
      - "perspective" (default): each hit column extends vertically by the
        sprite's apparent pixel size at its depth, half_px = R*w/(2*f*t) —
        the same perspective law as the horizontal splat — so near agents
        read tall and far agents collapse to the horizon line (depth cue).
    shade_row may be [W] (monochrome; tinted with AGENT_COLOR) or [W, 3]
    (per-agent color rows from a 3-channel render); depth/shade rows must
    be rendered at width size[1] (vision.render.render_single_row)."""
    import math

    h, w = size
    shade_row = np.asarray(shade_row, np.float32)
    depth_row = np.asarray(depth_row, np.float32)
    if shade_row.shape[0] != w:
        raise ValueError(
            f"row width {shade_row.shape[0]} != viewport width {w}; render "
            f"the row at the viewport width"
        )
    img = np.empty((h, w, 3), np.float32)
    img[:] = CLEAR_COLOR
    hit = depth_row < far
    if shade_row.ndim == 2:
        rgb = np.where(
            hit[:, None], shade_row, np.asarray(CLEAR_COLOR, np.float32)[None]
        )
    else:
        norm = shade_row / max(sprite_albedo, 1e-6)
        rgb = np.where(
            hit[:, None],
            np.asarray(AGENT_COLOR, np.float32)[None] * norm[:, None],
            np.asarray(CLEAR_COLOR, np.float32)[None],
        )
    if thickness == "perspective":
        t = math.tan(math.radians(hfov_deg) * 0.5)
        safe_d = np.maximum(depth_row, 1e-6)
        half = (sprite_radius * w) / (2.0 * safe_d * t)
        half_px = np.where(hit, np.clip(half, 1.0, h / 2.0), 0.0)  # [w]
        rows = np.abs(np.arange(h, dtype=np.float32) - (h - 1) / 2.0)
        mask = rows[:, None] < half_px[None, :]  # [h, w]
        img = np.where(mask[..., None], rgb[None, :, :], img)
        # misses still draw the thin horizon line (the clear-colored strip)
        r0 = max(0, h // 2 - 1)
        img[r0 : min(h, r0 + 2)] = np.where(
            mask[r0 : min(h, r0 + 2), :, None], img[r0 : min(h, r0 + 2)],
            rgb[None, :, :],
        )
        return img
    r0 = max(0, h // 2 - int(thickness) // 2)
    img[r0 : min(h, r0 + max(1, int(thickness)))] = rgb[None]
    return img


def eye_strip(
    obs_row: np.ndarray, height: int = 48, width: Optional[int] = None
) -> np.ndarray:
    """Stretch one agent's 1D vision line [W] (or [W, 3]) into a 2D strip
    [height, width, 3] — the NenbodyUi eye-image widget (src/main.rs:82-96,
    viewport-scale slider becomes the width/height arguments)."""
    row = np.asarray(obs_row, np.float32)
    if row.ndim == 1:
        row = np.repeat(row[:, None], 3, axis=1)
    w_in = row.shape[0]
    width = width or w_in
    idx = np.clip((np.arange(width) * w_in) // max(width, 1), 0, w_in - 1)
    strip = row[idx][None].repeat(height, axis=0)
    return strip


def compose(
    scene_img: np.ndarray,
    strip: Optional[np.ndarray] = None,
    pad: int = 4,
) -> np.ndarray:
    """Stack the scene view over the eye strip (the reference's UI overlays
    the widget; side-by-side stacking is the headless equivalent)."""
    if strip is None:
        return scene_img
    h, w, _ = scene_img.shape
    sh, sw, _ = strip.shape
    out = np.empty((h + sh + pad, max(w, sw), 3), np.float32)
    out[:] = 0.0
    out[:h, :w] = scene_img
    out[h + pad :, :sw] = strip
    return out


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
