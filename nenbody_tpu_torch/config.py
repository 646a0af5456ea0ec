"""Configuration for the PyTorch port of nenbody-tpu.

Counterpart of nenbody_tpu/config.py: an own copy of its frozen dataclasses
and PRESETS, with identical fields, defaults and validation, so that the port
never imports jax (importing nenbody_tpu.config runs nenbody_tpu/__init__.py,
which imports jax). tests/test_torch_config.py pins the two equal.

The reference (Dasch0/nenbody) hardcodes every knob as an inline constant
(`src/main.rs:652-654`, `src/main.rs:411-413`, `src/main.rs:450-456`) and
selects the controller by editing a call site (`src/main.rs:925`). Here every
knob is an explicit, frozen dataclass so configs are hashable.

In the port, backend="pallas" means "the hand-written CUDA kernels"
(nenbody_tpu_torch/ops); "dense" always runs the plain PyTorch functions.

Presets at the bottom mirror the five configs in BASELINE.json.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GravityConfig:
    """All-pairs gravity controller constants.

    Reference semantics (src/main.rs:404-441): for each agent i,
        g_i = sum_j (x_j - x_i) * g / (|x_j - x_i|^2 + bias)
        v_i += g_i * dt
        x_i += v_i            # NOTE: no dt on the position update
    The self-pair j == i is included (its numerator is zero, the `bias`
    keeps the denominator finite). This is a 1/r force law softened
    additively, integrated with semi-implicit Euler.
    """

    dt: float = 0.1  # src/main.rs:411
    g: float = 0.001  # src/main.rs:412
    bias: float = 1e-7  # src/main.rs:413
    # Fast mode for the gravity kernel: approximate reciprocal for the
    # 1/(d^2+bias) term (~2^-12 relative error on each pair weight). False =
    # exact fp32 division, the oracle-parity default.
    approx_reciprocal: bool = False
    # Reference mode vs corrected mode (SURVEY.md §7 hard-part 3): the
    # reference integrates `x += v` with NO dt on the position
    # (src/main.rs:436) — a quirk parity tests pin. Setting True uses the
    # standard semi-implicit Euler `x += v*dt` instead.
    dt_on_position: bool = False


@dataclasses.dataclass(frozen=True)
class BoidsConfig:
    """Flocking controller constants.

    Reference semantics (src/main.rs:443-526), per agent i over all j != i:
      - cohesion: mean position of j with |x_j - x_i|^2 < cohesion_dist_sq
        (note: threshold on SQUARED distance, src/main.rs:474; and the rule
        uses the raw mean position, not (mean - x_i))
      - separation: -sum (x_j - x_i) for |x_j - x_i| < separation_dist
        (threshold on UNSQUARED distance, src/main.rs:485)
      - alignment: mean v_j for |v_j - v_i| < alignment_dist — the metric is
        in VELOCITY space (src/main.rs:497)
    Then the velocity is REPLACED (not incremented, src/main.rs:514):
        v_i = cohesion*cohesion_scale + separation*separation_scale
              + alignment*alignment_scale
        if |v_i| > max_speed: v_i = max_speed * v_i/|v_i|
        x_i += v_i * dt
    """

    dt: float = 0.04  # src/main.rs:449
    cohesion_dist_sq: float = 1000.0  # src/main.rs:450 (rule_1_distance)
    separation_dist: float = 5.0  # src/main.rs:451 (rule_2_distance)
    alignment_dist: float = 500.0  # src/main.rs:452 (rule_3_distance)
    cohesion_scale: float = 0.02  # src/main.rs:453
    separation_scale: float = 0.05  # src/main.rs:454
    alignment_scale: float = 0.5  # src/main.rs:455
    max_speed: float = 1.0  # src/main.rs:516-518
    # Fast path for the boids kernel: when every speed is <= alignment_dist/2
    # (guaranteed after any clamped step, since 2*max_speed << 500), the
    # velocity-space alignment mask is provably all-true, so rule 3 reduces
    # to the O(N) global velocity mean and the kernel skips one of its three
    # O(N^2) folds. Exactness requires the speed bound — off by
    # default to keep strict parity for arbitrary user-supplied velocities.
    global_alignment: bool = False
    # Bucket capacity for backend="cells" (physics/cells.py): exact whenever
    # it covers the densest scanned hash bucket (size with cells_stats).
    # Only read by the cell-list backend; the O(N^2) folds ignore it.
    cells_capacity: int = 64


@dataclasses.dataclass(frozen=True)
class RandomWalkConfig:
    """Random-walk controller (src/main.rs:381-402):
    v += U(-accel, accel) per axis; x += v (no dt)."""

    accel: float = 1e-4  # src/main.rs:392-393


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Per-agent 1D vision ("eye") parameters.

    The reference renders each agent's view of the scene into a Wx1 RGBA
    line through a perspective camera with a 90-degree horizontal FOV
    (src/main.rs:693-704, src/main.rs:765-771; camera math gfx.rs:358-369:
    near=1, far=10000, looking along the velocity with +z normal). Sprites
    are ~unit-radius triangles (src/main.rs:130-139) shaded by a skin
    texture darkened by a squared radial vignette (shaders/scene.frag:15-16).

    The port, like the JAX package, replaces the rasterizer with an
    analytic splat: agent j projects to a pixel interval on agent i's line;
    per pixel the nearest agent wins the depth test and is shaded with the
    same squared-radial vignette profile over the sprite footprint,
    attenuated so intensity is a monotone distance cue (observational
    equivalence per SURVEY.md §7).
    """

    width: int = 1024  # src/main.rs:694
    hfov_deg: float = 90.0  # src/main.rs:769
    near: float = 1.0  # gfx.rs:365
    far: float = 10000.0  # gfx.rs:365
    sprite_radius: float = 1.0  # triangle verts at +-1, src/main.rs:131-135
    background: float = 0.2  # clear color (0.1,0.2,0.3) luminance, main.rs:543
    sprite_albedo: float = 1.0
    # Analytic antialiasing — the counterpart of the reference's 8x MSAA
    # (src/main.rs:652, RenderTarget sample_count): sprite edges blend with
    # the background by exact box-filter pixel coverage instead of a binary
    # test. Besides matching the rasterizer's soft edges, it makes the
    # observation piecewise-LINEAR in agent positions (binary coverage is
    # piecewise constant), which gives vision meaningful gradients.
    # Blending approximates the occluder behind an edge as background.
    antialias: bool = False
    # Sprite model for the eye lines:
    #   "disc"      (default) rotation-invariant splat of radius
    #               sprite_radius with the radial vignette — the fast model.
    #   "wireframe" the reference's exact sprite: the LineStrip triangle
    #               (verts/uvs src/main.rs:130-139, topology main.rs:249)
    #               oriented to each TARGET's heading, scanline-intersected
    #               per edge with per-fragment uv-interpolated vignette
    #               (shaders/scene.frag:15-16). A 2D polygon viewed edge-on
    #               has identical silhouette coverage and nearest-depth for
    #               boundary vs interior, so this equals rasterizing the
    #               FILLED sprite too. Orientation-dependent: the projected
    #               extent varies with the target's heading (nose radius 1,
    #               rear corners sqrt(2)), which the disc approximates at
    #               constant radius (ops/wireframe.py, the
    #               wireframe_eye kernel).
    #               antialias composes: the in-plane camera projects every
    #               edge onto the row center, so coverage is the box filter
    #               of the sprite's clipped u-interval against the pixel
    #               footprint (nenbody_tpu/vision/render.py).
    sprite_mode: str = "disc"

    def __post_init__(self):
        if self.sprite_mode not in ("disc", "wireframe"):
            raise ValueError(
                f"sprite_mode must be 'disc' or 'wireframe', got "
                f"{self.sprite_mode!r}"
            )
        if self.width < 1:
            raise ValueError(f"vision width must be positive, got {self.width}")
        if not 0.0 < self.hfov_deg < 180.0:
            raise ValueError(
                f"hfov_deg must be in (0, 180) for a pinhole camera, got "
                f"{self.hfov_deg}"
            )
        if not 0.0 < self.near < self.far:
            raise ValueError(
                f"need 0 < near < far, got near={self.near} far={self.far}"
            )
        if self.sprite_radius <= 0:
            raise ValueError(
                f"sprite_radius must be positive, got {self.sprite_radius}"
            )


_CONTROLLERS = ("gravity", "boids", "random")
_BACKENDS = ("auto", "dense", "pallas", "ring", "gspmd", "cells")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Top-level scene configuration.

    n:          number of agents (reference ships n=100, src/main.rs:654)
    controller: which physics update runs each step (the reference picks by
                code edit at src/main.rs:925; boids is the active one)
    backend:    force/vision compute path — "dense" (plain PyTorch O(N^2),
                the oracle), "pallas" (the hand-written CUDA kernels on CUDA
                tensors), "ring" and "gspmd" (the mesh backends,
                parallel/), "cells" (the cell list, physics/cells.py), or
                "auto" (= "pallas" in the port).
    """

    n: int = 100
    controller: str = "boids"
    backend: str = "auto"
    gravity: GravityConfig = field(default_factory=GravityConfig)
    boids: BoidsConfig = field(default_factory=BoidsConfig)
    random_walk: RandomWalkConfig = field(default_factory=RandomWalkConfig)
    vision: Optional[VisionConfig] = None
    # Spawn distributions, reference src/main.rs:736-747.
    spawn_pos_range: Tuple[float, float] = (-100.0, 100.0)
    spawn_vel_range: Tuple[float, float] = (0.0, 0.1)

    def __post_init__(self):
        if self.controller not in _CONTROLLERS:
            raise ValueError(
                f"controller must be one of {_CONTROLLERS}, got {self.controller!r}"
            )
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"backend must be one of {_BACKENDS}, got {self.backend!r}"
            )
        if self.n <= 0:
            raise ValueError(f"n must be positive, got {self.n}")


# ---------------------------------------------------------------------------
# Presets — the five configs enumerated in BASELINE.json.
# ---------------------------------------------------------------------------

def preset_gravity_256() -> SimConfig:
    """Config 1: N=256 gravity-only, no vision (CPU-runnable oracle)."""
    return SimConfig(n=256, controller="gravity", backend="dense")


def preset_gravity_vision_1024() -> SimConfig:
    """Config 2: N=1,024 gravity + 64-pixel 1D vision lines."""
    return SimConfig(
        n=1024,
        controller="gravity",
        vision=VisionConfig(width=64),
    )


def preset_boids_4096() -> SimConfig:
    """Config 3: N=4,096 flocking with neighbor-visibility observations."""
    return SimConfig(
        n=4096,
        controller="boids",
        vision=VisionConfig(width=256),
    )


def preset_gravity_65536() -> SimConfig:
    """Config 4: N=65,536 all-pairs gravity via the tiled gravity kernel."""
    return SimConfig(n=65536, controller="gravity", backend="pallas")


def preset_envs_4096x256() -> SimConfig:
    """Config 5 (per-env config): 4,096 envs x 256 agents batched rollouts.

    Batch by `vmap`/sharding over spawned states; this is the per-env shape.
    """
    return SimConfig(
        n=256,
        controller="gravity",
        vision=VisionConfig(width=64),
    )


def preset_reference_100() -> SimConfig:
    """The reference's shipping configuration: N=100 boids with 1024-px
    eyes (src/main.rs:654, 694; boids active at src/main.rs:925)."""
    return SimConfig(n=100, controller="boids", vision=VisionConfig(width=1024))


PRESETS = {
    "reference-100": preset_reference_100,
    "gravity-256": preset_gravity_256,
    "gravity-vision-1024": preset_gravity_vision_1024,
    "boids-4096": preset_boids_4096,
    "gravity-65536": preset_gravity_65536,
    "envs-4096x256": preset_envs_4096x256,
}
