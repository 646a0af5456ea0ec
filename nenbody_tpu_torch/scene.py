"""Scene: the public spawn/step/observe/rollout API of the PyTorch port
(counterpart of nenbody_tpu/scene.py).

Typical use:

    from nenbody_tpu_torch import Scene, PRESETS
    from nenbody_tpu_torch.vision import render
    scene = Scene(PRESETS["gravity-vision-1024"](), device="cuda")
    state = scene.spawn(seed=0)
    state = scene.step(state)              # one physics step
    obs = scene.observe(state)             # [N, W] vision lines
    obs = scene.observe_textured(state, render.checker_texture(32, 4))  # a skin
    rgb = scene.observe_rgb(state, render.default_agent_colors(1024, "cuda"))
    state, traj = scene.rollout(state, 100, record=("obs",))

Routing: backend="dense" always runs the plain PyTorch functions;
"pallas" runs the hand-written CUDA kernels on CUDA tensors (and their plain
versions on CPU tensors), the disc eye or the exact wireframe eye by
`cfg.vision.sprite_mode`; "cells" steps boids on the cell list
(physics/cells.py, plain PyTorch) and renders on the kernel route; "ring"
runs the agent-axis ring over a device mesh (parallel/ring.py: physics and
both eyes, on the same kernels), "gspmd" its
dense cross-check (parallel/auto.py; its eye renders dense, as in the JAX
package). "auto" is the ring when more than one CUDA device is visible, else
"pallas". The ring and gspmd take the `mesh` given to Scene, else
parallel.mesh.default_mesh() (every visible CUDA device), for states of
plain tensors, and refuse a mesh across processes for them
(parallel.mesh.local_mesh). A state of GlobalTensors
(parallel.mesh.global_state: each process's block) runs on its own mesh,
which may span processes, as the JAX Scene runs global arrays: step,
observe and rollout, forward only; the gspmd eye then renders each
process's rows against the all-gathered agents. Batched states
([B, N, 2] leaves from `spawn_envs`) go to the kernels and the ring whole,
the env axis a grid dimension. Rollouts are a Python loop; PyTorch runs
eagerly, so there is no compiled scan to cache.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from .config import SimConfig
from .physics import dense
from .state import SceneState, spawn, spawn_batch


def _resolve_backend(cfg: SimConfig) -> str:
    """'dense' (plain torch), 'pallas' (the kernels), 'cells', 'ring' or
    'gspmd'."""
    if cfg.backend == "auto":
        # with several cards, shard the agent axis over the ring (the JAX
        # package does so with several TPU chips)
        return "ring" if torch.cuda.is_available() and torch.cuda.device_count() > 1 else "pallas"
    return cfg.backend


def make_step_fn(cfg: SimConfig, mesh=None) -> Callable[..., SceneState]:
    """Build the `(state, generator=None) -> state` physics step for this
    config; it takes unbatched and batched states alike. `mesh` serves the
    ring and gspmd backends (default: parallel.mesh.default_mesh())."""
    backend = _resolve_backend(cfg)
    if backend == "dense":
        return functools.partial(dense.STEPPERS[cfg.controller], cfg=cfg)
    if backend == "pallas":
        from .ops import tiled

        return functools.partial(tiled.STEPPERS[cfg.controller], cfg=cfg)
    if backend == "cells":
        from .physics import cells

        if cfg.controller not in cells.STEPPERS:
            raise ValueError(
                f"backend='cells' is the radius-limited (boids) fast path; "
                f"controller {cfg.controller!r} is all-pairs — use dense/"
                f"pallas/ring"
            )
        return functools.partial(cells.STEPPERS[cfg.controller], cfg=cfg)
    if backend == "ring":
        from .parallel import ring as steppers
    else:
        from .parallel import auto as steppers
    return functools.partial(steppers.STEPPERS[cfg.controller], cfg=cfg, mesh=mesh)


def _render_fn(cfg: SimConfig, mesh=None) -> Callable:
    """`(pos, vel, texture=None) -> (shade, depth)` on the route the backend
    and the sprite mode pick (the JAX `_vision_route`/`_vision_render_core`),
    the texture [Ht, Wt] sampled at each winner's uv when given. The
    dense and gspmd routes are plain autograd through vision.render, either
    sprite. The kernel route is the disc eye (raycast.render_rows_tiled) or
    the exact wireframe eye (wireframe.render_rows_wireframe_tiled), at any
    width; each goes through its autograd Function when grad is enabled and
    an input requires grad, and through the forward-only launch otherwise.
    The ring route is parallel.ring.ring_render_rows over `mesh`, either
    sprite, on the same kernels. The cells backend has no vision analog
    (the eye reaches cfg.far, not a small radius), so it renders on the
    kernel route, as the JAX package borrows its pallas route."""
    vcfg = cfg.vision
    backend = _resolve_backend(cfg)
    if backend == "dense":
        from .vision import render

        return lambda pos, vel, texture=None: render.render_rows(pos, vel, vcfg, texture=texture)
    if backend == "gspmd":
        from .parallel import auto, ring
        from .parallel.mesh import GlobalTensor
        from .vision import render

        def gspmd_rows(pos, vel, texture=None):
            if not isinstance(pos, GlobalTensor):
                return render.render_rows(pos, vel, vcfg, texture=texture)
            m, data_axis = ring.mesh_of(pos, mesh, "Scene's gspmd backend")
            return auto.auto_render_rows(pos, vel, vcfg, mesh=m, data_axis=data_axis,
                                         texture=texture)

        return gspmd_rows
    if backend == "ring":
        from .parallel import ring

        def ring_rows(pos, vel, texture=None):
            m, data_axis = ring.mesh_of(pos, mesh, "Scene's ring backend")
            return ring.ring_render_rows(pos, vel, vcfg, mesh=m, data_axis=data_axis,
                                         texture=texture)

        return ring_rows
    if vcfg.sprite_mode == "wireframe":
        from .ops import wireframe

        return lambda pos, vel, texture=None: wireframe.render_rows_wireframe_tiled(
            pos, vel, vcfg, texture=texture)
    from .ops import raycast

    return lambda pos, vel, texture=None: raycast.render_rows_tiled(pos, vel, vcfg,
                                                                     texture=texture)


def make_observe_fn(cfg: SimConfig, mesh=None) -> Optional[Callable[[SceneState], torch.Tensor]]:
    """Build the `state -> obs[..., N, W]` vision function, or None if
    vision is disabled."""
    if cfg.vision is None:
        return None
    core = _render_fn(cfg, mesh)
    return lambda s: core(s.pos, s.vel)[0]


class Scene:
    """Owns a config, a device and the random stream, and exposes
    spawn/step/observe/rollout for unbatched ([N, 2] leaves) and batched
    ([B, N, 2] leaves) states. The device is the card unless the caller
    asks for another (`device="cpu"`); without a GPU the default raises.
    `mesh` (a parallel.mesh.Mesh) serves the ring and gspmd backends; the
    state stays on `device` and the backends move its blocks to the mesh's
    devices and back."""

    def __init__(self, cfg: SimConfig, device: str | torch.device = "cuda", mesh=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self._step = make_step_fn(cfg, mesh)
        self._render = _render_fn(cfg, mesh) if cfg.vision is not None else None
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    # -- construction -------------------------------------------------------

    def spawn(self, seed: int = 0) -> SceneState:
        """One env; reseeds the scene's random stream with `seed`."""
        self.generator.manual_seed(seed)
        return spawn(self.cfg, self.generator, self.device)

    def spawn_envs(self, num_envs: int, seed: int = 0) -> SceneState:
        """`num_envs` envs on a leading axis; reseeds the random stream."""
        self.generator.manual_seed(seed)
        return spawn_batch(self.cfg, self.generator, num_envs, self.device)

    # -- stepping ------------------------------------------------------------

    def step(self, state: SceneState) -> SceneState:
        return self._step(state, generator=self.generator)

    def observe(self, state: SceneState) -> torch.Tensor:
        return self.observe_with_depth(state)[0]

    def observe_with_depth(self, state: SceneState) -> Tuple[torch.Tensor, torch.Tensor]:
        """(shade [..., N, W], depth [..., N, W]) — the depth buffer the
        reference's eye pipeline has but never exposes."""
        if self._render is None:
            raise ValueError("vision is disabled for this config (vision=None)")
        return self._render(state.pos, state.vel)

    def observe_textured(self, state: SceneState, texture: torch.Tensor) -> torch.Tensor:
        """[..., N, W] shade rows with the skin `texture` [Ht, Wt] (values
        in [0, 1], shared by every env; vision.render.checker_texture for a
        stand-in asset) sampled at each winner's splat or edge uv: the
        skin.png mechanism (src/main.rs:322-356, shaders/scene.frag:11-16) at
        observation level, on the route observe takes. The texture moves to
        the state's device."""
        if self._render is None:
            raise ValueError("vision is disabled for this config (vision=None)")
        tex = texture if isinstance(texture, torch.Tensor) else torch.tensor(texture)
        tex = tex.to(state.pos.device, torch.float32).contiguous()
        return self._render(state.pos, state.vel, tex)[0]

    def observe_rgb(self, state: SceneState, colors: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[..., N, W, 3] RGB observation rows: the reference's RGBA eye
        texture (alpha always 1, shaders/scene.frag:16).

        colors: optional [N, 3] per-agent colors (vision.render.
        default_agent_colors(n) for a deterministic palette), rendered one
        channel at a time by vision.render.render_rows_rgb on the eye
        kernels (backend 'pallas') or the dense renderer (every other
        backend, as in the JAX package). Unbatched states only when colors
        are given. Without colors, to_rgb of observe_with_depth."""
        from .vision import render

        if self._render is None:
            raise ValueError("vision is disabled for this config (vision=None)")
        vcfg = self.cfg.vision
        if colors is None:
            return render.to_rgb(*self.observe_with_depth(state), vcfg)
        if state.pos.dim() != 2:
            raise ValueError("per-agent colors need an unbatched state")
        colors = torch.as_tensor(colors, dtype=torch.float32, device=state.pos.device)
        backend = "pallas" if _resolve_backend(self.cfg) in ("pallas", "cells") else "dense"
        return render.render_rows_rgb(state.pos, state.vel, vcfg, colors, backend=backend)

    # -- visualization --------------------------------------------------------

    def render_frame(
        self,
        state: SceneState,
        selected_eye: int = 0,
        size=(540, 960),
        half_extent: float = 120.0,
        with_obs: bool = True,
    ):
        """Host-side RGB uint8 frame: top-down view following agent 0 plus
        the selected agent's eye strip (the reference's screen contents,
        src/main.rs:940-998). Copies a snapshot off the device; unbatched
        states only."""
        from .viz import frame as frame_lib
        from .viz.viewer import host

        if state.batch_shape:
            raise ValueError("render_frame takes an unbatched state")
        scene_img = frame_lib.render_topdown(
            host(state.pos),
            host(state.vel),
            size=size,
            half_extent=half_extent,
            selected=selected_eye,
        )
        strip = None
        if with_obs and self._render is not None:
            with torch.no_grad():
                row = host(self.observe(state)[selected_eye])
            strip = frame_lib.eye_strip(row, width=size[1])
        return frame_lib.to_uint8(frame_lib.compose(scene_img, strip))

    def render_eye_row(
        self,
        state: SceneState,
        eye: int,
        width: int,
        colors: Optional[torch.Tensor] = None,
        texture: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Agent `eye`'s eye line at `width` pixels against all N targets,
        (shade [W] (or [W, 3] with `colors` [N, 3]), depth [W]), on the
        scene's device: the first-person viewport's pixels. One eye through
        the eye kernel of the scene's sprite mode (ops.raycast.disc_eye or
        ops.wireframe.wireframe_eye, any width) on CUDA tensors, their plain
        versions (vision.render.render_single_row's rows) on CPU tensors.
        With `colors`, three channel renders, each with albedo colors[:, c]
        against the channel's clear color (render.BACKGROUND_RGB); `texture`
        [Ht, Wt] samples the skin along the row. The config is the scene's
        vision (VisionConfig() without one) at `width`. Unbatched states
        only."""
        from .config import VisionConfig
        from .ops import raycast, wireframe
        from .vision import camera, render

        if state.batch_shape:
            raise ValueError("render_eye_view/render_eye_row take an unbatched state")
        if not 0 <= eye < self.cfg.n:
            raise ValueError(f"eye {eye} out of range [0, {self.cfg.n})")
        vcfg = dataclasses.replace(self.cfg.vision or VisionConfig(), width=width)
        pos = state.pos
        dirs = camera.unit_heading(state.vel)
        as_f32 = lambda x: (None if x is None else  # noqa: E731
                            torch.as_tensor(x, dtype=torch.float32, device=pos.device).contiguous())
        colors, texture = as_f32(colors), as_f32(texture)
        one = slice(eye, eye + 1)

        def row(cfg, albedo):
            if cfg.sprite_mode == "wireframe":
                shade, depth = wireframe.wireframe_eye(pos[one], dirs[one], pos, dirs, cfg,
                                                       albedo, texture)
            else:
                shade, depth = raycast.disc_eye(pos[one], dirs[one], pos, cfg, albedo, texture)
            return shade[0], depth[0]

        with torch.no_grad():
            if colors is None:
                return row(vcfg, None)
            chans = []
            for c in range(3):
                ccfg = dataclasses.replace(vcfg, background=float(render.BACKGROUND_RGB[c]))
                shade, depth = row(ccfg, colors[:, c].contiguous())
                chans.append(shade)
            return torch.stack(chans, dim=-1), depth

    def render_eye_view(
        self,
        state: SceneState,
        eye: int = 0,
        size=(270, 480),
        thickness="perspective",
        colors: Optional[torch.Tensor] = None,
        texture: Optional[torch.Tensor] = None,
    ):
        """First-person viewport: the scene re-rendered from agent `eye`'s
        perspective camera as an RGB uint8 [H, W, 3] frame, the third
        render the reference's UI shows (selected-eye re-render into the
        imgui viewport texture, src/main.rs:979-998). Width follows the
        viewport (horizontal FOV is preserved on resize, gfx.rs:411-418);
        the planar scene draws on the horizon (viz.frame.first_person_view:
        thickness="perspective" extends each hit column by the sprite's
        apparent size at its depth, an int draws the raw thin-line look).
        The row comes from render_eye_row (the eye kernel on the card);
        `colors` [N, 3] gives per-agent appearance, `texture` samples the
        skin along the viewport row. Unbatched states only."""
        from .config import VisionConfig
        from .viz import frame as frame_lib
        from .viz.viewer import host

        h, w = size
        shade, depth = self.render_eye_row(state, eye, w, colors, texture)
        vcfg = self.cfg.vision or VisionConfig()
        img = frame_lib.first_person_view(
            host(shade), host(depth), size=size, far=vcfg.far,
            sprite_albedo=vcfg.sprite_albedo, thickness=thickness,
            sprite_radius=vcfg.sprite_radius, hfov_deg=vcfg.hfov_deg,
        )
        return frame_lib.to_uint8(img)

    # -- rollouts ------------------------------------------------------------

    def rollout(
        self,
        state: SceneState,
        num_steps: int,
        record: Tuple[str, ...] = (),
    ) -> Tuple[SceneState, Dict[str, torch.Tensor]]:
        """Advance `num_steps` steps.

        record: subset of ("pos", "vel", "obs") to stack along a leading
        time axis (the obs of each step is taken after its physics update,
        as in the JAX package). Empty tuple records nothing. With zero
        steps each recorded key is an empty stack of its shape, as the JAX
        scan of length 0 returns it.
        """
        record = tuple(record)
        unknown = set(record) - {"pos", "vel", "obs"}
        if unknown:
            raise ValueError(f"cannot record {sorted(unknown)}: pos, vel or obs")
        if "obs" in record and self._render is None:
            raise ValueError("cannot record obs: vision disabled")
        out = {k: [] for k in record}
        for _ in range(num_steps):
            state = self.step(state)
            if "pos" in record:
                out["pos"].append(state.pos)
            if "vel" in record:
                out["vel"].append(state.vel)
            if "obs" in record:
                out["obs"].append(self.observe(state))
        from .parallel.mesh import stack_global

        if num_steps > 0:
            return state, {k: stack_global(v) for k, v in out.items()}

        def empty_stack(k: str):
            """An empty stack of key k (of the state's layout where its
            leaves are GlobalTensors)."""
            if k != "obs":
                return stack_global([], getattr(state, k))
            pos, width = state.pos, self.cfg.vision.width
            local = getattr(pos, "local", pos)
            obs = local.new_empty(local.shape[:-1] + (width,))
            return stack_global([], pos.with_local(obs) if local is not pos else obs)

        return state, {k: empty_stack(k) for k in record}
