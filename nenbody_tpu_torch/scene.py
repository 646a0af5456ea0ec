"""Scene: the public spawn/step/observe/rollout API of the PyTorch port
(counterpart of nenbody_tpu/scene.py).

Typical use:

    from nenbody_tpu_torch import Scene, PRESETS
    scene = Scene(PRESETS["gravity-vision-1024"](), device="cuda")
    state = scene.spawn(seed=0)
    state = scene.step(state)              # one physics step
    obs = scene.observe(state)             # [N, W] vision lines
    state, traj = scene.rollout(state, 100, record=("obs",))

Routing: backend="dense" always runs the plain PyTorch functions;
"auto" and "pallas" run the hand-written CUDA kernels on CUDA tensors (and
their plain versions on CPU tensors), the disc eye or the exact wireframe
eye by `cfg.vision.sprite_mode`. Batched states ([B, N, 2] leaves from
`spawn_envs`) go to the kernels whole, with the env axis as a grid
dimension. Rollouts are a Python loop; PyTorch runs eagerly, so there is no
compiled scan to cache.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from .config import SimConfig
from .physics import dense
from .state import SceneState, spawn, spawn_batch

_UNPORTED_BACKENDS = {
    "ring": "ROADMAP queue 1 item 17 (the multi-device agent-axis ring)",
    "gspmd": "ROADMAP queue 1 item 17 (the compiler-partitioned backend)",
    "cells": "ROADMAP queue 1 item 16 (the cell-list boids backend)",
}


def _resolve_backend(cfg: SimConfig) -> str:
    """'dense' (plain torch) or 'pallas' (the kernels); raise for the
    backends the port does not have yet."""
    if cfg.backend in _UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"backend={cfg.backend!r} is not ported yet: "
            f"{_UNPORTED_BACKENDS[cfg.backend]}"
        )
    return "dense" if cfg.backend == "dense" else "pallas"


def make_step_fn(cfg: SimConfig) -> Callable[..., SceneState]:
    """Build the `(state, generator=None) -> state` physics step for this
    config; it takes unbatched and batched states alike."""
    if _resolve_backend(cfg) == "dense":
        stepper = dense.STEPPERS[cfg.controller]
    else:
        from .ops import tiled

        stepper = tiled.STEPPERS[cfg.controller]
    return functools.partial(stepper, cfg=cfg)


def _render_fn(cfg: SimConfig) -> Callable:
    """`(pos, vel) -> (shade, depth)` on the route the backend and the
    sprite mode pick (the JAX `_vision_route`/`_vision_render_core`). The
    dense route is plain autograd through vision.render, either sprite. The
    kernel route is the disc eye (raycast.render_rows_tiled) or the exact
    wireframe eye (wireframe.render_rows_wireframe_tiled), at any width;
    each goes through its autograd Function when grad is enabled and an
    input requires grad, and through the forward-only launch otherwise."""
    vcfg = cfg.vision
    if _resolve_backend(cfg) == "dense":
        from .vision import render

        return lambda pos, vel: render.render_rows(pos, vel, vcfg)
    if vcfg.sprite_mode == "wireframe":
        from .ops import wireframe

        return lambda pos, vel: wireframe.render_rows_wireframe_tiled(pos, vel, vcfg)
    from .ops import raycast

    return lambda pos, vel: raycast.render_rows_tiled(pos, vel, vcfg)


def make_observe_fn(cfg: SimConfig) -> Optional[Callable[[SceneState], torch.Tensor]]:
    """Build the `state -> obs[..., N, W]` vision function, or None if
    vision is disabled."""
    if cfg.vision is None:
        return None
    core = _render_fn(cfg)
    return lambda s: core(s.pos, s.vel)[0]


class Scene:
    """Owns a config, a device and the random stream, and exposes
    spawn/step/observe/rollout for unbatched ([N, 2] leaves) and batched
    ([B, N, 2] leaves) states. The device is the card unless the caller
    asks for another (`device="cpu"`); without a GPU the default raises."""

    def __init__(self, cfg: SimConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self._step = make_step_fn(cfg)
        self._render = _render_fn(cfg) if cfg.vision is not None else None
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
        as in the JAX package). Empty tuple records nothing.
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
        return state, {k: torch.stack(v) for k, v in out.items() if v}
