"""nenbody_tpu_torch: the PyTorch and CUDA port of nenbody-tpu.

A second package beside the JAX one (`nenbody_tpu`, the reference it is held
against), for NVIDIA Hopper cards. It imports torch and never jax. Its
paths are the JAX package's: serving (seeded spawn -> a physics step,
all-pairs gravity or boids -> the per-agent 1D disc eye -> the shared MLP
policy, for one env or a batch of envs) and training (REINFORCE, its
recurrent form, actor-critic, PPO, ES and APG, rl.*, `python -m
nenbody_tpu_torch train`), with checkpoints, datagen, behaviour cloning and
a `torch.export` serving artifact (utils.*, rl.datagen, rl.bc, and the
commands `run`, `eval`, `datagen`, `bc`, `export`), on hand-written
CUDA kernels (nenbody_tpu_torch/csrc, built with nvcc at first use) that
replace the Pallas kernels of the JAX package, the backward kernels of
gravity and the eye included; on CPU tensors each kernel's plain PyTorch
version runs.

Module names mirror the JAX package's, so each counterpart is easy to find.
"""

from . import config as presets
from .config import (
    BoidsConfig,
    GravityConfig,
    PRESETS,
    RandomWalkConfig,
    SimConfig,
    VisionConfig,
)
from .ops import library as _library  # registers the kernels' custom ops (utils/export.py)
from .scene import Scene, make_observe_fn, make_step_fn
from .state import SceneState, heading, model_matrices, spawn, spawn_batch

__version__ = "0.1.0"

__all__ = [
    "BoidsConfig",
    "GravityConfig",
    "PRESETS",
    "RandomWalkConfig",
    "Scene",
    "SceneState",
    "SimConfig",
    "VisionConfig",
    "heading",
    "make_observe_fn",
    "make_step_fn",
    "model_matrices",
    "presets",
    "spawn",
    "spawn_batch",
]
