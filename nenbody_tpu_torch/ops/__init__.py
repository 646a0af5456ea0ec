"""Hand-written CUDA kernels for Hopper: all-pairs gravity, fused boids, the
disc eye and the exact wireframe eye (counterparts of nenbody_tpu/ops). Each module holds its
kernel's wrapper and plain PyTorch version; CPU tensors run the plain
version, CUDA tensors the kernel, built from nenbody_tpu_torch/csrc at first
use (ops.common).
"""

from . import boids, common, pairwise, raycast, tiled, wireframe

__all__ = ["boids", "common", "pairwise", "raycast", "tiled", "wireframe"]
