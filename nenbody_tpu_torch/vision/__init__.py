"""Per-agent 1D vision: camera math and the dense renderer, disc and exact
wireframe sprites (counterpart of nenbody_tpu/vision)."""

from . import camera, render

__all__ = ["camera", "render"]
