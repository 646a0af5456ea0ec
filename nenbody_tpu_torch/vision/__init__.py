"""Per-agent 1D vision: camera math and the dense disc renderer
(counterpart of nenbody_tpu/vision)."""

from . import camera, render

__all__ = ["camera", "render"]
