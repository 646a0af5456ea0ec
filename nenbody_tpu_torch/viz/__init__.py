"""Host-side visualization of the port (counterpart of nenbody_tpu/viz): the
replacement for the reference's winit/wgpu/imgui viewer (ui.rs,
src/main.rs:18-119, 649-1014).

The viewer is a host-side consumer fed by low-rate snapshots copied off the
card while the device loop runs free. `frame` is a pure NumPy compositor
(the JAX module's copy, byte for byte the same frames), `viewer` adds PNG
and GIF capture through `image` (standard library and NumPy: the card's
machine has neither Pillow nor imageio), and `live` an optional matplotlib
window.
"""

from . import frame, image, live, viewer

__all__ = ["frame", "image", "live", "viewer"]
