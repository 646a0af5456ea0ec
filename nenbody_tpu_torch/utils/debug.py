"""Debug aids (counterpart of nenbody_tpu/utils/debug.py): numeric
tripwires on every op, and a host-side finiteness check of a state."""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ops whose outputs are uninitialized memory, filled afterwards (the
# kernels' wrappers allocate with torch.empty and launch into it)
_UNINITIALIZED = ("empty", "new_empty", "empty_like", "empty_strided", "new_empty_strided")


class _FiniteMode(TorchDispatchMode):
    """Raises FloatingPointError at the first ATen op whose floating output
    holds a NaN (with nans) or an Inf (with infs)."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALIZED:
            return out
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if not isinstance(t, torch.Tensor) or not t.is_floating_point() or t.is_meta:
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"Inf in the output of {func}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = False, interpret: bool = False):
    """Context: trip on NaNs/Infs produced by any ATen op (the counterpart
    of jax_debug_nans/jax_debug_infs). A hand-written kernel writes into a
    tensor outside ATen, so its NaNs trip at the next op that reads them.
    Every op synchronizes the card: a debugging aid, not a fast path.

    interpret=True has no counterpart: a CUDA kernel has no interpreter
    (compute-sanitizer is the tool); the plain versions run on CPU tensors.

    Example:
        with debug_mode(nans=True):
            state = scene.step(state)   # raises at the op producing a NaN
    """
    if interpret:
        raise ValueError(
            "interpret=True has no counterpart in the port: a CUDA kernel has no "
            "interpreter (use compute-sanitizer, or CPU tensors for the plain versions)"
        )
    with _FiniteMode(nans, infs):
        yield


def assert_state_finite(state) -> None:
    """Host-side check that a SceneState holds only finite values; raises
    with the offending leaf name."""
    for name in ("pos", "vel"):
        arr = getattr(state, name)
        finite = torch.isfinite(arr)
        if not bool(finite.all()):
            bad = int((~finite).sum())
            raise FloatingPointError(
                f"SceneState.{name} has {bad} non-finite values at t="
                f"{int(state.t.reshape(-1)[0])}"
            )
