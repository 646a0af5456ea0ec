"""The numbers `correct` compares, each a gap between what the program
produced and what the plain reference gives from the same inputs.

Each is 0 for an exact match and 1 (or more) for a result that is as far
off as the quantity itself: a state left unchanged reads 1.
"""

from __future__ import annotations

import statistics

import torch

# an observation's element (a pixel of an eye line, or the velocity)
# differs where it moves by more than this
SHADE_TOL = 1e-4
# a leaf whose reference gradient norm is under this share of the median
# leaf's moves under Adam by round-off alone, and is not compared
STILL_LEAF = 1e-3


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / max(scale, 1e-30)


def step_gap(pos, vel, pos_ref, vel_ref, pos_in, vel_in) -> float:
    """How far a step's result lies from the reference's, as a share of the
    reference's own change: the larger of max |dv error| / max |dv| and
    max |dx error| / max |dx|."""
    dv = float((vel_ref - vel_in).abs().max())
    dx = float((pos_ref - pos_in).abs().max())
    return max(float((vel - vel_ref).abs().max()) / max(dv, 1e-30),
               float((pos - pos_ref).abs().max()) / max(dx, 1e-30))


def kept_leaves(grads_ref: dict) -> list:
    """The leaves whose reference gradient norm is at least STILL_LEAF of
    the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads_ref.items()}
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= STILL_LEAF * med]


def loss_gap(loss: float, loss_ref: float) -> float:
    """|loss - reference loss| / |reference loss|."""
    return abs(loss - loss_ref) / max(abs(loss_ref), 1e-30)


def sign_share(grads: dict, grads_ref: dict, keys: list) -> float:
    """The share of all elements of the leaves `keys` whose gradient has
    another sign than the reference's (a zero against a nonzero counts);
    NaN where the gradient is not finite."""
    if not all(bool(torch.isfinite(grads[k]).all()) for k in keys):
        return float("nan")
    off = sum(int((torch.sign(grads[k].float()) != torch.sign(grads_ref[k].float())).sum())
              for k in keys)
    return off / sum(grads_ref[k].numel() for k in keys)


def update_gap(params: dict, params_ref: dict, params0: dict) -> float:
    """How far the program's parameters lie from the reference's, both
    moved from `params0`: max |p - p_ref| over max |p_ref - p0|, over every
    leaf."""
    err = max(float((params[k].float() - params_ref[k].float()).abs().max()) for k in params_ref)
    moved = max(float((params_ref[k].float() - params0[k].float()).abs().max())
                for k in params_ref)
    return err / max(moved, 1e-30)


def replica_mismatch(flats: list) -> float:
    """The share of elements of the replicas' flat parameters (one tensor
    a process, rank 0's first) that differ from rank 0's, bit for bit."""
    if len(flats) < 2:
        return 0.0
    head = flats[0]
    return sum(int((f != head).sum()) for f in flats[1:]) / ((len(flats) - 1) * head.numel())
