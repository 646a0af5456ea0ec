"""Checkpoint and resume (counterpart of nenbody_tpu/utils/checkpoint.py).

Everything is a flat npz file of named arrays, so files cross between the
two packages:

- Scene checkpoints (`save_state`/`load_state`) hold `pos`, `vel` and `t`,
  and the scene's random stream as `generator` (torch.Generator.get_state(),
  uint8) when one is given. `load_state` also reads a JAX `save_state`
  file; its `key` has no torch counterpart and is ignored.
- Parameter and train-state files (`save_pytree`, `load_pytree`,
  `load_pytree_matching`) store nested mappings of tensors under the names
  jax.tree_util.keystr gives a nested dict (`['params']['Dense_0']['kernel']`).
  A policy saved as its flax tree (rl.policy.flax_from_state_dict) is
  therefore the JAX `save_pytree(params)` file. A train state
  (`train_state_tree`) is its modules' state_dict keys, its optimizer's
  state flattened, its env states, its generator state and its iteration.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..state import SceneState


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' when missing; normalize so the returned path
    is the file that actually exists."""
    return path if path.endswith(".npz") else path + ".npz"


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_state(path: str, state: SceneState,
               generator: Optional[torch.Generator] = None) -> str:
    """Write a SceneState (batched or not), and the random stream of
    `generator` when given, to an npz file."""
    path = _npz_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = dict(pos=_numpy(state.pos), vel=_numpy(state.vel), t=_numpy(state.t))
    if generator is not None:
        arrays["generator"] = _numpy(generator.get_state())
    np.savez(path, **arrays)
    return path


def load_state(path: str, device: str | torch.device = "cuda"
               ) -> Tuple[SceneState, Optional[torch.Tensor]]:
    """(the state on `device`, the saved generator state or None). Reads the
    port's files and the JAX package's (whose PRNG key is ignored)."""
    with np.load(path) as z:
        state = SceneState(
            pos=torch.as_tensor(z["pos"], device=device),
            vel=torch.as_tensor(z["vel"], device=device),
            t=torch.as_tensor(z["t"].astype(np.int32), device=device),
        )
        gen = torch.as_tensor(z["generator"]) if "generator" in z else None
    return state, gen


def _keystr(key) -> str:
    return f"[{key!r}]"


def _flatten(tree, prefix: str = ""):
    """(name, leaf) pairs of a nested mapping/sequence, named as
    jax.tree_util.keystr names a nested dict."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, prefix + _keystr(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + _keystr(i))
    else:
        yield prefix, tree


def _map_leaves(tree, fn, prefix: str = ""):
    """`tree` with each leaf replaced by fn(name, leaf)."""
    if isinstance(tree, Mapping):
        return {k: _map_leaves(v, fn, prefix + _keystr(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, prefix + _keystr(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def save_pytree(path: str, tree) -> str:
    """Flat npz save of a nested mapping of tensors (policy params as a flax
    tree, or a whole train state, `train_state_tree`)."""
    path = _npz_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{name: _numpy(leaf) for name, leaf in _flatten(tree)})
    return path


def load_pytree(path: str, like):
    """Restore a tree saved by save_pytree into the structure of `like`;
    the leaves come back as numpy arrays."""
    with np.load(_npz_path(path)) as z:
        return _map_leaves(like, lambda name, _: z[name])


def load_pytree_matching(path: str, like, what: str = "params"):
    """load_pytree that turns the two silent-mismatch failure modes into
    readable ValueErrors: a missing leaf (saved from a different tree, e.g.
    a GRU npz loaded into an MLP template, or a JAX train state) and a
    present but differently shaped leaf (same net, another vision width or
    batch)."""
    with np.load(_npz_path(path)) as z:
        def leaf(name, ref):
            if name not in z:
                raise ValueError(
                    f"{what} at {path} do not contain leaf {name} — saved "
                    f"from a different net family or trainer?"
                )
            arr = z[name]
            ref_shape = tuple(np.shape(_numpy(ref)))
            if tuple(arr.shape) != ref_shape:
                raise ValueError(
                    f"{what} leaf {name} at {path} has shape "
                    f"{tuple(arr.shape)}, expected {ref_shape} — saved from "
                    f"a different net family, width, or batch size?"
                )
            return arr

        return _map_leaves(like, leaf)


def _fresh_state(optimizer: torch.optim.Optimizer, p: torch.Tensor) -> dict:
    """The state Adam creates for `p` at its first step (so a checkpoint of
    an optimizer that has not stepped holds every leaf); {} for others."""
    if not isinstance(optimizer, torch.optim.Adam):
        return {}
    state = {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
             "exp_avg_sq": torch.zeros_like(p)}
    if optimizer.defaults.get("amsgrad"):
        state["max_exp_avg_sq"] = torch.zeros_like(p)
    return state


def _optimizer_tree(optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's per-parameter state, keyed as its state_dict keys
    them (the parameter's index over the param groups); the hyperparameters
    come from the flags, not the file."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    return {"state": {str(i): dict(optimizer.state.get(p) or _fresh_state(optimizer, p))
                      for i, p in enumerate(params)}}


def train_state_tree(ts) -> dict:
    """A trainer's state (rl.train.TrainState, apg.APGState, ppo.PPOState,
    ac.ACState, es.ESState) as a nested mapping of tensors: each module's
    state_dict, the optimizer's state, the env states (pos, vel, t), the
    generator state and the iteration count, under the field names."""
    tree = {}
    for f in dataclasses.fields(ts):
        v = getattr(ts, f.name)
        if v is None:
            continue
        if isinstance(v, nn.Module):
            tree[f.name] = dict(v.state_dict())
        elif isinstance(v, torch.optim.Optimizer):
            tree[f.name] = _optimizer_tree(v)
        elif isinstance(v, SceneState):
            tree[f.name] = {"pos": v.pos, "vel": v.vel, "t": v.t}
        elif isinstance(v, torch.Generator):
            tree[f.name] = v.get_state()
        elif isinstance(v, int):
            tree[f.name] = np.asarray(v, np.int64)
        else:
            raise TypeError(f"cannot checkpoint {type(ts).__name__}.{f.name}: {type(v)}")
    return tree


def restore_train_state(ts, tree):
    """`ts` with every leaf of `tree` (train_state_tree's structure, numpy
    leaves) put back: modules and the optimizer in place, the rest
    replaced."""
    changes = {}
    for f in dataclasses.fields(ts):
        v = getattr(ts, f.name)
        if v is None:
            continue
        x = tree[f.name]
        if isinstance(v, nn.Module):
            v.load_state_dict({k: torch.as_tensor(a) for k, a in x.items()})
        elif isinstance(v, torch.optim.Optimizer):
            sd = v.state_dict()
            sd["state"] = {int(i): {k: torch.as_tensor(a) for k, a in st.items()}
                           for i, st in x["state"].items()}
            v.load_state_dict(sd)
        elif isinstance(v, SceneState):
            dev = v.pos.device
            changes[f.name] = SceneState(**{k: torch.as_tensor(x[k], device=dev)
                                            for k in ("pos", "vel", "t")})
        elif isinstance(v, torch.Generator):
            v.set_state(torch.as_tensor(x, dtype=torch.uint8))
        else:
            changes[f.name] = int(x)
    return dataclasses.replace(ts, **changes)


def save_train_state(path: str, ts) -> str:
    return save_pytree(path, train_state_tree(ts))


def load_train_state(path: str, ts, what: str = "train state"):
    """`ts` (a freshly initialized state: the structure template) with the
    checkpoint at `path` restored, strictly matched (load_pytree_matching)."""
    return restore_train_state(ts, load_pytree_matching(path, train_state_tree(ts), what=what))


class PeriodicCheckpointer:
    """Save every `every` steps during a host-driven loop; keeps the last
    `keep` files, named state_{step:09d}.npz."""

    def __init__(self, directory: str, every: int = 1000, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        self._saved: list[str] = []
        self._last_saved_step: Optional[int] = None
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, state: SceneState,
                   generator: Optional[torch.Generator] = None) -> Optional[str]:
        """Save (with `generator`'s stream when given) when at least `every`
        steps have elapsed since the last save: callers may only check at
        chunk boundaries, so an exact `t % every == 0` test would skip
        checkpoints whenever the strides don't divide."""
        step = int(state.t.reshape(-1)[0])
        last = self._last_saved_step if self._last_saved_step is not None else 0
        if step - last < self.every:
            return None
        self._last_saved_step = step
        path = os.path.join(self.directory, f"state_{step:09d}.npz")
        save_state(path, state, generator)
        self._saved.append(path)
        while len(self._saved) > self.keep:
            old = self._saved.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass
        return path

    def latest(self) -> Optional[str]:
        if self._saved:
            return self._saved[-1]
        files = sorted(
            f for f in os.listdir(self.directory)
            if f.startswith("state_") and f.endswith(".npz")
        )
        return os.path.join(self.directory, files[-1]) if files else None
