"""The inputs a run makes from its --seed: sub-seeds, the policy's weights
(made on the device in one draw), the spawns, and the seed's sample of
what is checked."""

from __future__ import annotations

import hashlib
import random

import torch

from ..reference import world


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def sampler(seed: int, tag: str) -> random.Random:
    return random.Random(sub_seed(seed, tag))


def mlp_params(obs_dim: int, hidden, act_dim: int, seed: int, device) -> dict:
    """float32 weights of an MLP (names as the port's MLPPolicy has them),
    made on `device`: one draw of the cell's weights from a fixed seed,
    each kernel normal with variance 1/fan_in cut at two deviations, each
    bias normal at 0.1 of that, the log-std -1 (the policy's initial
    value); then the run's seed permutes each hidden layer's units. Every
    seed so runs the same function, whose actions steer the agents and so
    set the eye's work, with its sums in another order."""
    dims = [obs_dim, *hidden, act_dim]
    names = [f"hidden.{i}" for i in range(len(hidden))] + ["head"]
    shapes = []
    for name, a, b in zip(names, dims[:-1], dims[1:]):
        shapes += [(f"{name}.weight", (b, a), a ** -0.5), (f"{name}.bias", (b,), 0.1 * a ** -0.5)]
    total = sum(torch.Size(s).numel() for _, s, _ in shapes)
    z = torch.randn(total, generator=generator(0, "weights", device), device=device)
    z = z.clamp(-2.0, 2.0)
    out, at = {}, 0
    for name, shape, std in shapes:
        k = torch.Size(shape).numel()
        out[name] = (z[at:at + k] * std).view(shape).contiguous()
        at += k
    gen = generator(seed, "units", device)
    prev = None  # the permutation of the previous layer's units (this layer's inputs)
    for i, name in enumerate(names):
        w, b = out[f"{name}.weight"], out[f"{name}.bias"]
        if prev is not None:
            w = w[:, prev]
        if i < len(hidden):
            perm = torch.randperm(w.shape[0], generator=gen, device=device)
            w, b = w[perm], b[perm]
            prev = perm
        out[f"{name}.weight"], out[f"{name}.bias"] = w.contiguous(), b.contiguous()
    out["log_std"] = torch.full((act_dim,), -1.0, device=device)
    return out


def load_policy(policy: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Copy `params` into the policy's parameters of the same names."""
    own = dict(policy.named_parameters())
    if set(own) != set(params):
        raise ValueError(f"policy parameters {sorted(own)} differ from {sorted(params)}")
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(params[k])
    return policy


def spawns(gen: torch.Generator, shape, cfg: dict, device):
    """(pos, vel) of the configuration's spawn ranges, drawn from `gen`."""
    return world.spawn(gen, shape, cfg["spawn_pos_range"], cfg["spawn_vel_range"], device)
