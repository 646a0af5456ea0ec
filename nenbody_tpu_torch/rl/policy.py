"""Gaussian MLP policy over per-agent 1D vision observations (counterpart of
nenbody_tpu/rl/policy.py: MLPPolicy, sample_action, gaussian_log_prob; the
other policy families wait, ROADMAP queue 1 item 13).

One weight set is shared by all agents: the per-agent forward is a batched
matmul over the agent axis. Actions are 2D control accelerations with a
learned state-independent log-std.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


def _lecun_normal_(weight: torch.Tensor) -> None:
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    fan_in = weight.shape[1]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # truncation correction
    nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


class MLPPolicy(nn.Module):
    """obs [..., obs_dim] -> (mean [..., act_dim], log_std [act_dim]).

    Hidden layers of 128 and 128 units with tanh, computed in bf16 when
    `use_bf16` (weights kept in fp32, cast per call, like flax's
    Dense(dtype=bf16)) and in fp32 otherwise; the head is always fp32.
    """

    def __init__(
        self,
        obs_dim: int,
        hidden: Sequence[int] = (128, 128),
        act_dim: int = 2,
        use_bf16: bool = True,
    ):
        super().__init__()
        self.use_bf16 = use_bf16
        dims = [obs_dim, *hidden]
        self.hidden = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.head = nn.Linear(dims[-1], act_dim)
        self.log_std = nn.Parameter(torch.full((act_dim,), -1.0))
        for layer in [*self.hidden, self.head]:
            _lecun_normal_(layer.weight)
            nn.init.zeros_(layer.bias)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = torch.bfloat16 if self.use_bf16 else torch.float32
        x = obs.to(dtype)
        for layer in self.hidden:
            x = torch.tanh(F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype)))
        mean = self.head(x.float())
        return mean, self.log_std


def init_mlp_policy(obs_dim: int, seed: int, use_bf16: bool = True) -> MLPPolicy:
    """An MLPPolicy whose weights come from `seed`, leaving the global
    torch random state as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return MLPPolicy(obs_dim, use_bf16=use_bf16)


def mlp_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """Map flax MLPPolicy params to MLPPolicy's state_dict — the weight
    crossing between the packages.

    params: {'params': {'Dense_0': {'kernel' [in, out], 'bias' [out]}, ...,
    'Dense_k' (the head), 'log_std' [act_dim]}} of numpy (or array-like)
    leaves. Kernels are transposed to nn.Linear's [out, in].
    """
    p = params["params"] if "params" in params else params
    dense = sorted((k for k in p if k.startswith("Dense_")), key=lambda k: int(k[6:]))
    out = {}
    for i, name in enumerate(dense):
        prefix = "head" if i == len(dense) - 1 else f"hidden.{i}"
        kernel = np.asarray(p[name]["kernel"], dtype=np.float32)
        out[f"{prefix}.weight"] = torch.tensor(kernel.T)
        out[f"{prefix}.bias"] = torch.tensor(np.asarray(p[name]["bias"], dtype=np.float32))
    out["log_std"] = torch.tensor(np.asarray(p["log_std"], dtype=np.float32))
    return out


def sample_action(
    policy: nn.Module, obs: torch.Tensor, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample a[..., 2] ~ N(mean, exp(log_std)) with noise from `generator`
    (on obs's device); returns (action, log_prob [...])."""
    mean, log_std = policy(obs)
    eps = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    action = mean + torch.exp(log_std) * eps
    return action, gaussian_log_prob(action, mean, log_std)


def gaussian_log_prob(
    action: torch.Tensor, mean: torch.Tensor, log_std: torch.Tensor
) -> torch.Tensor:
    """Sum over the action dim: [..., act_dim] -> [...]."""
    z = (action - mean) / torch.exp(log_std)
    return (-0.5 * z * z - log_std - 0.5 * math.log(2 * math.pi)).sum(dim=-1)
