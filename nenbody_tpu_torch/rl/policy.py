"""Policies and value heads over per-agent 1D vision observations
(counterpart of nenbody_tpu/rl/policy.py): the Gaussian MLPPolicy, the 1D
ConvPolicy and the recurrent GRUPolicy, the per-agent ValueMLP and the
pooled CentralValueMLP, sample_action and gaussian_log_prob, and
state_dict_from_flax and its inverse flax_from_state_dict, which carry
params of every family across between the packages.

One weight set is shared by all agents: the per-agent forward is a batched
matmul over the agent axis. Actions are 2D control accelerations with a
learned state-independent log-std.

Each module is built with its input width (`obs_dim`), so its parameters
exist from the constructor on; the JAX `value_init_obs`, a zeros probe that
flax needs to create parameters, has no counterpart.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..utils import profiling


def _lecun_normal_(weight: torch.Tensor) -> None:
    """flax's default kernel init: truncated normal, variance 1/fan_in (a
    conv's fan_in counts its input channels times its kernel taps)."""
    fan_in = weight[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # truncation correction
    nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


def _flax_init_(*layers: nn.Module) -> None:
    """flax's Dense and Conv init: lecun-normal kernels, zero biases."""
    for layer in layers:
        _lecun_normal_(layer.weight)
        nn.init.zeros_(layer.bias)


def _linears(dims: Sequence[int]) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))


def _dtype(use_bf16: bool) -> torch.dtype:
    return torch.bfloat16 if use_bf16 else torch.float32


def _tanh_layer(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """tanh(layer(x)) computed in `dtype`, the fp32 weights cast per call
    (flax's Dense(dtype=...))."""
    return torch.tanh(F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype)))


def _tanh_layers(x: torch.Tensor, layers: nn.ModuleList, dtype: torch.dtype) -> torch.Tensor:
    for layer in layers:
        x = _tanh_layer(x, layer, dtype)
    return x


def _log_std(act_dim: int) -> nn.Parameter:
    return nn.Parameter(torch.full((act_dim,), -1.0))


class MLPPolicy(nn.Module):
    """obs [..., obs_dim] -> (mean [..., act_dim], log_std [act_dim]).

    Hidden layers of 128 and 128 units with tanh, computed in bf16 when
    `use_bf16` (weights kept in fp32, cast per call, like flax's
    Dense(dtype=bf16)) and in fp32 otherwise; the head is always fp32. The
    forward is the span `policy.forward` (utils/profiling.py).
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
        self.hidden = _linears(dims)
        self.head = nn.Linear(dims[-1], act_dim)
        self.log_std = _log_std(act_dim)
        _flax_init_(*self.hidden, self.head)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with profiling.span("policy.forward"):
            dtype = _dtype(self.use_bf16)
            x = _tanh_layers(obs.to(dtype), self.hidden, dtype)
            return self.head(x.float()), self.log_std


class ValueMLP(nn.Module):
    """Per-agent state-value head: obs [..., obs_dim] -> V [...]; hidden
    layers as MLPPolicy's, the head fp32."""

    def __init__(self, obs_dim: int, hidden: Sequence[int] = (128, 128), use_bf16: bool = True):
        super().__init__()
        self.use_bf16 = use_bf16
        dims = [obs_dim, *hidden]
        self.hidden = _linears(dims)
        self.head = nn.Linear(dims[-1], 1)
        _flax_init_(*self.hidden, self.head)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        dtype = _dtype(self.use_bf16)
        x = _tanh_layers(obs.to(dtype), self.hidden, dtype)
        return self.head(x.float())[..., 0]


class CentralValueMLP(nn.Module):
    """Centralized critic V(s) over all agents' observations (the MAPPO
    baseline for shared rewards): a per-agent embedding, a mean over the
    agent axis (permutation-invariant, any N), then the value head; the
    value broadcasts back over the agents. obs [..., N, obs_dim] -> V
    [..., N], one value for every agent of an env. Inputs keep the agent
    axis (PPO's central_critic keeps it through minibatching). Where the
    agents are split across processes, `agent_mean(x, dim)` (keepdim) is
    the mean over the global agent axis (rl/spmd.py)."""

    def __init__(self, obs_dim: int, embed: Sequence[int] = (128,),
                 head: Sequence[int] = (128,), use_bf16: bool = True):
        super().__init__()
        self.use_bf16 = use_bf16
        dims, pooled = [obs_dim, *embed], [embed[-1], *head]
        self.embed = _linears(dims)
        self.hidden = _linears(pooled)
        self.head = nn.Linear(pooled[-1], 1)
        _flax_init_(*self.embed, *self.hidden, self.head)

    def forward(self, obs: torch.Tensor, agent_mean=None) -> torch.Tensor:
        dtype = _dtype(self.use_bf16)
        x = _tanh_layers(obs.to(dtype), self.embed, dtype)
        # jnp.mean of bf16 sums in f32 and rounds the mean back to bf16
        pooled = (x.float().mean(dim=-2) if agent_mean is None
                  else agent_mean(x.float(), -2).squeeze(-2))
        g = _tanh_layers(pooled.to(dtype), self.hidden, dtype)
        v = self.head(g.float())[..., 0]
        return v[..., None].expand(obs.shape[:-1])


def _check_vision_width(obs_width: int, vision_width: int) -> None:
    if obs_width < vision_width:
        raise ValueError(
            f"obs width {obs_width} < vision_width {vision_width}: ConvPolicy "
            f"splits obs[..., :vision_width] as the eye line"
        )


class _Conv1dNoTF32(torch.autograd.Function):
    """F.conv1d (no padding) whose forward and backward both run with
    cuDNN's TF32 off: the backward runs when the loss is differentiated,
    outside the module, where the global flag may allow TF32."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride):
        ctx.save_for_backward(x, weight)
        ctx.stride = stride
        with _no_tf32():
            return F.conv1d(x, weight, bias, stride)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], ctx.needs_input_grad[2]]
        with _no_tf32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]], [ctx.stride], [0], [1], False, [0], 1, mask)
        return gx, gw, gb, None


def _no_tf32():
    """cuDNN's flags as they are, but TF32 off (ROADMAP queue 3: exact fp32)."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class ConvPolicy(nn.Module):
    """1D-conv Gaussian policy over the eye line: obs [..., obs_dim] ->
    (mean [..., act_dim], log_std [act_dim]).

    obs[..., :vision_width] is a 1D image, so translation-equivariant
    features fit it: Conv1d layers (`channels`, kernel 5, stride 2, flax's
    'SAME' padding, tanh) over the line, flattened channel-last as flax
    flattens, the ego features obs[..., vision_width:] joined after them,
    then a Dense of `hidden` units and the fp32 head. The convs and the
    Dense run in bf16 when `use_bf16`; in either dtype with cuDNN's TF32
    off (_Conv1dNoTF32). Any leading batch dims.
    """

    def __init__(self, obs_dim: int, vision_width: int, channels: Sequence[int] = (16, 32),
                 kernel_size: int = 5, stride: int = 2, hidden: int = 128, act_dim: int = 2,
                 use_bf16: bool = True):
        super().__init__()
        _check_vision_width(obs_dim, vision_width)
        self.vision_width, self.kernel_size, self.stride = vision_width, kernel_size, stride
        self.use_bf16 = use_bf16
        chans = [1, *channels]
        self.convs = nn.ModuleList(nn.Conv1d(a, b, kernel_size, stride)
                                   for a, b in zip(chans[:-1], chans[1:]))
        length = vision_width
        for _ in channels:
            length = -(-length // stride)
        self.hidden = nn.Linear(length * chans[-1] + obs_dim - vision_width, hidden)
        self.head = nn.Linear(hidden, act_dim)
        self.log_std = _log_std(act_dim)
        _flax_init_(*self.convs, self.hidden, self.head)

    def _same_pad(self, x: torch.Tensor) -> torch.Tensor:
        """flax's 'SAME' padding (PyTorch's padding='same' refuses stride > 1)."""
        length, k, s = x.shape[-1], self.kernel_size, self.stride
        total = max((-(-length // s) - 1) * s + k - length, 0)
        return F.pad(x, (total // 2, total - total // 2))

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        w = self.vision_width
        _check_vision_width(obs.shape[-1], w)
        dtype = _dtype(self.use_bf16)
        batch = obs.shape[:-1]
        x = obs[..., :w].reshape(-1, 1, w).to(dtype)
        for conv in self.convs:
            x = torch.tanh(_Conv1dNoTF32.apply(self._same_pad(x), conv.weight.to(dtype),
                                               conv.bias.to(dtype), self.stride))
        x = x.transpose(1, 2).reshape(*batch, -1)  # channel-last, as flax flattens
        x = torch.cat([x, obs[..., w:].to(dtype)], dim=-1)
        x = _tanh_layer(x, self.hidden, dtype)
        return self.head(x.float()), self.log_std


def _keep_only_b_hn(grad: torch.Tensor) -> torch.Tensor:
    """bias_hh's gradient with its r and z thirds zeroed (GRUPolicy)."""
    keep = torch.ones_like(grad)
    keep[: 2 * (grad.shape[0] // 3)] = 0
    return grad * keep


class GRUPolicy(nn.Module):
    """Recurrent Gaussian policy: a Dense encoder, a GRU cell, the action
    head. forward(carry [..., hidden], obs [..., obs_dim]) -> (carry',
    (mean [..., act_dim], log_std [act_dim])), the carry from
    `initial_carry`. The encoder runs in bf16 when `use_bf16`; the cell and
    the head in fp32 (the carry accumulates over the rollout). flax's
    GRUCell and torch.nn.GRUCell compute the same gates: n = tanh(W_in x +
    b_in + r * (W_hn h + b_hn)), h' = (1 - z) n + z h. flax's cell has no
    b_hr, b_hz (the first two thirds of bias_hh): they stay 0, a hook
    zeroing their gradient, since each would otherwise train beside b_ir,
    b_iz and move the gate's bias twice as fast as the JAX trainer does."""

    def __init__(self, obs_dim: int, hidden: int = 128, act_dim: int = 2, use_bf16: bool = True):
        super().__init__()
        self.hidden_size, self.use_bf16 = hidden, use_bf16
        self.encoder = nn.Linear(obs_dim, hidden)
        self.cell = nn.GRUCell(hidden, hidden)
        # flax's GRUCell init: lecun-normal input kernels, orthogonal
        # recurrent kernels, zero biases; one [hidden, hidden] block a gate
        for w_i, w_h in zip(self.cell.weight_ih.data.chunk(3), self.cell.weight_hh.data.chunk(3)):
            _lecun_normal_(w_i)
            nn.init.orthogonal_(w_h)
        nn.init.zeros_(self.cell.bias_ih)
        nn.init.zeros_(self.cell.bias_hh)
        self.cell.bias_hh.register_hook(_keep_only_b_hn)
        self.head = nn.Linear(hidden, act_dim)
        self.log_std = _log_std(act_dim)
        _flax_init_(self.encoder, self.head)

    def forward(self, carry: torch.Tensor, obs: torch.Tensor):
        dtype = _dtype(self.use_bf16)
        x = _tanh_layer(obs.to(dtype), self.encoder, dtype).float()
        h = self.cell(x.reshape(-1, self.hidden_size),
                      carry.reshape(-1, self.hidden_size)).reshape(carry.shape)
        return h, (self.head(h), self.log_std)

    def initial_carry(self, batch_shape: Sequence[int],
                      device: str | torch.device = "cuda") -> torch.Tensor:
        """Zero hidden state, [*batch_shape, hidden] float32."""
        return torch.zeros((*batch_shape, self.hidden_size), device=device)


def seeded(seed: int, build: Callable[[], nn.Module]) -> nn.Module:
    """`build()` with its weights drawn from `seed`, leaving the global
    torch random state as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def init_mlp_policy(obs_dim: int, seed: int, use_bf16: bool = True) -> MLPPolicy:
    """An MLPPolicy whose weights come from `seed`, leaving the global
    torch random state as it was."""
    return seeded(seed, lambda: MLPPolicy(obs_dim, use_bf16=use_bf16))


def _tensor(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def state_dict_from_flax(module: nn.Module, params) -> Dict[str, torch.Tensor]:
    """Map the flax params of any family here to `module`'s state_dict.

    flax names its layers by kind and call order, and each module here
    registers its layers in that order, so the i-th nn.Linear takes
    'Dense_i' and the i-th nn.Conv1d 'Conv_i':
      MLPPolicy, ValueMLP  Dense_0.. (hidden layers), the last the head;
      CentralValueMLP      Dense_0.. (embedding), then the layers after
                           the pool, the last the head;
      ConvPolicy           Conv_0, Conv_1 ({'kernel' [k, in, out], 'bias'}
                           to Conv1d's [out, in, k]), Dense_0 (hidden),
                           Dense_1 (head);
      GRUPolicy            Dense_0 (encoder), GRUCell_0 ({'ir', 'iz', 'in'}
                           with kernel and bias, {'hr', 'hz'} kernel only,
                           'hn' kernel and bias), Dense_1 (head);
    and 'log_std' [act_dim] for the policies. Dense kernels [in, out] are
    transposed to nn.Linear's [out, in]. The GRU cell: weight_ih =
    cat(ir, iz, in)^T, bias_ih = cat(b_ir, b_iz, b_in), weight_hh =
    cat(hr, hz, hn)^T, bias_hh = cat(0, 0, b_hn). params: {'params': ...}
    or the inner dict, numpy (or array-like) leaves.
    """
    p = params["params"] if "params" in params else params

    def flax_layers(kind: str):
        keys = [k for k in p if k.startswith(kind + "_")]
        return sorted(keys, key=lambda k: int(k[len(kind) + 1:]))

    def pairs(kind: str, cls: type):
        names = [n for n, m in module.named_modules() if isinstance(m, cls)]
        keys = flax_layers(kind)
        if len(names) != len(keys):
            raise ValueError(f"{type(module).__name__} has {len(names)} {cls.__name__} "
                             f"layers, the flax params {len(keys)} {kind} layers")
        return zip(names, keys)

    out = {}
    for kind, cls, turn in (("Dense", nn.Linear, lambda k: k.T),
                            ("Conv", nn.Conv1d, lambda k: k.permute(2, 1, 0))):
        for name, key in pairs(kind, cls):
            out[f"{name}.weight"] = turn(_tensor(p[key]["kernel"])).contiguous()
            out[f"{name}.bias"] = _tensor(p[key]["bias"])
    for name, key in pairs("GRUCell", nn.GRUCell):
        g = {k: {kk: _tensor(v) for kk, v in leaf.items()} for k, leaf in p[key].items()}
        out[f"{name}.weight_ih"] = torch.cat([g[k]["kernel"] for k in ("ir", "iz", "in")], 1).T
        out[f"{name}.bias_ih"] = torch.cat([g[k]["bias"] for k in ("ir", "iz", "in")])
        out[f"{name}.weight_hh"] = torch.cat([g[k]["kernel"] for k in ("hr", "hz", "hn")], 1).T
        zero = torch.zeros_like(g["hn"]["bias"])
        out[f"{name}.bias_hh"] = torch.cat([zero, zero, g["hn"]["bias"]])
    if "log_std" in p:
        out["log_std"] = _tensor(p["log_std"])
    return out


def flax_from_state_dict(module: nn.Module) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of state_dict_from_flax: `module`'s weights as the flax
    params tree of the JAX family, {'params': {...}} with float32 numpy
    leaves (the i-th nn.Linear as 'Dense_i' with kernel [in, out], the i-th
    nn.Conv1d as 'Conv_i' with kernel [k, in, out], the GRU cell as
    'GRUCell_0' with its six gate blocks, 'log_std'). Saved with
    utils.checkpoint.save_pytree it is the file the JAX `train --save`
    writes, so a policy crosses between the packages both ways."""

    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy().copy()

    p = {}
    for kind, cls, turn in (("Dense", nn.Linear, lambda w: w.T),
                            ("Conv", nn.Conv1d, lambda w: w.permute(2, 1, 0))):
        layers = [m for m in module.modules() if isinstance(m, cls)]
        for i, layer in enumerate(layers):
            p[f"{kind}_{i}"] = {"kernel": arr(turn(layer.weight)), "bias": arr(layer.bias)}
    cells = [m for m in module.modules() if isinstance(m, nn.GRUCell)]
    for i, cell in enumerate(cells):
        w_i, w_h = cell.weight_ih.T.chunk(3, dim=1), cell.weight_hh.T.chunk(3, dim=1)
        b_i, b_h = cell.bias_ih.chunk(3), cell.bias_hh.chunk(3)
        g = {k: {"kernel": arr(w), "bias": arr(b)} for k, w, b in zip(("ir", "iz", "in"), w_i, b_i)}
        g.update({k: {"kernel": arr(w)} for k, w in zip(("hr", "hz"), w_h[:2])})
        g["hn"] = {"kernel": arr(w_h[2]), "bias": arr(b_h[2])}
        p[f"GRUCell_{i}"] = g
    if isinstance(getattr(module, "log_std", None), torch.Tensor):
        p["log_std"] = arr(module.log_std)
    return {"params": p}


def sample_gaussian(mean: torch.Tensor, log_std: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
    """a ~ N(mean, exp(log_std)) with noise from `generator` (on mean's
    device)."""
    eps = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(log_std) * eps


def sample_action(
    policy: nn.Module, obs: torch.Tensor, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample a[..., 2] ~ N(mean, exp(log_std)) with noise from `generator`
    (on obs's device); returns (action, log_prob [...])."""
    mean, log_std = policy(obs)
    action = sample_gaussian(mean, log_std, generator)
    return action, gaussian_log_prob(action, mean, log_std)


def gaussian_log_prob(
    action: torch.Tensor, mean: torch.Tensor, log_std: torch.Tensor
) -> torch.Tensor:
    """Sum over the action dim: [..., act_dim] -> [...]."""
    z = (action - mean) / torch.exp(log_std)
    return (-0.5 * z * z - log_std - 0.5 * math.log(2 * math.pi)).sum(dim=-1)
