"""The policy in plain PyTorch: the mean action of a tanh MLP whose hidden
layers compute in the configuration's hidden dtype (weights kept in
float32 and cast per call) and whose head computes in float32.

The benchmark's control computes the hidden layers one precision lower
(`LOWER`): their inputs and weights rounded through that type first.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
# the next precision below each: where the control rounds to
LOWER = {"float32": "bfloat16", "bfloat16": "float8_e4m3fn", "float16": "float8_e4m3fn"}

# (weight, bias) names of each layer of an MLP of two hidden layers
LAYERS = (("hidden.0.weight", "hidden.0.bias"), ("hidden.1.weight", "hidden.1.bias"),
          ("head.weight", "head.bias"))


def _rounded(x: torch.Tensor, compute: torch.dtype, through: str | None) -> torch.Tensor:
    if through is not None:
        x = x.to(getattr(torch, through))
    return x.to(compute)


def mean_action(params: dict, obs: torch.Tensor, hidden_dtype: str = "bfloat16",
                lower: bool = False) -> torch.Tensor:
    """[..., act] mean action of `params` (float32, named as in LAYERS) on
    obs [..., obs_dim]; `lower` rounds the hidden layers' operands one
    precision below `hidden_dtype`."""
    dt = DTYPES[hidden_dtype]
    through = LOWER[hidden_dtype] if lower else None
    x = _rounded(obs, dt, through)
    for wname, bname in LAYERS[:-1]:
        w = _rounded(params[wname], dt, through)
        b = _rounded(params[bname], dt, through)
        x = torch.tanh(F.linear(x, w, b))
        if through is not None:
            x = _rounded(x, dt, through)
    wname, bname = LAYERS[-1]
    return F.linear(x.float(), params[wname], params[bname])
