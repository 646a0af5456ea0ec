"""Analytic policy gradients in plain PyTorch: iterations of Adam on the
negated mean visibility reward of fresh episodes, differentiated through
the dynamics and the eye.

Per iteration, from spawns (pos, vel) [B, N, 2] of B envs:

    obs_0 = lines(s_0) ++ vel_0
    for t < H:  a_t = mean_action(obs_t);  s_{t+1} = step(s_t, a_t);
                obs_{t+1} = lines(s_{t+1}) ++ vel_{t+1}
                r_t = mean over envs, agents and pixels of (shade_{t+1} - bg)
    loss = -mean_t r_t

`lines` is the configuration's reference eye (reference/eyes.py, by its
sprite_mode). Envs are independent, so the loss is a sum of per-env terms
and the gradient is taken env block by env block. `reduce`, where given, sums a
tensor over the processes that each hold some of the envs.
"""

from __future__ import annotations

import torch

from . import eyes
from . import policy as policy_ref
from . import world

# envs of one block of the differentiated rollout, as agents x agents
# pairs: its saved tensors stay within a few GiB
BLOCK_PAIRS = 1 << 25


def episode_loss(params: dict, pos, vel, cfg: dict, job: dict, lower: bool = False):
    """The loss of one block of envs (not yet divided among blocks): the
    world and the eye computed in float32 (bfloat16 where `lower`)."""
    dtype = torch.bfloat16 if lower else torch.float32
    eye_ref = eyes.of(cfg["vision"])
    vision = eye_ref.Eye.of(cfg["vision"], job["antialias"])
    grav, env = cfg["gravity"], cfg["env"]
    hidden = cfg["policy"]["hidden_dtype"]

    def observe(p, v):
        s, _ = eye_ref.lines(p, v, vision, dtype)
        return torch.cat([s, v], dim=-1), s

    obs, _ = observe(pos, vel)
    rewards = []
    for _ in range(job["horizon"]):
        act = policy_ref.mean_action(params, obs, hidden, lower)
        force = world.gravity(pos, grav["g"], grav["bias"], dtype=dtype)
        pos, vel = world.integrate(pos, vel, force, act, grav["dt"], env["max_accel"],
                                   grav["dt_on_position"], dtype)
        obs, s = observe(pos, vel)
        rewards.append((s - vision.background).mean())
    return -torch.stack(rewards).mean()


def leaves(params: dict) -> dict:
    """float32 copies of `params` that autograd differentiates."""
    return {k: v.detach().float().clone().requires_grad_() for k, v in params.items()}


def gradient(params: dict, pos, vel, total_envs: int, cfg: dict, job: dict,
             lower: bool = False, reduce=None):
    """One iteration's loss and its gradient with respect to `params` (leaves,
    as `leaves` makes them) on the spawns (pos, vel) [B, N, 2], this
    process's B envs of `total_envs`, in blocks of envs; with `reduce` both
    summed over the processes. Returns (loss, {name: gradient})."""
    n = cfg["n"]
    step = max(1, BLOCK_PAIRS // (n * n))
    for p in params.values():
        p.grad = torch.zeros_like(p)
    total = torch.zeros((), device=pos.device, dtype=torch.float64)
    for b0 in range(0, pos.shape[0], step):
        blk = slice(b0, b0 + step)
        loss = episode_loss(params, pos[blk], vel[blk], cfg, job, lower)
        loss = loss * (pos[blk].shape[0] / total_envs)
        loss.backward()
        total += loss.detach()
    grads = {k: p.grad.detach().clone() for k, p in params.items()}
    for p in params.values():
        p.grad = None
    if reduce is not None:
        total = reduce(total)
        grads = {k: reduce(g) for k, g in grads.items()}
    return float(total), grads


def adam_steps(params0: dict, grads: list, lr: float) -> dict:
    """The parameters after Adam at `lr` (PyTorch's defaults otherwise)
    takes the gradients `grads`, one dict a step, from `params0`."""
    params = {k: v.detach().float().clone() for k, v in params0.items()}
    opt = torch.optim.Adam(params.values(), lr=lr)
    for g in grads:
        for k, p in params.items():
            p.grad = g[k].float().clone()
        opt.step()
    return params
