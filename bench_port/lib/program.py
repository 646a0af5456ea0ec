"""The program under test, built from a configuration file: the port's
SimConfig and its MLP policy carrying the run's weights. The drivers take
everything else of the program from its public modules."""

from __future__ import annotations

import torch

from . import inputs


def sim_config(cfg: dict, antialias: bool = False):
    from nenbody_tpu_torch.config import GravityConfig, SimConfig, VisionConfig

    vision = None
    if "vision" in cfg:
        vision = VisionConfig(**cfg["vision"], antialias=antialias)
    return SimConfig(n=cfg["n"], controller=cfg["controller"], backend=cfg["backend"],
                     gravity=GravityConfig(**cfg["gravity"]), vision=vision,
                     spawn_pos_range=tuple(cfg["spawn_pos_range"]),
                     spawn_vel_range=tuple(cfg["spawn_vel_range"]))


def policy(cfg: dict, obs_dim: int, params: dict, device) -> torch.nn.Module:
    """The port's MLPPolicy of the configuration's sizes, on `device`,
    holding `params`."""
    from nenbody_tpu_torch.rl.policy import MLPPolicy

    pc = cfg["policy"]
    pol = MLPPolicy(obs_dim, hidden=tuple(pc["hidden"]), act_dim=pc["act_dim"],
                    use_bf16=pc["hidden_dtype"] == "bfloat16")
    return inputs.load_policy(pol.to(device), params)


def state(pos, vel):
    from nenbody_tpu_torch.state import SceneState

    t = torch.zeros(pos.shape[:-2], dtype=torch.int32, device=pos.device)
    return SceneState(pos=pos, vel=vel, t=t)
