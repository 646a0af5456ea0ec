"""Command line of the PyTorch port (counterpart of nenbody_tpu/cli.py; its
`train` command for the two ported trainers so far, ROADMAP queue 1
item 18 for the rest):

    python -m nenbody_tpu_torch train --algo apg --envs 64 --agents 64 --iters 10
    python -m nenbody_tpu_torch train --device cpu --envs 4 --agents 16 --iters 2

Flags and defaults are the JAX `train` command's for these trainers, plus
`--device` (default cuda, with no fallback: on a machine without a GPU it
fails). Each iteration prints one JSON line: the trainer's metrics, `iter`,
`sec` (host seconds of the step, ending when its metrics reach the host)
and `agent_frames` (envs x agents x horizon).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

TRAINERS = ("reinforce", "apg")
# the JAX package's other trainers, not ported yet
UNPORTED_TRAINERS = ("reinforce-gru", "ppo", "ac", "es")


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _train_env(args, reward_mode: str = "cohesion"):
    """The train-family env (gravity + control dynamics, vision obs) from
    --agents/--vision-width/--sprite-mode/--antialias, as the JAX
    `_train_env` builds it.
    Prints a clean error and returns None on an invalid flag combination."""
    from .config import SimConfig, VisionConfig
    from .rl.env import VisionEnv

    if args.vision_width < 1:
        _error("this command needs vision; --vision-width must be >= 1")
        return None
    cfg = SimConfig(
        n=args.agents, controller="gravity",
        vision=VisionConfig(width=args.vision_width, sprite_mode=args.sprite_mode,
                            antialias=args.antialias),
    )
    try:
        return VisionEnv(cfg, reward_mode=reward_mode)
    except ValueError as e:
        _error(str(e))
        return None


def cmd_train(args) -> int:
    if args.algo in UNPORTED_TRAINERS:
        return _error(f"--algo {args.algo} is not ported yet (ROADMAP queue 1 item 13); "
                      f"the port trains with {' or '.join(TRAINERS)}")
    if args.algo not in TRAINERS:
        return _error(f"unknown --algo {args.algo!r}; choose {' or '.join(TRAINERS)}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return _error("--device cuda, but torch.cuda.is_available() is false "
                      "(pass --device cpu to train on the CPU)")
    env = _train_env(args, reward_mode=args.reward_mode)
    if env is None:
        return 2
    if args.algo == "apg":
        from .rl import apg

        ts = apg.init_apg_state(env, seed=args.seed, lr=args.lr, device=device)
        step = apg.make_apg_step(env, horizon=args.horizon, num_envs=args.envs)
    else:
        from .rl import train

        ts = train.init_train_state(env, args.envs, seed=args.seed, lr=args.lr, device=device)
        step = train.make_train_step(env, horizon=args.horizon)
    for i in range(args.iters):
        t0 = time.perf_counter()
        ts, metrics = step(ts)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics.update(
            iter=i,
            sec=time.perf_counter() - t0,
            agent_frames=args.envs * args.agents * args.horizon,
        )
        print(json.dumps(metrics), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nenbody-tpu-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="policy training on the vision env")
    p.add_argument("--algo", default="reinforce",
                   help=f"trainer: {' or '.join(TRAINERS)} (the JAX package's "
                   f"{', '.join(UNPORTED_TRAINERS)} are not ported yet)")
    p.add_argument("--envs", type=int, default=64)
    p.add_argument("--agents", type=int, default=64)
    p.add_argument("--vision-width", type=int, default=64)
    p.add_argument("--sprite-mode", choices=["disc", "wireframe"], default="disc",
                   help="eye-line sprite model for the observations: disc (fast, "
                   "default) or wireframe (the reference's exact LineStrip triangle)")
    p.add_argument("--antialias", action="store_true",
                   help="MSAA-analog soft sprite edges in the observations")
    p.add_argument("--horizon", type=int, default=8)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reward-mode", choices=["cohesion", "team", "difference", "visibility"],
                   default="cohesion",
                   help="per-agent shaping, shared team objective, counterfactual "
                   "difference rewards, or observation-defined visibility")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; no fallback)")
    p.set_defaults(fn=cmd_train)

    args = ap.parse_args(argv)
    return args.fn(args)
