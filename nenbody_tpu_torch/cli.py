"""Command line of the PyTorch port (counterpart of nenbody_tpu/cli.py; its
`train` command with all six trainers, ROADMAP queue 1 item 18 for the
other commands):

    python -m nenbody_tpu_torch train --algo apg --envs 64 --agents 64 --iters 10
    python -m nenbody_tpu_torch train --algo ppo --critic central --reward-mode team
    python -m nenbody_tpu_torch train --algo reinforce --net conv
    python -m nenbody_tpu_torch train --device cpu --envs 4 --agents 16 --iters 2
    python -m nenbody_tpu_torch train --mesh auto          # the agent-axis ring

Flags, defaults and flag errors (rc 2) are the JAX `train` command's
(`--algo reinforce|reinforce-gru|ppo|ac|es|apg`, `--net mlp|conv`,
`--critic agent|central` for ppo and ac, `--population` for es), plus
`--device` (default cuda, with no fallback: on a machine without a GPU it
fails); its `--save`, `--checkpoint` and `--resume` wait for ROADMAP
queue 1 item 15. `--mesh` (DATAxAGENTS, -1 for the rest, or auto: every
card on the agent axis) runs the sim on a mesh of the visible CUDA devices
(rl/train.py). Each iteration prints one JSON line: the trainer's metrics,
`iter`, `sec` (host seconds of the step, ending when its metrics reach the
host) and `agent_frames` (envs x agents x horizon, times 2 x population
for es).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

TRAINERS = ("reinforce", "reinforce-gru", "ppo", "ac", "es", "apg")


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


def _parse_mesh(spec: str):
    """'auto' (every visible CUDA device on the agent axis) or 'DATAxAGENTS'
    (e.g. 2x4; -1 = all remaining devices) -> parallel.mesh.Mesh."""
    from .parallel.mesh import make_mesh

    if spec == "auto":
        return make_mesh()
    try:
        d, a = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(
            f"--mesh expects DATAxAGENTS (e.g. 2x4, -1 for remaining) or "
            f"'auto', got {spec!r}"
        ) from None
    return make_mesh({"data": d, "agents": a})


def _mesh_from_args(args):
    """The Mesh of --mesh (None when unset), or an int rc on a reported
    error: a malformed spec, too few cards, or --envs not dividing the data
    axis."""
    if not args.mesh:
        return None
    from .rl.train import check_mesh_envs

    try:
        mesh = _parse_mesh(args.mesh)
        check_mesh_envs(mesh, args.envs)
        return mesh
    except (ValueError, RuntimeError) as e:
        return _error(str(e))


def _feedforward_net(args, env):
    """--net -> the feedforward trainers' policy (None: their default MLP)."""
    if args.net == "conv":
        from .rl.policy import ConvPolicy, seeded

        return seeded(args.seed, lambda: ConvPolicy(env.obs_width, env.cfg.vision.width))
    return None


def _trainer(args, env, mesh, device):
    """(train state, step) of --algo; a ValueError for a minibatch scheme
    PPO cannot run."""
    net = _feedforward_net(args, env)
    central = None
    if args.critic == "central":
        from .rl.policy import CentralValueMLP, seeded

        central = seeded(args.seed + 1, lambda: CentralValueMLP(env.obs_width))
    kw = dict(seed=args.seed, lr=args.lr, device=device)
    if args.algo == "apg":
        from .rl import apg

        return (apg.init_apg_state(env, policy=net, **kw),
                apg.make_apg_step(env, horizon=args.horizon, num_envs=args.envs, mesh=mesh))
    if args.algo == "ppo":
        from .rl import ppo

        step = ppo.make_ppo_step(env, horizon=args.horizon, num_envs=args.envs, mesh=mesh,
                                 central_critic=central is not None)
        return ppo.init_ppo_state(env, policy=net, value=central, **kw), step
    if args.algo == "ac":
        from .rl import ac

        return (ac.init_ac_state(env, args.envs, policy=net, value=central, mesh=mesh, **kw),
                ac.make_ac_step(env, horizon=args.horizon, mesh=mesh))
    if args.algo == "es":
        from .rl import es

        return (es.init_es_state(env, policy=net, **kw),
                es.make_es_step(env, horizon=args.horizon, population=args.population,
                                num_envs=args.envs, mesh=mesh))
    from .rl import train

    if args.algo == "reinforce-gru":
        return (train.init_recurrent_train_state(env, args.envs, mesh=mesh, **kw),
                train.make_recurrent_train_step(env, horizon=args.horizon, mesh=mesh))
    return (train.init_train_state(env, args.envs, policy=net, mesh=mesh, **kw),
            train.make_train_step(env, horizon=args.horizon, mesh=mesh))


def cmd_train(args) -> int:
    if args.net == "conv" and args.algo == "reinforce-gru":
        return _error("--net conv is feedforward; reinforce-gru is its own (recurrent) net")
    if args.critic == "central" and args.algo not in ("ppo", "ac"):
        return _error("--critic central needs a learned value baseline (--algo ppo or ac)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return _error("--device cuda, but torch.cuda.is_available() is false "
                      "(pass --device cpu to train on the CPU)")
    env = _train_env(args, reward_mode=args.reward_mode)
    if env is None:
        return 2
    mesh = _mesh_from_args(args)
    if isinstance(mesh, int):
        return mesh
    try:
        ts, step = _trainer(args, env, mesh, device)
    except ValueError as e:
        return _error(str(e))
    rollouts = 2 * args.population if args.algo == "es" else 1
    for i in range(args.iters):
        t0 = time.perf_counter()
        ts, metrics = step(ts)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics.update(
            iter=i,
            sec=time.perf_counter() - t0,
            agent_frames=rollouts * args.envs * args.agents * args.horizon,
        )
        print(json.dumps(metrics), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nenbody-tpu-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="policy training on the vision env")
    p.add_argument("--algo", choices=TRAINERS, default="reinforce")
    p.add_argument("--critic", choices=["agent", "central"], default="agent",
                   help="ppo/ac value baseline: per-agent V(obs_i) or the centralized "
                   "pooled V(s) (MAPPO-style, for team/shared rewards)")
    p.add_argument("--population", type=int, default=8, help="ES antithetic pairs")
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
    p.add_argument("--net", choices=["mlp", "conv"], default="mlp",
                   help="policy function family (conv: 1D convs over the eye line)")
    p.add_argument("--reward-mode", choices=["cohesion", "team", "difference", "visibility"],
                   default="cohesion",
                   help="per-agent shaping, shared team objective, counterfactual "
                   "difference rewards, or observation-defined visibility")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; no fallback)")
    p.add_argument("--mesh", default="",
                   help="run the sim on a mesh of the visible CUDA devices: DATAxAGENTS "
                   "(e.g. 2x4, -1 for the rest) or auto (every card on the agent axis)")
    p.set_defaults(fn=cmd_train)

    args = ap.parse_args(argv)
    return args.fn(args)
