"""Where a training iteration's time goes: REINFORCE, APG, APG with
diff_vision, PPO (per-agent and central critic), actor-critic, ES and
recurrent REINFORCE, each timed untraced and then traced once with
torch.profiler.

    python -m nenbody_tpu_torch.profile_train --out chiprun_out/prof_train.json
    python -m nenbody_tpu_torch.profile_train --sprite-mode wireframe \\
        --out chiprun_out/prof_train_wireframe.json
    python -m nenbody_tpu_torch.profile_train --device cpu --envs 2 --agents 16 \\
        --vision-width 16 --horizon 2 --runs 2 --out /tmp/prof.json

Defaults are BASELINE config 5's width (4,096 envs x 256 agents x 64 px,
horizon 8), disc sprites unless --sprite-mode says otherwise; each trainer
with the CLI's defaults (PPO 4 epochs x 4 minibatches, ES 8 antithetic
pairs, so 16 rollouts a generation). For each trainer: `--warmup` iterations, then `--runs` untraced iterations, each on
the host clock and ending when its metrics reach the host (median and all
runs), then one traced iteration. Device time is the
sum of the trace's CUDA kernel, memcpy and memset events, by category (one
per hand-written kernel, GEMMs, Adam, copies, the rest); `busy` is that sum
over the untraced median. Also the kernels' launch counts in the traced
iteration and the peak device memory. Writes one JSON object to --out and
prints it. On the CPU there are no device events: only the host times.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .config import SimConfig, VisionConfig
from .ops import common
from .rl import ac, apg, es, ppo, train
from .rl.env import VisionEnv
from .rl.policy import CentralValueMLP, seeded

# (category, substrings of a device event's name), first match wins
CATEGORIES = (
    ("gravity_vjp_kernel", ("gravity_vjp_kernel",)),  # the self form and both cross launches
    ("gravity_kernel", ("gravity_kernel",)),
    ("disc_eye_bwd_kernel", ("disc_eye_bwd_kernel",)),
    ("disc_eye_kernel", ("disc_eye_kernel",)),
    ("wireframe_eye_bwd_kernel", ("wireframe_eye_bwd_kernel",)),
    ("wireframe_eye_kernel", ("wireframe_eye_kernel",)),
    ("boids_partials_kernel", ("boids_partials_kernel",)),
    ("boids_kernel", ("boids_kernel",)),
    ("gemm", ("gemm", "cutlass", "xmma", "cublas")),
    ("adam", ("adam", "Adam")),
    ("memcpy/memset", ("Memcpy", "Memset", "memcpy", "memset")),
)
OTHER = "other elementwise/reduction"

# (name, algorithm, reward mode, antialias, diff_vision)
TRAINERS = (
    ("reinforce", "reinforce", "cohesion", False, False),
    ("apg", "apg", "cohesion", False, False),
    ("apg_diff_vision", "apg", "visibility", True, True),
    ("ppo", "ppo", "cohesion", False, False),
    ("ppo_central", "ppo_central", "team", False, False),
    ("ac", "ac", "cohesion", False, False),
    ("es", "es", "cohesion", False, False),
    ("reinforce_gru", "reinforce_gru", "cohesion", False, False),
)
ES_POPULATION = 8  # the CLI's default


def category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return OTHER


def device_ms_by_category(prof) -> dict:
    """Summed device time (ms) of the trace's CUDA-side events by category."""
    cats: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            cat = category(evt.name)
            cats[cat] = cats.get(cat, 0.0) + evt.time_range.elapsed_us() / 1e3
    return cats


def make_step(args, algo: str, reward_mode: str, antialias: bool, diff_vision: bool):
    env = VisionEnv(SimConfig(n=args.agents, controller="gravity",
                              vision=VisionConfig(width=args.vision_width, antialias=antialias,
                                                  sprite_mode=args.sprite_mode)),
                    reward_mode=reward_mode)
    kw = dict(seed=args.seed, device=args.device)
    if algo == "apg":
        ts = apg.init_apg_state(env, **kw)
        return ts, apg.make_apg_step(env, horizon=args.horizon, num_envs=args.envs,
                                     diff_vision=diff_vision)
    if algo.startswith("ppo"):
        central = algo == "ppo_central"
        value = seeded(args.seed + 1, lambda: CentralValueMLP(env.obs_width)) if central else None
        return ppo.init_ppo_state(env, value=value, **kw), ppo.make_ppo_step(
            env, horizon=args.horizon, num_envs=args.envs, central_critic=central)
    if algo == "ac":
        return ac.init_ac_state(env, args.envs, **kw), ac.make_ac_step(env, horizon=args.horizon)
    if algo == "es":
        return es.init_es_state(env, **kw), es.make_es_step(
            env, horizon=args.horizon, population=ES_POPULATION, num_envs=args.envs)
    if algo == "reinforce_gru":
        ts = train.init_recurrent_train_state(env, args.envs, **kw)
        return ts, train.make_recurrent_train_step(env, horizon=args.horizon)
    ts = train.init_train_state(env, args.envs, **kw)
    return ts, train.make_train_step(env, horizon=args.horizon)


def profile_trainer(args, algo, reward_mode, antialias, diff_vision) -> dict:
    cuda = torch.device(args.device).type == "cuda"
    ts, step = make_step(args, algo, reward_mode, antialias, diff_vision)

    def iteration(ts):
        t0 = time.perf_counter()
        ts, metrics = step(ts)
        metrics = {k: float(v) for k, v in metrics.items()}  # reaches the host
        if cuda:
            torch.cuda.synchronize()
        return ts, time.perf_counter() - t0

    for _ in range(args.warmup):
        ts, _ = iteration(ts)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(args.runs):
        ts, sec = iteration(ts)
        runs.append(sec)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    common.reset_launch_counts()
    with profile(activities=activities) as prof:
        ts, traced = iteration(ts)
    cats = device_ms_by_category(prof)
    device_s = sum(cats.values()) / 1e3
    median = statistics.median(runs)
    return {
        "median_s": median, "runs": runs, "traced_s": traced, "device_s": device_s,
        "busy": device_s / median,
        "agent_frames_per_s": (2 * ES_POPULATION if algo == "es" else 1)
        * args.envs * args.agents * args.horizon / median,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None,
        "launches": common.launch_counts(), "device_ms": cats,
    }


def card_name(device: str) -> str:
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nenbody_tpu_torch.profile_train",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--agents", type=int, default=256)
    ap.add_argument("--vision-width", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=8)
    ap.add_argument("--sprite-mode", choices=["disc", "wireframe"], default="disc")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; no fallback)")
    ap.add_argument("--out", type=Path, required=True, help="JSON file to write")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch.cuda.is_available() is false")
    result = {
        "card": card_name(args.device),
        "shape": {"envs": args.envs, "agents": args.agents, "width": args.vision_width,
                  "horizon": args.horizon, "sprite_mode": args.sprite_mode},
        "trainers": {name: profile_trainer(args, *spec) for name, *spec in TRAINERS},
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
