"""Command line of the PyTorch port (counterpart of nenbody_tpu/cli.py):

    python -m nenbody_tpu_torch run --preset boids-4096 --steps 2000 --record out/run.nentraj
    python -m nenbody_tpu_torch run --n 4096 --checkpoint-dir out/ck --checkpoint-every 500
    python -m nenbody_tpu_torch run --resume out/ck/state_000002000.npz --steps 500
    python -m nenbody_tpu_torch run --n 1024 --controller gravity --vision-width 64 --policy pol.npz
    python -m nenbody_tpu_torch run --preset gravity-vision-1024 --capture 100 --first-person
    python -m nenbody_tpu_torch run --preset boids-4096 --backend cells --steps 200
    python -m nenbody_tpu_torch train --algo apg --envs 64 --agents 64 --iters 10 --save pol.npz
    python -m nenbody_tpu_torch train --checkpoint ts.npz --checkpoint-every 50
    python -m nenbody_tpu_torch train --resume ts.npz --iters 10
    python -m nenbody_tpu_torch train --mesh auto          # the agent-axis ring
    python -m nenbody_tpu_torch eval --policy pol.npz      # deterministic metrics
    python -m nenbody_tpu_torch datagen --out-dir out/ds && python -m nenbody_tpu_torch bc --data out/ds
    python -m nenbody_tpu_torch export --policy pol.npz --out step.pt2 --check
    python -m nenbody_tpu_torch gif --preset gravity-vision-1024 --steps 400 --first-person
    python -m nenbody_tpu_torch gif --n 64 --vision-width 32 --policy pol.npz
    python -m nenbody_tpu_torch replay out/run.nentraj --out out/replay.gif
    python -m nenbody_tpu_torch live --preset boids-4096     # needs matplotlib and a display
    python -m nenbody_tpu_torch info

Each command runs on the card by default (`--device cuda`, with no
fallback: on a machine without a GPU it fails) and on the CPU with
`--device cpu`, where each kernel's plain version runs. Flags, defaults,
messages and flag errors (rc 2) are the JAX commands'. Files cross between
the packages: a policy npz (`train --save`, `bc --save`) holds the flax
params tree of the JAX file (rl.policy.flax_from_state_dict), so either
package plays back the other's; `run` resumes a JAX scene checkpoint, and
`.nentraj` recordings and datagen shards read in both. A train checkpoint
(`--checkpoint`) holds the torch train state (modules, optimizer, env
states, generator, iteration) and resumes only in the port; a JAX one given
to `--resume` fails with the missing-leaf error.

`run` prints StepTimer's report with `t` after every `--log-every` steps
(the sync point is a host copy of pos). `train` prints one JSON line per
iteration: the trainer's metrics, `iter`, `sec` (host seconds of the step,
ending when its metrics reach the host) and `agent_frames` (envs x agents x
horizon, times 2 x population for es). `--mesh` (DATAxAGENTS, -1 for the
rest, or auto) runs the sim on a mesh of the visible CUDA devices
(rl/train.py). `export` writes a torch.export program (`.pt2`;
utils/export.py). `run --capture K` writes a PNG every K steps (viz.viewer;
`--first-person` adds the selected eye's viewport, rendered by the eye
kernel), `gif` a rollout GIF and `replay` a GIF of a `.nentraj` recording,
with the port's own PNG and GIF writers (viz.image), so no Pillow or
imageio is needed; `replay` reads a file and composes on the host, so it
takes no --device. `live` needs matplotlib and an interactive backend, and
without them exits 2 with the JAX command's message.

Not ported yet (ROADMAP queue 1): `bench` (item 6, the port's benchmark)
and `export --mesh` (item 17). JAX train checkpoints are not read: a
jax.random key and optax state have no torch counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

TRAINERS = ("reinforce", "reinforce-gru", "ppo", "ac", "es", "apg")
REWARD_MODES = ("cohesion", "team", "difference", "visibility")


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _device(args):
    """The torch device of --device, or rc 2 when it is cuda and no card is
    visible (no fallback to the CPU)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return _error(f"--device {args.device}, but torch.cuda.is_available() is false "
                      f"(pass --device cpu to {args.cmd} on the CPU)")
    return device


def _build_cfg(args):
    """The SimConfig of the sim flags: a preset with the flags given over
    it, or the flags alone (the JAX `_build_cfg`)."""
    from .config import PRESETS, SimConfig, VisionConfig

    sprite = args.sprite_mode

    def mk_vision(width):
        return VisionConfig(width=width, antialias=args.antialias,
                            sprite_mode=sprite or "disc") if width else None

    if args.preset:
        cfg = PRESETS[args.preset]()
        # explicit flags override preset fields (None = not provided)
        if args.n is not None:
            cfg = dataclasses.replace(cfg, n=args.n)
        if args.controller is not None:
            cfg = dataclasses.replace(cfg, controller=args.controller)
        if args.vision_width is not None:
            cfg = dataclasses.replace(cfg, vision=mk_vision(args.vision_width))
        elif cfg.vision is not None:
            vision = cfg.vision
            if args.antialias:
                vision = dataclasses.replace(vision, antialias=True)
            if sprite is not None:
                vision = dataclasses.replace(vision, sprite_mode=sprite)
            cfg = dataclasses.replace(cfg, vision=vision)
    else:
        cfg = SimConfig(
            n=args.n if args.n is not None else 1024,
            controller=args.controller or "boids",
            backend=args.backend or "auto",
            vision=mk_vision(args.vision_width),
        )
    # an explicit --backend (including "auto") overrides the preset's
    if args.backend is not None:
        cfg = dataclasses.replace(cfg, backend=args.backend)
    return cfg


def _add_device_flag(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda", help="torch device (default cuda; no fallback)")


def _add_sim_flags(p: argparse.ArgumentParser):
    from .config import PRESETS

    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--n", type=int, default=None, help="agent count (default 1024)")
    p.add_argument("--controller", choices=["gravity", "boids", "random"], default=None,
                   help="default boids")
    p.add_argument("--backend", choices=["auto", "dense", "pallas", "ring", "gspmd", "cells"],
                   default=None, help="default: the preset's backend, else auto")
    p.add_argument("--vision-width", type=int, default=None, help="0 disables vision")
    p.add_argument("--antialias", action="store_true",
                   help="MSAA-analog soft sprite edges in the eye lines")
    p.add_argument("--sprite-mode", choices=["disc", "wireframe"], default=None,
                   help="eye-line sprite model: disc (fast, default) or wireframe "
                   "(the reference's exact LineStrip triangle)")
    p.add_argument("--seed", type=int, default=0)
    _add_device_flag(p)


def _add_policy_flags(p: argparse.ArgumentParser):
    p.add_argument("--policy", default="",
                   help="trained params npz (`train --save`): the policy actuates the "
                   "swarm (gravity + control dynamics) instead of the controller")
    p.add_argument("--net", choices=["mlp", "conv", "gru"], default="mlp",
                   help="net family the params were trained with (gru: reinforce-gru "
                   "saves; the hidden state persists across the whole playback)")


def _add_train_vision_flags(p: argparse.ArgumentParser):
    """Observation appearance of the train-family commands (train, eval,
    datagen, bc, export share _train_env)."""
    p.add_argument("--sprite-mode", choices=["disc", "wireframe"], default="disc",
                   help="eye-line sprite model for the observations: disc (fast, "
                   "default) or wireframe (the reference's exact LineStrip triangle)")
    p.add_argument("--antialias", action="store_true",
                   help="MSAA-analog soft sprite edges in the observations")


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


def _load_policy(env, policy_path: str, net_name: str, device):
    """Load `train --save` params (of either package) into the matching
    default-hyperparameter net family on `device`, strictly matched
    (utils.checkpoint.load_pytree_matching)."""
    from .rl import policy as policy_lib
    from .utils import checkpoint as ck

    if not os.path.exists(policy_path):
        raise FileNotFoundError(f"policy params not found: {policy_path}")
    families = {
        "gru": lambda: policy_lib.GRUPolicy(env.obs_width),
        "conv": lambda: policy_lib.ConvPolicy(env.obs_width, env.cfg.vision.width),
        "mlp": lambda: policy_lib.MLPPolicy(env.obs_width),
    }
    pol = policy_lib.seeded(0, families[net_name])
    params = ck.load_pytree_matching(policy_path, policy_lib.flax_from_state_dict(pol),
                                     what=f"--net {net_name} params")
    pol.load_state_dict(policy_lib.state_dict_from_flax(pol, params))
    return pol.to(device).eval()


def _policy_advance(cfg, policy_path: str, net_name: str, device):
    """`(state, k) -> state` where a trained policy actuates the swarm:
    deterministic playback (the Gaussian mean) through the train env's
    transition, gravity + control acceleration (the scene's controller does
    not apply under --policy). A GRU's hidden state persists across calls,
    so the policy keeps its memory for the whole run."""
    from .rl.env import VisionEnv

    if cfg.vision is None:
        raise ValueError(
            "--policy needs vision (the policy consumes eye lines); pass "
            "--vision-width or a vision preset"
        )
    env = VisionEnv(cfg)
    pol = _load_policy(env, policy_path, net_name, device)
    carry = {}

    @torch.no_grad()
    def advance(state, k: int):
        for _ in range(k):
            obs = env.observe(state)
            if net_name == "gru":
                h = carry.get("h")
                if h is None:
                    h = pol.initial_carry(state.pos.shape[:-1], state.pos.device)
                carry["h"], (mean, _) = pol(h, obs)
            else:
                mean, _ = pol(obs)
            state = env.dynamics(state, mean)
        return state

    return advance


def cmd_run(args) -> int:
    from .scene import Scene
    from .utils import checkpoint as ck
    from .utils.profiling import StepTimer, device_trace

    device = _device(args)
    if isinstance(device, int):
        return device
    try:
        cfg = _build_cfg(args)
        scene = Scene(cfg, device=device)
    except (NotImplementedError, ValueError) as e:
        return _error(str(e))
    if args.resume:
        if not os.path.exists(args.resume):
            return _error(f"checkpoint not found: {args.resume}")
        state, stream = ck.load_state(args.resume, device)
        if stream is not None:
            scene.generator.set_state(stream)
        else:
            scene.generator.manual_seed(args.seed)
            if cfg.controller == "random" and not args.policy:
                print(f"warning: {args.resume} holds no torch random stream (a JAX "
                      f"checkpoint?); the random controller's stream is seeded from "
                      f"--seed {args.seed}", file=sys.stderr)
    else:
        state = scene.spawn(seed=args.seed)

    viewer = None
    if args.capture:
        from .viz.viewer import Viewer

        viewer = Viewer(out_dir=args.out_dir, first_person=args.first_person,
                        scene=scene if args.first_person else None)
    recorder = None
    if args.record:
        from .utils import native

        if not native.available() and not native.build():
            print("warning: native recorder unavailable; --record ignored", file=sys.stderr)
        else:
            recorder = native.TrajectoryRecorder(args.record, cfg.n)
    ckpt = (ck.PeriodicCheckpointer(args.checkpoint_dir, every=args.checkpoint_every)
            if args.checkpoint_dir else None)
    advance = None
    if args.policy:
        try:
            advance = _policy_advance(cfg, args.policy, args.net, device)
        except (ValueError, FileNotFoundError) as e:
            return _error(str(e))

    timer = StepTimer(cfg.n)
    chunk = max(1, args.log_every)
    done = 0
    dropped_frames = 0
    with device_trace(), torch.no_grad():
        timer.mark(0)
        while done < args.steps:
            k = min(chunk, args.steps - done)
            if advance is not None:
                state = advance(state, k)
            else:
                state, _ = scene.rollout(state, k)
            pos = state.pos.cpu().numpy()  # host tap (sync point)
            done += k
            timer.mark(k)
            t_abs = int(state.t.reshape(-1)[0])
            print(timer.report({"t": t_abs}), flush=True)
            if viewer is not None and done % args.capture < k:
                viewer.capture(state, scene.observe(state) if cfg.vision else None)
            # absolute sim time, so recordings from --resume'd runs stay
            # consistent with the checkpoint step counter
            if recorder is not None and not recorder.append(t_abs, pos, state.vel.cpu().numpy()):
                dropped_frames += 1
            if ckpt is not None:
                ckpt.maybe_save(state, scene.generator)
    if recorder is not None:
        recorder.close()
        if dropped_frames:
            print(f"warning: recorder queue full, {dropped_frames} frames dropped",
                  file=sys.stderr)
    if viewer is not None:
        viewer.flush()
    return 0


def _viewer_scene(args):
    """(scene, spawned state, advance) of the viewer commands' sim and
    policy flags, or an int rc on a reported error."""
    from .scene import Scene

    device = _device(args)
    if isinstance(device, int):
        return device
    try:
        cfg = _build_cfg(args)
        scene = Scene(cfg, device=device)
    except ValueError as e:
        return _error(str(e))
    advance = None
    if args.policy:
        try:
            advance = _policy_advance(cfg, args.policy, args.net, device)
        except (ValueError, FileNotFoundError) as e:
            return _error(str(e))
    return scene, scene.spawn(seed=args.seed), advance


def cmd_gif(args) -> int:
    from .viz.viewer import record_rollout_gif

    made = _viewer_scene(args)
    if isinstance(made, int):
        return made
    scene, state, advance = made
    path = record_rollout_gif(
        scene, state, num_steps=args.steps, path=args.out, stride=args.stride,
        first_person=args.first_person, advance=advance,
    )
    print(f"wrote {path}")
    return 0


def cmd_live(args) -> int:
    from .viz import live

    made = _viewer_scene(args)
    if isinstance(made, int):
        return made
    scene, state, advance = made
    try:
        live.run_live(scene, state, steps_per_frame=args.steps_per_frame, advance=advance)
    except live.NoDisplayError as e:
        return _error(str(e))
    return 0


def cmd_replay(args) -> int:
    """Re-render a recorded .nentraj trajectory to a GIF: checkpoint/replay
    closes the loop the reference's never-wired capture path left open."""
    from .utils import native
    from .viz import frame as frame_lib
    from .viz import image

    ts, pos, vel = native.read_trajectory(args.trajectory)
    frames = []
    for i in range(0, len(ts), max(1, args.stride)):
        img = frame_lib.render_topdown(pos[i], vel[i], size=(270, 480),
                                       half_extent=args.half_extent)
        frames.append(frame_lib.to_uint8(img))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    image.write_gif(args.out, frames, duration_ms=1000.0 / args.fps, loop=0)
    print(f"replayed {len(ts)} frames ({len(frames)} rendered) -> {args.out}")
    return 0


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
    from .rl.policy import flax_from_state_dict
    from .utils import checkpoint as ck

    if args.net == "conv" and args.algo == "reinforce-gru":
        return _error("--net conv is feedforward; reinforce-gru is its own (recurrent) net")
    if args.critic == "central" and args.algo not in ("ppo", "ac"):
        return _error("--critic central needs a learned value baseline (--algo ppo or ac)")
    device = _device(args)
    if isinstance(device, int):
        return device
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
    if args.resume:
        if not os.path.exists(ck._npz_path(args.resume)):
            return _error(f"train checkpoint not found: {args.resume}")
        # the freshly initialized train state is the template: modules,
        # optimizer state, generator and (where the trainer carries them)
        # env states and iteration all restore, strictly matched
        try:
            ts = ck.load_train_state(args.resume, ts)
        except ValueError as e:
            return _error(f"{e}\n(rerun with the --algo/--envs/--agents/"
                          f"--vision-width the checkpoint was written with)")
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
        if args.checkpoint and (i + 1) % max(1, args.checkpoint_every) == 0:
            ck.save_train_state(args.checkpoint, ts)
    if args.checkpoint:
        # always persist the final state: a run shorter than
        # --checkpoint-every must not silently write nothing
        ck.save_train_state(args.checkpoint, ts)
    if args.save:
        # the policy alone, as a flax tree: it plays back in either package
        ck.save_pytree(args.save, flax_from_state_dict(ts.policy))
        print(f"saved params -> {args.save}")
    return 0


def cmd_datagen(args) -> int:
    """Batched rollout dataset export (BASELINE config 5)."""
    from .rl import datagen as dg

    device = _device(args)
    if isinstance(device, int):
        return device
    env = _train_env(args)
    if env is None:
        return 2
    policy = None
    if args.policy:
        try:
            policy = _load_policy(env, args.policy, "mlp", device)
        except (ValueError, FileNotFoundError) as e:
            return _error(str(e))
    mesh = _mesh_from_args(args)
    if isinstance(mesh, int):
        return mesh
    total_frames = 0
    for i, chunk in dg.collect(env, num_envs=args.envs, total_steps=args.steps, seed=args.seed,
                               policy=policy, horizon=args.horizon, out_dir=args.out_dir,
                               mesh=mesh, device=device):
        t, b, n = chunk["reward"].shape
        total_frames += t * b * n
        print(json.dumps({"shard": i, "obs_shape": list(chunk["obs"].shape),
                          "agent_frames_total": total_frames}), flush=True)
    print(f"wrote {args.out_dir}", file=sys.stderr)
    return 0


def cmd_bc(args) -> int:
    """Behavior cloning: fit a policy to datagen shards (--data) or to a
    .nentraj recording (--trajectory: obs re-render on the device from the
    recorded states, actions from exact inverse dynamics). The save plays
    back like every other params npz."""
    from .rl import bc as bc_lib
    from .rl.policy import flax_from_state_dict

    if bool(args.data) == bool(args.trajectory):
        return _error("pass exactly one of --data (shard dir) or --trajectory (.nentraj)")
    if args.net == "gru":
        return _error("bc fits feedforward policies (--net mlp or conv)")
    device = _device(args)
    if isinstance(device, int):
        return device
    env = _train_env(args)
    if env is None:
        return 2
    net = _feedforward_net(args, env)
    try:
        if args.data:
            from .rl import datagen as dg

            data = dg.load_shards(args.data)
        else:
            data = bc_lib.dataset_from_trajectory(args.trajectory, env, device=device)
        policy, loss = bc_lib.fit(env, data, seed=args.seed, steps=args.steps,
                                  batch_size=args.batch_size, lr=args.lr, policy=net,
                                  log_every=args.log_every, device=device)
    except (ValueError, FileNotFoundError) as e:
        return _error(str(e))
    print(json.dumps({"bc_loss": loss, "steps": args.steps,
                      "source": args.data or args.trajectory}))
    if args.save:
        from .utils import checkpoint as ck

        ck.save_pytree(args.save, flax_from_state_dict(policy))
        print(f"saved params -> {args.save}")
    return 0


def spawn_eval_states(env, seed: int, num_envs: int, device):
    """eval's fresh spawns: `num_envs` envs from a generator seeded with
    `seed` on `device`."""
    from .state import spawn_batch

    return spawn_batch(env.cfg, torch.Generator(device=device).manual_seed(seed), num_envs,
                       device)


def cmd_eval(args) -> int:
    """Deterministic policy evaluation: batched fresh-spawn episodes, mean
    actions (no exploration noise), one JSON metrics line. Without
    --policy, evaluates the zero-action (uncontrolled gravity) baseline."""
    from .rl.train import batched_env_fns

    device = _device(args)
    if isinstance(device, int):
        return device
    env = _train_env(args, reward_mode=args.reward_mode)
    if env is None:
        return 2
    pol = None
    if args.policy:
        try:
            pol = _load_policy(env, args.policy, args.net, device)
        except (ValueError, FileNotFoundError) as e:
            return _error(str(e))
    mesh = _mesh_from_args(args)
    if isinstance(mesh, int):
        return mesh
    states = spawn_eval_states(env, args.seed, args.envs, device)
    # the observation threads through the loop, so each state renders once
    # (the trainers' rollout structure; visibility rewards reuse the render)
    observe, step = batched_env_fns(env, mesh)
    rewards = []
    try:
        with torch.no_grad():
            obs = observe(states)
            h = (pol.initial_carry(obs.shape[:-1], device)
                 if pol is not None and args.net == "gru" else None)
            for _ in range(args.horizon):
                if pol is None:
                    action = torch.zeros((*obs.shape[:-1], 2), device=device)
                elif h is not None:
                    h, (action, _) = pol(h, obs)
                else:
                    action, _ = pol(obs)
                states, obs, r = step(states, action)
                rewards.append(r)
    except ValueError as e:
        return _error(str(e))
    rs = torch.stack(rewards).double()  # [T, B, N]
    print(json.dumps({
        "reward_mean": float(rs.mean()),
        "reward_first": float(rs[0].mean()),
        "reward_final": float(rs[-1].mean()),
        "reward_mode": args.reward_mode,
        "horizon": args.horizon,
        "envs": args.envs,
        "agents": args.agents,
        "policy": args.policy or "zero-action baseline",
    }))
    return 0


def cmd_export(args) -> int:
    """Export a serving step with torch.export (`.pt2`): with --policy, the
    trained closed-loop step (weights inside); without, `--steps`
    controller steps (sim as a service). Loadable with
    utils.export.load_policy_step with no checkpoint, net or env at the
    site; the program runs on its inputs' device (--device picks it)."""
    from .config import SimConfig
    from .utils import export as export_lib

    if args.mesh:
        return _error("--mesh export (the multi-device fleet step) is not ported yet "
                      "(ROADMAP queue 1 item 17)")
    device = _device(args)
    if isinstance(device, int):
        return device
    num_envs = args.envs if args.envs > 0 else None
    try:
        if args.policy:
            env = _train_env(args)
            if env is None:
                return 2
            cfg = env.cfg
            pol = _load_policy(env, args.policy, args.net, device)
            blob = export_lib.export_policy_step(env, pol, num_envs=num_envs, steps=args.steps)
        else:
            cfg = SimConfig(n=args.agents, controller=args.controller)
            blob = export_lib.export_sim_step(cfg, num_envs=num_envs, steps=args.steps,
                                              device=device)
    except (ValueError, FileNotFoundError) as e:
        return _error(str(e))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        f.write(blob)
    if args.check:
        from .state import spawn, spawn_batch

        step = export_lib.load_policy_step(args.out)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        st = (spawn(cfg, gen, device) if num_envs is None
              else spawn_batch(cfg, gen, num_envs, device))
        out = step(st.pos, st.vel)  # (pos, vel[, action])
        if not all(bool(torch.isfinite(o).all()) for o in out):
            print("error: exported artifact produced non-finite outputs", file=sys.stderr)
            return 1
    print(json.dumps({
        "out": args.out, "bytes": len(blob), "device": str(device),
        "mode": "policy" if args.policy else f"sim:{args.controller}",
        "agents": args.agents, "steps": args.steps,
        "envs": num_envs, "mesh": None,
        "checked": bool(args.check),
    }))
    return 0


def cmd_info(args) -> int:  # noqa: ARG001
    from .config import PRESETS
    from .ops import common
    from .utils import native

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    lib = common.library_path()
    print(json.dumps({
        "backend": "cuda" if count else "cpu",
        "devices": [torch.cuda.get_device_name(i) for i in range(count)],
        "device_count": count,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "native_runtime": native.available(),
        "presets": sorted(PRESETS),
        "kernel_library": {"path": str(lib), "built": lib.exists()},
    }, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nenbody-tpu-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run a simulation with logging, recording and checkpoints")
    _add_sim_flags(p)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--capture", type=int, default=0, help="PNG every K steps")
    p.add_argument("--first-person", action="store_true",
                   help="add the selected eye's first-person viewport to captures")
    p.add_argument("--out-dir", default="out/frames")
    p.add_argument("--record", default="", help=".nentraj trajectory path")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--checkpoint-every", type=int, default=1000)
    p.add_argument("--resume", default="", help="npz checkpoint to resume")
    _add_policy_flags(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("train", help="policy training on the vision env")
    p.add_argument("--algo", choices=TRAINERS, default="reinforce")
    p.add_argument("--critic", choices=["agent", "central"], default="agent",
                   help="ppo/ac value baseline: per-agent V(obs_i) or the centralized "
                   "pooled V(s) (MAPPO-style, for team/shared rewards)")
    p.add_argument("--population", type=int, default=8, help="ES antithetic pairs")
    p.add_argument("--envs", type=int, default=64)
    p.add_argument("--agents", type=int, default=64)
    p.add_argument("--vision-width", type=int, default=64)
    _add_train_vision_flags(p)
    p.add_argument("--horizon", type=int, default=8)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--net", choices=["mlp", "conv"], default="mlp",
                   help="policy function family (conv: 1D convs over the eye line)")
    p.add_argument("--save", default="", help="save params npz")
    p.add_argument("--checkpoint", default="",
                   help="periodically save the FULL train state (modules + optimizer + "
                   "env states + generator) for --resume")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", default="",
                   help="train-state npz from --checkpoint (must match algo/shapes)")
    p.add_argument("--reward-mode", choices=REWARD_MODES, default="cohesion",
                   help="per-agent shaping, shared team objective, counterfactual "
                   "difference rewards, or observation-defined visibility")
    _add_device_flag(p)
    p.add_argument("--mesh", default="",
                   help="run the sim on a mesh of the visible CUDA devices: DATAxAGENTS "
                   "(e.g. 2x4, -1 for the rest) or auto (every card on the agent axis)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("bc", help="behavior cloning from datagen shards or a recording")
    p.add_argument("--data", default="", help="datagen shard dir")
    p.add_argument("--trajectory", default="",
                   help=".nentraj recording (stride-1, from run --record)")
    p.add_argument("--agents", type=int, default=64)
    p.add_argument("--vision-width", type=int, default=64)
    _add_train_vision_flags(p)
    p.add_argument("--steps", type=int, default=500, help="gradient steps")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=0)
    p.add_argument("--net", choices=["mlp", "conv"], default="mlp",
                   help="policy function family")
    p.add_argument("--save", default="", help="save params npz")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_bc)

    p = sub.add_parser("eval", help="evaluate a saved policy (deterministic, fresh spawns)")
    p.add_argument("--envs", type=int, default=16)
    p.add_argument("--agents", type=int, default=64)
    p.add_argument("--vision-width", type=int, default=64)
    _add_train_vision_flags(p)
    p.add_argument("--horizon", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reward-mode", choices=REWARD_MODES, default="cohesion")
    p.add_argument("--mesh", default="",
                   help="device mesh: DATAxAGENTS (e.g. 2x4) or 'auto'")
    _add_policy_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("datagen", help="export batched rollout datasets")
    p.add_argument("--envs", type=int, default=256)
    p.add_argument("--agents", type=int, default=64)
    p.add_argument("--vision-width", type=int, default=64)
    _add_train_vision_flags(p)
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--horizon", type=int, default=32, help="steps per shard")
    p.add_argument("--out-dir", default="out/dataset")
    p.add_argument("--policy", default="", help="params npz (default: random actions)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", default="",
                   help="generate on a device mesh: DATAxAGENTS (e.g. 2x4) or 'auto'")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_datagen)

    p = sub.add_parser("export", help="export a serving step (torch.export .pt2): trained "
                       "policy loop or plain controller sim")
    p.add_argument("--policy", default="",
                   help="trained params npz; omit to export the plain controller sim")
    p.add_argument("--controller", choices=["gravity", "boids"], default="gravity",
                   help="sim-mode controller (ignored with --policy; the random walk "
                   "stays live: it consumes a random stream)")
    p.add_argument("--steps", type=int, default=1,
                   help="sim steps baked per artifact call")
    p.add_argument("--net", choices=["mlp", "conv"], default="mlp",
                   help="feedforward family the params were trained with (gru stays "
                   "on the live playback path: its carry is stateful)")
    p.add_argument("--agents", type=int, default=64)
    p.add_argument("--vision-width", type=int, default=64)
    _add_train_vision_flags(p)
    p.add_argument("--envs", type=int, default=0,
                   help="leading env-batch dim baked into the artifact (0 = unbatched)")
    p.add_argument("--out", default="policy_step.pt2")
    p.add_argument("--mesh", default="",
                   help="the multi-device fleet step (not ported yet: refused)")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and run one step on fresh spawns")
    p.add_argument("--seed", type=int, default=0)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("gif", help="record a rollout gif (demo-video analog)")
    _add_sim_flags(p)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--stride", type=int, default=4)
    p.add_argument("--out", default="out/rollout.gif")
    p.add_argument("--first-person", action="store_true",
                   help="add the selected eye's first-person viewport panel")
    _add_policy_flags(p)
    p.set_defaults(fn=cmd_gif)

    p = sub.add_parser("live", help="interactive viewer (needs matplotlib and a display)")
    _add_sim_flags(p)
    p.add_argument("--steps-per-frame", type=int, default=10)
    _add_policy_flags(p)
    p.set_defaults(fn=cmd_live)

    p = sub.add_parser("replay", help="re-render a .nentraj recording to GIF")
    p.add_argument("trajectory", help="path to a .nentraj file")
    p.add_argument("--out", default="out/replay.gif")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--half-extent", type=float, default=120.0)
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("info", help="devices, presets, native runtime and kernel library status")
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)
