"""Training iterations of analytic policy gradients with differentiable
vision, as the port's trainer API runs them: rl.apg.init_apg_state with
the run's policy, then make_apg_step(env, horizon, num_envs, mesh,
diff_vision=True), each iteration on fresh spawns drawn from the state's
generator (seeded from the run's seed). A unit is one iteration.

Set-up drives the one training state through its first `setup_steps`
iterations with the window's own call; the window goes on from there.
Checked after the window against the plain reference (reference/apg.py),
which follows the program's own state: each set-up iteration's loss and
gradient from the parameters the program held before it (the first from
the benchmark's weights) and that iteration's spawns. Compared: the worst
iteration's loss (loss_gap); the least of the iterations' shares of
gradient elements whose sign differs from the reference's, over the
iterations whose reference gradient is not zero everywhere
(grad_sign_share: at horizon 8 a few near-collisions rule the gradient,
and now and then one of them turns it in float32, PERF.md); the
parameters after the set-up iterations against Adam stepped by the
reference on the program's gradients from the benchmark's weights
(update_gap).

With a mesh (drivers/apg_train_procs.py) every process runs this with its
block of the envs; rank 0 decides when the window ends and every rank
follows, each computes the reference for its share of the envs, and the
replicas' parameters after the window are compared bit for bit
(replica_mismatch).

Traffic keys (TRAFFIC_KEYS): horizon, lr, reward_mode, antialias,
diff_vision, setup_steps, trace_iterations, trace_after_s.

The eye's reference and work are the configuration's sprite_mode's
(reference/eyes.py, work/<sprite_mode>_eye.py and _eye_bwd.py). A traced
stretch that the line could not carry is traced again (lib/retrace.py),
as rank 0 decides from every rank's stretch.
"""

from __future__ import annotations

import torch

from bench_port import work
from bench_port.lib import inputs, program
from bench_port.lib.harness import Outcome
from bench_port.lib.retrace import Retrace
from bench_port.lib.window import Window
from bench_port.reference import apg as apg_ref
from bench_port.reference import compare, eyes
from bench_port.work import gravity, gravity_vjp, mlp, peaks

TRAFFIC_KEYS = frozenset({"horizon", "lr", "reward_mode", "antialias", "diff_vision",
                          "setup_steps", "trace_iterations", "trace_after_s"})


def run(ctx) -> Outcome:
    return train(ctx, None, None)


class Control:
    """Whether the window goes on, decided on rank 0's clock and sent to
    every rank over a host-side group (`group`; None on one process):
    0 stop, 1 go on, 2 go on and trace. A stretch to be traced again
    (`again`) is traced whether or not the window has closed."""

    def __init__(self, ctx, group):
        self.ctx, self.group = ctx, group

    def next(self, win: Window, traced: bool, again: bool) -> int:
        ctx = self.ctx
        go = int(win.running())
        if again or (go and ctx.trace and not traced
                     and win.elapsed() >= ctx.traffic["trace_after_s"]):
            go = 2
        if self.group is None:
            return go
        import torch.distributed as dist

        flag = torch.tensor([go])
        dist.broadcast(flag, src=0, group=self.group)
        return int(flag)


def train(ctx, mesh, group) -> Outcome:
    from nenbody_tpu_torch.rl import apg
    from nenbody_tpu_torch.rl.env import VisionEnv

    ctx.mark("program_imported")
    cfg, job, dev = ctx.config, ctx.traffic, ctx.device
    b, n, h = cfg["num_envs"], cfg["n"], job["horizon"]
    pc = cfg["policy"]
    env = VisionEnv(program.sim_config(cfg, job["antialias"]), max_accel=cfg["env"]["max_accel"],
                    reward_mode=job["reward_mode"])
    od = env.obs_width
    params = inputs.mlp_params(od, pc["hidden"], pc["act_dim"], ctx.seed, dev)
    spawn_seed = inputs.sub_seed(ctx.seed, "spawns")
    ts = apg.init_apg_state(env, seed=spawn_seed, lr=job["lr"],
                            policy=program.policy(cfg, od, params, dev), device=dev, mesh=mesh)
    step = apg.make_apg_step(env, horizon=h, num_envs=b, mesh=mesh,
                             diff_vision=job["diff_vision"])
    named = dict(ts.policy.named_parameters())
    # per set-up iteration: its loss, the gradient the optimizer took and
    # the parameters after it
    rec = {"losses": [], "grads": [], "params": []}
    tr = ctx.tracer
    retrace = Retrace(tr.cuda)
    ctx.mark("state_built")
    for i in range(job["setup_steps"]):
        ts, metrics = step(ts)
        ctx.mark(f"setup_step_{i + 1}_issued")
        rec["losses"].append(metrics["loss"].detach().clone())
        rec["grads"].append({k: p.grad.detach().clone() for k, p in named.items()})
        rec["params"].append(_copy(named))
    control = Control(ctx, group)
    win = Window(ctx.seconds, ctx.cuda, per_unit=False, card=ctx.card)
    _barrier(group)
    setup_s = win.open() - ctx.t0
    traced, again, summary, gen_states = False, False, None, []
    while True:
        go = control.next(win, traced, again)
        if go == 0:
            break
        if go == 2:
            tr.start()
            with tr.span("train_step"):
                ts, metrics = step(ts)
            win.tick()
            # the ranks open their stretches together: the line's busy_s, the
            # mean of theirs, is read against rank 0's stretch (lib/retrace.py)
            _barrier(group)
            tr.begin()
            gen_states = []
            for _ in range(job["trace_iterations"]):
                gen_states.append(ts.generator.get_state())
                with tr.span("train_step"):
                    ts, metrics = step(ts)
                win.tick()
            with tr.span("barrier"):
                _barrier(group)
            summary = tr.stop(job["trace_iterations"], "iteration")
            again = _retrace(retrace, summary, ctx.rank, group)
            traced = not again
            continue
        with tr.span("train_step"):
            ts, metrics = step(ts)
        win.tick()
    win.close()
    _barrier(group)
    length = win.length
    peak = torch.cuda.max_memory_allocated() if ctx.cuda else 0
    flats = _replicas(named, group)
    rec["losses"] = [float(x) for x in rec["losses"]]
    e2e = {"train_agent_frames_per_s": b * n * h * win.units / length,
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    units = win.units
    del ts, step, metrics, named
    if ctx.cuda:
        torch.cuda.empty_cache()
    if summary is not None:
        summary["work"] = _work(ctx, gen_states, spawn_seed)
    checks, controls, look = _check(ctx, params, spawn_seed, rec)
    if group is not None:
        checks["replica_mismatch"] = compare.replica_mismatch(flats)
    return Outcome(setup_s, e2e, checks, units, 0, peak, [summary] if summary else [], controls,
                   look)


def _copy(named: dict) -> dict:
    return {k: p.detach().clone() for k, p in named.items()}


def _replicas(named: dict, group):
    """Every process's parameters, flat on the host, in rank order (None
    on one process)."""
    if group is None:
        return None
    import torch.distributed as dist

    flat = torch.cat([p.detach().float().flatten() for p in named.values()]).cpu()
    flats = [None] * dist.get_world_size(group)
    dist.all_gather_object(flats, flat, group=group)
    return flats


def _barrier(group) -> None:
    if group is not None:
        import torch.distributed as dist

        dist.barrier(group=group)


def _retrace(retrace: Retrace, summary: dict, rank: int, group) -> bool:
    """Whether the stretch just traced is to be traced again: decided on
    rank 0 from every rank's stretch (gathered over `group`), which the
    other ranks follow through the Control."""
    stretches = [{"busy_s": summary["busy_s"], "window_s": summary["window_s"]}]
    if group is not None:
        import torch.distributed as dist

        gathered = [None] * dist.get_world_size(group)
        dist.all_gather_object(gathered, stretches[0], group=group)
        stretches = gathered
    return retrace.again(stretches) if rank == 0 else False


def _share(ctx):
    """This process's envs of the batch, for the reference and the work."""
    b = ctx.config["num_envs"]
    per = b // ctx.world
    return slice(ctx.rank * per, (ctx.rank + 1) * per)


def _spawns(ctx, spawn_seed: int, count: int, state=None):
    """The spawns of `count` iterations as the program's generator draws
    them (seeded with `spawn_seed`, or from a saved `state`): the whole
    batch each, of which this process keeps its share of the envs."""
    cfg = ctx.config
    gen = torch.Generator(device=ctx.device)
    if state is None:
        gen.manual_seed(spawn_seed)
    else:
        gen.set_state(state)
    out = []
    for _ in range(count):
        pos, vel = inputs.spawns(gen, (cfg["num_envs"], cfg["n"], 2), cfg, ctx.device)
        out.append((pos[_share(ctx)].contiguous(), vel[_share(ctx)].contiguous()))
    return out


def _work(ctx, gen_states, spawn_seed) -> dict:
    """This process's work in the traced iterations: its share of the
    envs' renders (horizon + 1 a iteration) and their pullbacks (horizon),
    gravity (horizon) and its pullbacks (horizon - 1), the policy's
    forward and backward; the eye's pixels counted by the reference eye on
    each iteration's spawns, and taken to hold for each of its renders."""
    cfg, job = ctx.config, ctx.traffic
    n, h, w = cfg["n"], job["horizon"], cfg["vision"]["width"]
    eye_ref, name = eyes.of(cfg["vision"]), eyes.name(cfg["vision"])
    eye = eye_ref.Eye.of(cfg["vision"], job["antialias"])
    stats = {}
    for state in gen_states:
        pos, vel = _spawns(ctx, spawn_seed, 1, state)[0]
        eye_ref.winners(pos, eye_ref.heading_of(vel), eye, stats=stats)
        b = pos.shape[0]
    iters = len(gen_states)
    g, gv = gravity.work(b, n), gravity_vjp.work(b, n)
    m = mlp.work(b * n, w + 2, cfg["policy"]["hidden"], cfg["policy"]["act_dim"], backward=True)
    eye_w = work.of(name).renders(b, n, w, iters * (h + 1),
                                  {k: (h + 1) * v for k, v in stats.items()})
    grav_w = {"fp32_ops": iters * h * g["fp32_ops"], "bytes": iters * h * g["bytes"]}
    bwd_w = work.of(f"{name}_bwd").renders(b, n, w, iters * h, {k: h * v for k, v in stats.items()})
    fp32 = (eye_w["fp32_ops"] + grav_w["fp32_ops"] + bwd_w["fp32_ops"]
            + iters * ((h - 1) * gv["fp32_ops"] + h * m["fp32_ops"]))
    return {f"{name}_kernel": eye_w, "gravity_kernel": grav_w, f"{name}_bwd_kernel": bwd_w,
            "op_seconds": peaks.op_seconds(fp32_ops=fp32, bf16_flops=iters * h * m["bf16_flops"])}


def _check(ctx, params, spawn_seed, rec):
    """The set-up iterations against the reference, each from the
    parameters the program held before it (the first from the benchmark's
    own weights `params`) on that iteration's spawns; with ctx.control also
    the control's first iteration, and each iteration's readings for a look."""
    cfg, job = ctx.config, ctx.traffic
    reduce = None
    if ctx.world > 1:
        import torch.distributed as dist

        def reduce(x):
            x = x.clone()
            dist.all_reduce(x)
            return x

    spawns = _spawns(ctx, spawn_seed, len(rec["losses"]))
    starts = [params] + rec["params"][:-1]
    refs = [apg_ref.gradient(apg_ref.leaves(p), pos, vel, cfg["num_envs"], cfg, job,
                             reduce=reduce) for p, (pos, vel) in zip(starts, spawns)]
    keys = compare.kept_leaves(refs[0][1])
    losses = [compare.loss_gap(a, r[0]) for a, r in zip(rec["losses"], refs)]
    # an iteration whose reference gradient is zero everywhere (the policy
    # saturated) has no sign to compare
    shares = [compare.sign_share(g, r[1], keys) if any(bool(r[1][k].any()) for k in keys)
              else None for g, r in zip(rec["grads"], refs)]
    stepped = apg_ref.adam_steps(params, rec["grads"], job["lr"])
    checks = {"loss_gap": max(losses),
              "grad_sign_share": min(x for x in shares if x is not None),
              "update_gap": compare.update_gap(rec["params"][-1], stepped, params)}
    controls, look = {}, {}
    if ctx.control:
        pos, vel = spawns[0]
        low = apg_ref.gradient(apg_ref.leaves(params), pos, vel, cfg["num_envs"], cfg, job,
                               lower=True, reduce=reduce)
        controls = {"loss_gap": compare.loss_gap(low[0], refs[0][0]),
                    "grad_sign_share": compare.sign_share(low[1], refs[0][1], keys)}
        look = {"losses": rec["losses"], "losses_ref": [r[0] for r in refs],
                "loss_gaps": losses, "sign_shares": shares,
                "grad_norms": [float(torch.linalg.vector_norm(torch.cat(
                    [x.flatten().float() for x in g.values()]))) for g in rec["grads"]]}
    return checks, controls, look
