"""Rollouts of a policy over a batch of envs, as the port's `eval` command
runs them: rl.train.batched_env_fns(env, None), the observation of each
step feeding the policy's mean action of the next, under no_grad.

The window runs episodes of `episode_steps` steps, each from fresh spawns
drawn from the seed, so that the eye's work, which depends on how the
agents lie, stays stationary. A unit is one step (policy, then the env's
step: dynamics, eye, reward); an episode's spawn and first observation
fall into its first step.

Checked (after the window, against the plain reference, from the
program's own state at each kept step; the start is the first step of
set-up, from the benchmark's spawn): the observation of the step's input
state and of its output state (obs_mismatch_share), the mean action from
the input observation (action_gap) and the state the step returned given
that action (state_gap), for a sample of envs of each kept step.

Traffic keys (TRAFFIC_KEYS): episode_steps, reward_mode, antialias,
warmup_steps, check_steps (kept steps of the window), check_envs (envs a
kept step), trace_after_s (window seconds before the traced episode).

The eye, its reference and its work are the configuration's sprite_mode's
(reference/eyes.py, work/<sprite_mode>_eye.py). A traced episode whose
stretch the line could not carry is traced again (lib/retrace.py).
"""

from __future__ import annotations

import torch

from bench_port import work
from bench_port.lib import inputs, program
from bench_port.lib.checks import Reservoir
from bench_port.lib.harness import Outcome
from bench_port.lib.retrace import Retrace
from bench_port.lib.window import Window, p95
from bench_port.reference import compare, eyes, world
from bench_port.reference import policy as policy_ref
from bench_port.work import gravity, mlp, peaks

TRAFFIC_KEYS = frozenset({"episode_steps", "reward_mode", "antialias", "warmup_steps",
                          "check_steps", "check_envs", "trace_after_s"})


def run(ctx) -> Outcome:
    from nenbody_tpu_torch.rl.env import VisionEnv
    from nenbody_tpu_torch.rl.train import batched_env_fns

    cfg, job, dev = ctx.config, ctx.traffic, ctx.device
    b, n, w = cfg["num_envs"], cfg["n"], cfg["vision"]["width"]
    pc = cfg["policy"]
    env = VisionEnv(program.sim_config(cfg, job["antialias"]), max_accel=cfg["env"]["max_accel"],
                    reward_mode=job["reward_mode"])
    od = env.obs_width
    params = inputs.mlp_params(od, pc["hidden"], pc["act_dim"], ctx.seed, dev)
    policy = program.policy(cfg, od, params, dev)
    observe, step = batched_env_fns(env, None)
    gen = inputs.generator(ctx.seed, "spawns", dev)
    rng = inputs.sampler(ctx.seed, "checks")
    k, ke = job["check_steps"], min(job["check_envs"], b)
    envs = [torch.tensor(sorted(rng.sample(range(b), ke)), device=dev) for _ in range(k + 1)]
    f32 = torch.float32
    res = Reservoir(k, rng, {"pos": ((ke, n, 2), f32), "vel": ((ke, n, 2), f32),
                             "obs": ((ke, n, od), f32), "act": ((ke, n, pc["act_dim"]), f32),
                             "pos2": ((ke, n, 2), f32), "vel2": ((ke, n, 2), f32),
                             "obs2": ((ke, n, od), f32)}, dev)
    tr = ctx.tracer
    retrace = Retrace(tr.cuda)

    def keep(slot, unit, s, obs, act, nxt, nobs):
        idx = envs[slot]
        res.keep(slot, unit, pos=s.pos.index_select(0, idx), vel=s.vel.index_select(0, idx),
                 obs=obs.index_select(0, idx), act=act.index_select(0, idx),
                 pos2=nxt.pos.index_select(0, idx), vel2=nxt.vel.index_select(0, idx),
                 obs2=nobs.index_select(0, idx))

    def spawn():
        return program.state(*inputs.spawns(gen, (b, n, 2), cfg, dev))

    with torch.no_grad():
        state = spawn()
        obs = observe(state)
        ret = torch.zeros((b, n), device=dev)
        for i in range(job["warmup_steps"]):
            act = policy(obs)[0]
            nxt, nobs, r = step(state, act)
            ret += r
            if i == 0:
                keep(0, -1, state, obs, act, nxt, nobs)
            state, obs = nxt, nobs
        win = Window(ctx.seconds, ctx.cuda, card=ctx.card)
        setup_s = win.open() - ctx.t0
        # the trace: None, lead, traced, done; "again" where a stretch is traced again
        phase, kept_states, summary = None, None, None
        while win.running() or phase in ("lead", "traced", "again"):
            if phase == "again" or (phase is None and ctx.trace
                                    and win.elapsed() >= job["trace_after_s"]):
                tr.start()
                phase = "lead"
            elif phase == "lead":
                tr.begin()
                phase, kept_states = "traced", []
            tracing = phase == "traced"
            with tr.span("spawn"):
                state = spawn()
                ret.zero_()
            with tr.span("observe"):
                obs = observe(state)
            if tracing:
                kept_states.append((state.pos, state.vel))
            for _ in range(job["episode_steps"]):
                with tr.span("policy"):
                    act = policy(obs)[0]
                with tr.span("step"):
                    nxt, nobs, r = step(state, act)
                    ret += r
                if tracing:
                    kept_states.append((nxt.pos, nxt.vel))
                slot = res.slot()
                if slot is not None:
                    with tr.span("keep"):
                        keep(slot, win.units, state, obs, act, nxt, nobs)
                win.tick()
                state, obs = nxt, nobs
                if phase not in ("lead", "traced") and not win.running():
                    break
            if tracing:
                summary = tr.stop(job["episode_steps"], "step")
                phase = "done"
                if retrace.again([summary]):
                    summary, phase = None, "again"
        win.close()
    if summary is not None:
        summary["work"] = _work(kept_states, job, cfg)
    units = win.units
    peak = torch.cuda.max_memory_allocated() if ctx.cuda else 0
    e2e = {"agent_steps_per_s": b * n * units / win.length,
           "step_ms_p95": p95(win.unit_ms()) if ctx.cuda else 0.0,
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    del state, obs, nxt, nobs, act, r, ret, kept_states
    if ctx.cuda:
        torch.cuda.empty_cache()
    checks, controls = _check(ctx, res, params)
    return Outcome(setup_s, e2e, checks, units, 0, peak, [summary] if summary else [], controls)


def _work(states, job, cfg) -> dict:
    """The traced episode's work: each render of `states` (the episode's
    spawn and every step's result), its pixels counted by the reference
    eye, a gravity evaluation and a policy call a step."""
    b, n, w = cfg["num_envs"], cfg["n"], cfg["vision"]["width"]
    eye_ref, name = eyes.of(cfg["vision"]), eyes.name(cfg["vision"])
    eye = eye_ref.Eye.of(cfg["vision"], job["antialias"])
    stats = {}
    for pos, vel in states:
        eye_ref.winners(pos, eye_ref.heading_of(vel), eye, stats=stats)
    steps = job["episode_steps"]
    g = gravity.work(b, n)
    m = mlp.work(b * n, w + 2, cfg["policy"]["hidden"], cfg["policy"]["act_dim"])
    eye_w = work.of(name).renders(b, n, w, len(states), stats)
    grav_w = {"fp32_ops": g["fp32_ops"] * steps, "bytes": g["bytes"] * steps}
    flops = {"fp32_ops": eye_w["fp32_ops"] + grav_w["fp32_ops"] + m["fp32_ops"] * steps,
             "bf16_flops": m["bf16_flops"] * steps}
    return {f"{name}_kernel": eye_w, "gravity_kernel": grav_w,
            "op_seconds": peaks.op_seconds(**flops)}


def _check(ctx, res: Reservoir, params: dict):
    """The numbers compared, and with ctx.control the control's: the
    reference one precision lower in the program's place."""
    cfg, job = ctx.config, ctx.traffic
    eye_ref = eyes.of(cfg["vision"])
    eye = eye_ref.Eye.of(cfg["vision"], job["antialias"])
    grav, hid = cfg["gravity"], cfg["policy"]["hidden_dtype"]
    readings = {"": {"bad": 0, "all": 0, "action_gap": 0.0, "state_gap": 0.0}}
    if ctx.control:
        readings["control"] = dict(readings[""])
    with torch.no_grad():
        for i in res.kept():
            x = {k: v[i] for k, v in res.buf.items()}
            refs = {}
            for lower in (False, True) if ctx.control else (False,):
                dt = torch.bfloat16 if lower else torch.float32
                obs = [torch.cat([eye_ref.lines(p, v, eye, dt)[0], v], -1)
                       for p, v in ((x["pos"], x["vel"]), (x["pos2"], x["vel2"]))]
                act = policy_ref.mean_action(params, x["obs"], hid, lower)
                force = world.gravity(x["pos"], grav["g"], grav["bias"], dtype=dt)
                pos2, vel2 = world.integrate(x["pos"], x["vel"], force, x["act"], grav["dt"],
                                             cfg["env"]["max_accel"], grav["dt_on_position"], dt)
                if not lower:
                    refs = {"obs": obs, "act": act, "pos2": pos2, "vel2": vel2}
                    got = {"obs": [x["obs"], x["obs2"]], "act": x["act"], "pos2": x["pos2"],
                           "vel2": x["vel2"]}
                else:
                    got = {"obs": obs, "act": act, "pos2": pos2, "vel2": vel2}
                r = readings["control" if lower else ""]
                for o, o_ref in zip(got["obs"], refs["obs"]):
                    bad = (o - o_ref).abs() > compare.SHADE_TOL
                    r["bad"] += int(bad.sum())
                    r["all"] += bad.numel()
                r["action_gap"] = max(r["action_gap"], compare.rel_max(got["act"], refs["act"]))
                r["state_gap"] = max(r["state_gap"], compare.step_gap(
                    got["pos2"], got["vel2"], refs["pos2"], refs["vel2"], x["pos"], x["vel"]))
    out = {}
    for key, r in readings.items():
        out[key] = {"obs_mismatch_share": r["bad"] / max(r["all"], 1),
                    "action_gap": r["action_gap"], "state_gap": r["state_gap"]}
    return out[""], out.get("control", {})
