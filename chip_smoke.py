#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nenbody_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is non-zero):
  1. device   — the card's name and power limit; TF32 off.
  2. build    — nvcc builds the six kernels from nenbody_tpu_torch/csrc
                into build/nenbody_tpu_torch/ (one nvcc per source, all at
                once); ptxas reports registers, shared memory and spills.
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the main paths' shapes (the backward kernels and the
                wireframe eye also at the trainers'), with the tolerance
                stated; the autograd Functions' gradients on the card
                against plain autograd.
  4. slice    — the serving path through the user's entry points (Scene
                rollouts at BASELINE configs 2, 3, 4, 5 and reference-100,
                and the port's entry()), launch counts read before and after.
     train    — APG diff_vision's parameter gradients, kernel route against
                dense autograd on the card; then the training path through
                the user's entry points at config-5 width (4,096 envs x 256
                agents x 64 px, horizon 8): `train --algo reinforce` and
                `--algo apg` of the CLI, then APG with diff_vision
                (antialias, visibility reward); metrics finite,
                grad_norm > 0, parameters moved, launch counts read before
                and after. Runs with autograd on.
     wireframe — the exact wireframe eye's paths, each with its launch
                counts read before and after: Scene rollouts with
                sprite_mode='wireframe' at config 2 and reference-100, then
                `train --algo reinforce --sprite-mode wireframe` of the CLI
                and APG with diff_vision (antialias, visibility) at
                config-5 width.
  5. times    — CUDA-event times of each kernel and its plain version,
                alternated (plain, kernel, kernel, plain), the eyes with and
                without their winner index, steps/s of the config-2 rollout
                (both sprites), reference-100 (wireframe) and entry(), and
                seconds per training iteration and agent-frames/s of each
                trainer.
The line before the last is a JSON object with one entry per kernel
(`launches` sums the paths' counts; `bound_ms` is the larger of the
operations over the card's fp32 peak and the bytes over its memory rate,
for the inputs timed; `library_ms` is null: no single PyTorch call computes
any of these functions); the last line is {"ok": true, "device": {...}}.
Imports no jax.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import subprocess
import sys
import time

import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

from nenbody_tpu_torch import PRESETS, Scene, SimConfig, VisionConfig, cli
from nenbody_tpu_torch.config import BoidsConfig, GravityConfig
from nenbody_tpu_torch.entry import entry
from nenbody_tpu_torch.ops import boids as boids_ops
from nenbody_tpu_torch.ops import common, pairwise, raycast, wireframe
from nenbody_tpu_torch.physics import dense
from nenbody_tpu_torch.rl import apg
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.vision import camera, render

KERNEL_INFO = {
    "gravity": dict(source="nenbody_tpu_torch/csrc/gravity.cu",
                    replaces="nenbody_tpu/ops/pairwise.py:42"),
    "boids": dict(source="nenbody_tpu_torch/csrc/boids.cu",
                  replaces="nenbody_tpu/ops/boids.py:34"),
    "disc_eye": dict(source="nenbody_tpu_torch/csrc/disc_eye.cu",
                     replaces="nenbody_tpu/ops/raycast.py:221",
                     also_replaces="nenbody_tpu/ops/raycast.py:79"),
    "gravity_vjp": dict(source="nenbody_tpu_torch/csrc/gravity_vjp.cu",
                        replaces="nenbody_tpu/ops/pairwise.py:161"),
    "disc_eye_bwd": dict(source="nenbody_tpu_torch/csrc/disc_eye_bwd.cu",
                         replaces="nenbody_tpu/ops/raycast.py:649"),
    "wireframe_eye": dict(source="nenbody_tpu_torch/csrc/wireframe_eye.cu",
                          replaces="nenbody_tpu/ops/wireframe.py:376",
                          also_replaces=["nenbody_tpu/ops/wireframe.py:877",
                                         "nenbody_tpu/ops/wireframe.py:545",
                                         "nenbody_tpu/ops/wireframe.py:288"]),
}
EYE_SHAPES = [(1, 1024, 64), (1, 100, 1024), (1, 4096, 256), (64, 256, 64)]
WF_SHAPES = [(1, 1024, 64), (1, 100, 1024), (1, 1024, 1024), (64, 256, 64)]
SERVING = ("gravity", "boids", "disc_eye")
TRAINING = ("gravity", "disc_eye", "gravity_vjp", "disc_eye_bwd")
WF_SERVING = ("gravity", "boids", "wireframe_eye")
WF_TRAINING = {"reinforce": ("gravity", "wireframe_eye"),
               "apg diff_vision": ("gravity", "gravity_vjp", "wireframe_eye")}
# BASELINE config 5 width for the trainers
TRAIN_ENVS, TRAIN_AGENTS, TRAIN_WIDTH, TRAIN_HORIZON = 4096, 256, 64, 8
# One H100 SXM's published peaks: fp32 outside
# the tensor cores, and HBM3.
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# fp32 operations each kernel's function does, counted from its plain
# version's expressions (a divide, square root or comparison as one):
# per pair for the physics, per (eye, target) pair and per covered
# (eye, target, pixel) for the eyes
GRAVITY_OPS, GRAVITY_VJP_OPS, BOIDS_OPS = 11, 25, 22
DISC_PAIR_OPS, DISC_PIXEL_OPS = 16, 6
WF_PAIR_OPS, WF_PAIR_AA_OPS, WF_EDGE_OPS = 54, 114, 13
DISC_BWD_PIXEL_OPS = 60


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo


class Errors:
    """The largest absolute error each kernel showed against its plain
    version in phase 3."""

    def __init__(self):
        self.max_abs = {k: 0.0 for k in KERNEL_INFO}

    def check(self, kernel, label, got, want, rtol, atol):
        torch.cuda.synchronize()
        got, want = got.double(), want.double()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{label}: shape {tuple(got.shape)} or non-finite output")
        diff = (got - want).abs()
        bad = diff > atol + rtol * want.abs()
        err = diff.max().item()
        self.max_abs[kernel] = max(self.max_abs[kernel], err)
        differing = (diff > 0).double().mean().item()
        log("kernels", f"{label}: max_abs_err={err:.3e} differing={differing:.2e} "
            f"beyond_tol={bad.double().mean().item():.2e} (rtol={rtol}, atol={atol})")
        if bad.any():
            raise AssertionError(f"{label}: {int(bad.sum())} elements beyond tolerance")

    def check_scaled(self, kernel, label, got, want, bound):
        """|got - want| / max|want| < bound, for sums that cancel (the error
        scales with the largest output, not with each element)."""
        torch.cuda.synchronize()
        got, want = got.double(), want.double()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{label}: shape {tuple(got.shape)} or non-finite output")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        self.max_abs[kernel] = max(self.max_abs[kernel], err)
        log("kernels", f"{label}: max_abs_err={err:.3e} err/max|want|="
            f"{err / scale if scale else err:.3e} (bound {bound:.1e})")
        if scale == 0.0 and err != 0.0 or scale and not err / scale < bound:
            raise AssertionError(f"{label}: beyond its bound")


def phase_kernels(errors: Errors, gen) -> None:
    # gravity at N=1,000 (tests/test_kernels.py:28 tolerances)
    gcfg = GravityConfig()
    pos = uniform(gen, (1000, 2), -100, 100)
    errors.check("gravity", "gravity N=1000", pairwise.gravity_forces_tiled(pos, gcfg),
                 pairwise.gravity_forces_plain(pos, gcfg), 3e-5, 1e-7)
    # batched + cross form (pos_j), ragged tails
    pb = uniform(gen, (3, 300, 2), -100, 100)
    pj = uniform(gen, (3, 77, 2), -100, 100)
    errors.check("gravity", "gravity B=3 N=300 cross M=77",
                 pairwise.gravity_forces_tiled(pb, gcfg, pj),
                 pairwise.gravity_forces_plain(pb, gcfg, pj), 3e-5, 1e-7)
    # approx reciprocal (tests/test_kernels.py:31 bound, normalised)
    pos = uniform(gen, (300, 2), -100, 100)
    want = pairwise.gravity_forces_plain(pos, gcfg)
    got = pairwise.gravity_forces_tiled(pos, GravityConfig(approx_reciprocal=True))
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log("kernels", f"gravity approx N=300: normalised err={rel:.3e} (bound 1e-2)")
    if not rel < 1e-2:
        raise AssertionError("gravity approx_reciprocal beyond its bound")
    # N=65,536 against float64: the sum cancels heavily, so the error is
    # normalised by max |g_i|; the stated bound is N * 2^-24 (a worst-case
    # sequential fp32 sum of N terms).
    n = 65536
    pos = uniform(gen, (n, 2), -100, 100)
    want64 = pairwise.gravity_forces_plain(pos.double(), gcfg)
    got = pairwise.gravity_forces_tiled(pos, gcfg)
    plain32 = pairwise.gravity_forces_plain(pos, gcfg)
    torch.cuda.synchronize()
    scale = want64.norm(dim=-1).max()
    k_err = ((got.double() - want64).abs().max() / scale).item()
    p_err = ((plain32.double() - want64).abs().max() / scale).item()
    bound = n * 2.0 ** -24
    errors.max_abs["gravity"] = max(errors.max_abs["gravity"],
                                    (got.double() - want64).abs().max().item())
    log("kernels", f"gravity N=65536 vs float64: kernel err/max|g|={k_err:.3e}, "
        f"plain fp32 err/max|g|={p_err:.3e}, bound {bound:.3e}")
    if not k_err < bound:
        raise AssertionError("gravity N=65536 beyond its float64 bound")

    # boids at N=4,096 (tests/test_kernels.py:60 tolerances), and clustered
    # so that all three rules fire, at test_kernels.py:76's N=128 (at large
    # clustered N the separation sum cancels over hundreds of neighbours and
    # the summation order alone moves it past atol)
    bcfg = BoidsConfig()
    for label, n, lo, hi in (("spread", 4096, -100, 100), ("clustered", 128, -8, 8)):
        pos = uniform(gen, (n, 2), lo, hi)
        vel = uniform(gen, (n, 2), -1, 1)
        errors.check("boids", f"boids N={n} {label}",
                     boids_ops.boids_velocity_tiled(pos, vel, bcfg),
                     boids_ops.boids_velocity_plain(pos, vel, bcfg), 3e-5, 1e-6)
    # global_alignment (kernel skips rule 3) equals the full fold at |v| < 250
    errors.check("boids", "boids N=128 global_alignment vs full fold",
                 boids_ops.boids_velocity_tiled(pos, vel, BoidsConfig(global_alignment=True)),
                 dense.boids_accels(pos, vel, bcfg), 3e-5, 1e-6)
    pb = uniform(gen, (5, 333, 2), -20, 20)
    vb = uniform(gen, (5, 333, 2), -1, 1)
    errors.check("boids", "boids B=5 N=333", boids_ops.boids_velocity_tiled(pb, vb, bcfg),
                 boids_ops.boids_velocity_plain(pb, vb, bcfg), 3e-5, 1e-6)

    # the disc eye (tests/test_kernels.py:209-210 tolerances)
    for b, n, w in EYE_SHAPES:
        shape = (b, n, 2) if b > 1 else (n, 2)
        pos = uniform(gen, shape, -100, 100)
        dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
        for aa in (False, True):
            vcfg = VisionConfig(width=w, antialias=aa)
            gs, gd = raycast.disc_eye(pos, dirs, pos, vcfg)
            ws, wd = raycast.disc_eye_plain(pos, dirs, pos, vcfg)
            label = f"disc_eye B={b} N={n} W={w} aa={aa}"
            errors.check("disc_eye", label + " depth", gd, wd, 1e-5, 1e-4)
            errors.check("disc_eye", label + " shade", gs, ws, 1e-5, 1e-5)


def phase_backward_kernels(errors: Errors, gen) -> None:
    # the gravity VJP (tests/test_kernels.py:141-155's normalized bound: the
    # closed form summed in another order)
    gcfg = GravityConfig()
    for shape in ((1, 2), (257, 2), (1000, 2), (3, 300, 2), (TRAIN_ENVS, TRAIN_AGENTS, 2)):
        pos = uniform(gen, shape, -100, 100)
        u = torch.randn(shape, generator=gen, device="cuda")
        label = f"gravity_vjp {'x'.join(map(str, shape[:-1]))}"
        errors.check_scaled("gravity_vjp", label, pairwise.gravity_vjp_tiled(pos, u, gcfg),
                            pairwise.gravity_vjp_plain(pos, u, gcfg), 3e-5)
    # N=65,536 against float64, normalised by max |grad|; the stated bound is
    # N * 2^-24 (a worst-case sequential fp32 sum of N terms), as for gravity
    n = 65536
    pos = uniform(gen, (n, 2), -100, 100)
    u = torch.randn((n, 2), generator=gen, device="cuda")
    want64 = pairwise.gravity_vjp_plain(pos.double(), u.double(), gcfg)
    plain32 = pairwise.gravity_vjp_plain(pos, u, gcfg)
    torch.cuda.synchronize()
    p_err = ((plain32.double() - want64).abs().max() / want64.abs().max()).item()
    log("kernels", f"gravity_vjp N=65536: plain fp32 err/max|grad| vs float64 {p_err:.3e}")
    errors.check_scaled("gravity_vjp", "gravity_vjp N=65536 vs float64",
                        pairwise.gravity_vjp_tiled(pos, u, gcfg), want64, n * 2.0 ** -24)

    # the disc backward against autograd through the plain renderer, with
    # random cotangents (tests/test_diff_vision.py:31-57's tolerances: per-
    # pixel terms round apart; target sums run in atomic, run-to-run order),
    # at every forward shape and at the trainers' (config-5 width)
    for b, n, w in EYE_SHAPES + [(TRAIN_ENVS, TRAIN_AGENTS, TRAIN_WIDTH)]:
        shape = (b, n, 2) if b > 1 else (n, 2)
        pos = uniform(gen, shape, -100, 100)
        dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
        us = torch.randn(shape[:-1] + (w,), generator=gen, device="cuda")
        ud = torch.randn(shape[:-1] + (w,), generator=gen, device="cuda") * 1e-3
        for aa in (False, True):
            vcfg = VisionConfig(width=w, antialias=aa)
            _, _, winner = raycast.disc_eye_with_winner(pos, dirs, pos, vcfg)
            got = raycast.render_rows_vjp_cross(pos, dirs, winner, us, ud, vcfg)
            want = raycast.render_rows_vjp_cross_plain(pos, dirs, us, ud, vcfg)
            for name, g, x in zip(("d_eye", "d_dir", "d_tgt"), got, want):
                errors.check("disc_eye_bwd", f"disc_eye_bwd B={b} N={n} W={w} aa={aa} {name}",
                             g, x, 2e-4, 2e-4 * x.abs().max().item())


def phase_grad_reference() -> None:
    """The autograd Functions on the card (forward and backward kernels)
    against plain autograd of the dense backend on the CPU, same inputs:
    gravity against float64 (float32 autograd through the dense force
    cancels: it is the less exact side, DESIGN.md section 4b), the eye
    against float32 (the same forward arithmetic)."""
    gen = torch.Generator().manual_seed(3)
    pos0 = torch.rand((3, 96, 2), generator=gen) * 60 - 30
    vel0 = torch.rand((3, 96, 2), generator=gen) * 2 - 1
    us = torch.randn((3, 96, 48), generator=gen)
    gcfg = GravityConfig()

    def grad_of(loss_fn, device, dtype=torch.float32):
        p = pos0.to(device, dtype, copy=True).requires_grad_()
        v = vel0.to(device, dtype, copy=True).requires_grad_()
        loss_fn(p, v).backward()
        return [None if x.grad is None else x.grad.cpu().double() for x in (p, v)]

    got = grad_of(lambda p, v: (pairwise.gravity_forces_diff(p, gcfg) ** 2).sum(), "cuda")[0]
    want = grad_of(lambda p, v: (dense.gravity_forces(p, gcfg) ** 2).sum(), "cpu",
                   torch.float64)[0]
    err = ((got - want).abs().max() / want.abs().max()).item()
    log("kernels", f"gravity_forces_diff (cuda) vs dense float64 autograd (cpu): "
        f"err/max|grad| {err:.3e} (bound 3e-5)")
    if not err < 3e-5:
        raise AssertionError("gravity_forces_diff disagrees with dense autograd")
    for aa in (False, True):
        vcfg = VisionConfig(width=48, antialias=aa)
        got = grad_of(lambda p, v: (raycast.render_rows_diff(p, v, vcfg)[0]
                                    * us.to(p.device)).sum(), "cuda")
        want = grad_of(lambda p, v: (render.render_rows(p, v, vcfg)[0] * us).sum(), "cpu")
        errs = [((g - x).abs().max() / x.abs().max()).item() for g, x in zip(got, want)]
        log("kernels", f"render_rows_diff (cuda) vs dense autograd (cpu), aa={aa}: "
            f"err/max|grad| pos {errs[0]:.3e} vel {errs[1]:.3e} (bound 2e-4)")
        if not max(errs) < 2e-4:
            raise AssertionError("render_rows_diff disagrees with dense autograd")


def phase_small_reference() -> None:
    """The slice on the kernels (CUDA) against the dense path (CPU) at a
    small size, for 5 steps of each controller and sprite, batched and
    unbatched."""
    for controller, sprite in itertools.product(("gravity", "boids"), ("disc", "wireframe")):
        for num_envs in (None, 3):
            cfg = SimConfig(n=96, controller=controller,
                            vision=VisionConfig(width=48, sprite_mode=sprite))
            ref = Scene(dataclasses.replace(cfg, backend="dense"), device="cpu")
            s0 = ref.spawn(1) if num_envs is None else ref.spawn_envs(num_envs, 1)
            _, want = ref.rollout(s0, 5, record=("pos", "obs"))
            ker = Scene(cfg, device="cuda")
            s0c = dataclasses.replace(s0, pos=s0.pos.cuda(), vel=s0.vel.cuda(), t=s0.t.cuda())
            _, got = ker.rollout(s0c, 5, record=("pos", "obs"))
            torch.cuda.synchronize()
            # positions differ in the last bits (sums in another order), so
            # an eye-edge pixel may flip: bound the share of such pixels
            dpos = (got["pos"].cpu() - want["pos"]).abs().max().item()
            flips = ((got["obs"].cpu() - want["obs"]).abs() > 1e-3).double().mean().item()
            log("kernels", f"slice {controller} {sprite} envs={num_envs}: kernels(cuda) vs "
                f"dense(cpu) "
                f"5 steps max|dpos|={dpos:.2e} (bound 1e-3), obs pixels off by >1e-3: "
                f"{flips:.2e} (bound 1e-3)")
            if not (dpos < 1e-3 and flips < 1e-3):
                raise AssertionError(f"slice {controller} disagrees with the dense path")


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"expected {what}")


def finite_cuda(label, *tensors):
    for t in tensors:
        if not t.is_cuda or not torch.isfinite(t).all():
            raise AssertionError(f"{label}: output not finite or not on CUDA")


def phase_slice() -> dict:
    common.reset_launch_counts()
    t0 = time.perf_counter()
    scene = Scene(PRESETS["gravity-vision-1024"](), device="cuda")
    state, traj = scene.rollout(scene.spawn(0), 100, record=("obs",))
    finite_cuda("config 2", state.pos, state.vel, traj["obs"])
    expect(traj["obs"].shape == (100, 1024, 64), "config-2 obs [100, 1024, 64]")

    scene = Scene(PRESETS["boids-4096"](), device="cuda")
    state, traj = scene.rollout(scene.spawn(0), 20, record=("obs",))
    finite_cuda("config 3", state.pos, state.vel, traj["obs"])
    expect(traj["obs"].shape == (20, 4096, 256), "config-3 obs [20, 4096, 256]")

    scene = Scene(PRESETS["reference-100"](), device="cuda")
    state, traj = scene.rollout(scene.spawn(0), 100, record=("obs",))
    finite_cuda("reference-100", state.pos, state.vel, traj["obs"])
    expect(traj["obs"].shape == (100, 100, 1024), "reference-100 obs [100, 100, 1024]")

    scene = Scene(PRESETS["gravity-65536"](), device="cuda")
    state, traj = scene.rollout(scene.spawn(0), 3, record=("pos",))
    finite_cuda("config 4", state.pos, state.vel, traj["pos"])

    scene = Scene(PRESETS["envs-4096x256"](), device="cuda")
    batch = scene.step(scene.spawn_envs(4096, seed=0))
    obs = scene.observe(batch)
    finite_cuda("config 5", batch.pos, batch.vel, obs)
    expect(obs.shape == (4096, 256, 64), "config-5 obs [4096, 256, 64]")

    fn, (policy, pos, vel) = entry("cuda")
    for _ in range(10):
        pos, vel, obs, reward = fn(policy, pos, vel)
    finite_cuda("entry", pos, vel, obs, reward)
    expect(obs.shape == (1024, 66) and reward.shape == (1024,),
           "entry obs [1024, 66] and reward [1024]")
    torch.cuda.synchronize()
    counts = common.launch_counts()
    log("slice", f"configs 2, 3, 4, 5, reference-100 and entry() ran in "
        f"{time.perf_counter() - t0:.2f} s; launches {counts}")
    missing = [k for k in SERVING if counts[k] == 0]
    if missing:
        raise AssertionError(f"the serving path never launched {missing}")
    return counts


def phase_apg_routes() -> None:
    """APG with diff_vision (antialias, visibility reward, the CLI's default
    actuation) at config-5 width on fewer envs: the kernel route against
    backend='dense' (plain autograd) on the card, same seed. At horizon 1
    the parameter gradients must agree (bound 1e-3 of their norm: the eye's
    backward kernel against autograd, rtol 2e-4 per element in phase 3).
    At horizon 8 both grad norms are printed, not held to a bound: from
    horizon 2 on, this gradient is ill-conditioned in the inputs (PERF.md
    section 7: a 1e-6 relative change of the spawn moves it by factors),
    so a different summation order may too."""
    for horizon, envs in ((1, 16), (8, 4)):
        grads = {}
        for backend in ("pallas", "dense"):
            cfg = SimConfig(n=TRAIN_AGENTS, controller="gravity", backend=backend,
                            vision=VisionConfig(width=TRAIN_WIDTH, antialias=True))
            env = VisionEnv(cfg, reward_mode="visibility")
            ts = apg.init_apg_state(env, seed=0, device="cuda")
            apg.make_apg_step(env, horizon=horizon, num_envs=envs, diff_vision=True)(ts)
            grads[backend] = torch.cat([p.grad.flatten() for p in ts.policy.parameters()])
        got, want = grads["pallas"], grads["dense"]
        expect(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
               f"finite APG gradients at horizon {horizon}")
        rel = ((got - want).norm() / want.norm()).item()
        log("train", f"apg diff_vision {envs} x {TRAIN_AGENTS} x {TRAIN_WIDTH}, horizon "
            f"{horizon}: grad_norm kernels {got.norm().item():.6e}, dense "
            f"{want.norm().item():.6e}, |difference| / |dense| {rel:.3e}"
            + (" (bound 1e-3)" if horizon == 1 else " (no bound: ill-conditioned)"))
        if horizon == 1 and not rel < 1e-3:
            raise AssertionError("APG gradients: the kernel route disagrees with dense autograd")


class ParamWatch:
    """Snapshots the parameters of the first optimizer that steps inside the
    block, before that step (a global optimizer pre-hook), to tell whether
    the run moved them."""

    def __enter__(self):
        self.before = self.optimizer = None

        def pre_hook(optimizer, args, kwargs):
            if self.optimizer is None:
                self.optimizer = optimizer
                self.before = [p.detach().clone() for p in self._params()]

        self.handle = register_optimizer_step_pre_hook(pre_hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()

    def _params(self):
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def moved(self) -> float:
        if self.optimizer is None:
            return 0.0
        return max((p.detach() - b).abs().max().item()
                   for p, b in zip(self._params(), self.before))


def check_metrics(label: str, rows, iters: int, moved: float) -> None:
    expect(len(rows) == iters, f"{label}: {iters} metric lines")
    for row in rows:
        expect(all(math.isfinite(v) for v in row.values()), f"{label}: finite metrics {row}")
        if "grad_norm" in row:
            expect(row["grad_norm"] > 0, f"{label}: grad_norm > 0 {row}")
    expect(moved > 0, f"{label}: the parameters moved")
    log("train", f"{label}: parameters moved by up to {moved:.3e}; last {json.dumps(rows[-1])}")


def phase_train():
    """The training path at config-5 width; returns (each run's metric rows,
    the launch counts of the path)."""
    common.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runs = {}
    for algo in ("reinforce", "apg"):
        out = io.StringIO()
        with ParamWatch() as watch, contextlib.redirect_stdout(out):
            rc = cli.main(["train", "--algo", algo, "--envs", str(TRAIN_ENVS),
                           "--agents", str(TRAIN_AGENTS), "--vision-width", str(TRAIN_WIDTH),
                           "--horizon", str(TRAIN_HORIZON), "--iters", "3", "--seed", "0"])
        expect(rc == 0, f"train --algo {algo} exits 0")
        runs[algo] = [json.loads(line) for line in out.getvalue().splitlines()]
        check_metrics(f"train --algo {algo}", runs[algo], 3, watch.moved())

    env = VisionEnv(SimConfig(n=TRAIN_AGENTS, controller="gravity",
                              vision=VisionConfig(width=TRAIN_WIDTH, antialias=True)),
                    reward_mode="visibility")
    ts = apg.init_apg_state(env, seed=0, device="cuda")
    step = apg.make_apg_step(env, horizon=TRAIN_HORIZON, num_envs=TRAIN_ENVS, diff_vision=True)
    rows = []
    with ParamWatch() as watch:
        for i in range(2):
            t1 = time.perf_counter()
            ts, metrics = step(ts)
            row = {k: float(v) for k, v in metrics.items()}
            row.update(iter=i, sec=time.perf_counter() - t1,
                       agent_frames=TRAIN_ENVS * TRAIN_AGENTS * TRAIN_HORIZON)
            rows.append(row)
    runs["apg diff_vision"] = rows
    check_metrics("apg diff_vision (antialias, visibility)", rows, 2, watch.moved())
    torch.cuda.synchronize()
    counts = common.launch_counts()
    log("train", f"REINFORCE, APG and APG diff_vision at {TRAIN_ENVS} x {TRAIN_AGENTS} x "
        f"{TRAIN_WIDTH}, horizon {TRAIN_HORIZON}, ran in {time.perf_counter() - t0:.2f} s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"launches {counts}")
    missing = [k for k in TRAINING if counts[k] == 0]
    if missing:
        raise AssertionError(f"the training path never launched {missing}")
    return runs, counts


def wf_cfg(cfg: SimConfig, antialias: bool | None = None) -> SimConfig:
    """`cfg` with the exact wireframe sprite (and antialias, if given)."""
    aa = cfg.vision.antialias if antialias is None else antialias
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, sprite_mode="wireframe", antialias=aa))


def phase_wireframe_kernel(errors: Errors, gen) -> None:
    """wireframe_eye against its plain version at the paths' shapes, AA off
    and on, at the JAX suite's tolerance (rtol 1e-5, atol 2e-4,
    tests/test_wireframe_kernel.py); the kernel follows the plain division
    route op for op, so no pixel may flip between hit and miss, and the
    winner index must equal the plain argmin's wherever the depths differ.
    At the trainers' shape (4,096 envs) the plain version runs on the
    first and last 64 envs of the kernel's batch."""
    shapes = [(b, n, w, None) for b, n, w in WF_SHAPES]
    shapes.append((TRAIN_ENVS, TRAIN_AGENTS, TRAIN_WIDTH, (slice(0, 64), slice(-64, None))))
    for b, n, w, envs in shapes:
        shape = (b, n, 2) if b > 1 else (n, 2)
        pos = uniform(gen, shape, -100, 100)
        dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
        for aa in (False, True):
            vcfg = VisionConfig(width=w, antialias=aa, sprite_mode="wireframe")
            got = wireframe.wireframe_eye_with_winner(pos, dirs, pos, dirs, vcfg)
            parts = [slice(None)] if envs is None else list(envs)
            for part in parts:
                gs, gd, gw = (x[part] for x in got)
                ws, wd, ww = wireframe.wireframe_eye_plain(pos[part], dirs[part], pos[part],
                                                           dirs[part], vcfg)
                label = f"wireframe_eye B={b} N={n} W={w} aa={aa}" + (
                    "" if envs is None else f" envs[{part.start}:{part.stop}]")
                errors.check("wireframe_eye", label + " depth", gd, wd, 1e-5, 2e-4)
                errors.check("wireframe_eye", label + " shade", gs, ws, 1e-5, 2e-4)
                flips = int(((gd < vcfg.far) != (wd < vcfg.far)).sum())
                other = gw.long() != ww
                log("kernels", f"{label}: hit pixels {(wd < vcfg.far).double().mean().item():.3f}, "
                    f"flipped {flips} (bound 0), winners differing {int(other.sum())}, "
                    f"of them at differing depths {int((other & (gd != wd)).sum())} (bound 0)")
                if flips or (other & (gd != wd)).any():
                    raise AssertionError(f"{label}: flipped pixels or winners")


def phase_wireframe_grads() -> None:
    """RenderRowsWireframeDiff (kernel forward with the winner, winner
    pullback) on the card against autograd through the plain renderer on
    the card, same inputs, at 4 envs x 64 agents x 64 px, AA off and on:
    rtol 2e-4, atol 2e-4 of the largest component (per-pixel terms round
    apart; index_add_ sums targets in run-to-run order)."""
    gen = torch.Generator().manual_seed(4)
    pos0 = torch.rand((4, 64, 2), generator=gen) * 60 - 30
    vel0 = torch.rand((4, 64, 2), generator=gen) * 2 - 1
    us = torch.randn((4, 64, 64), generator=gen).cuda()
    ud = torch.randn((4, 64, 64), generator=gen).cuda() * 1e-3
    for aa in (False, True):
        vcfg = VisionConfig(width=64, antialias=aa, sprite_mode="wireframe")
        grads = []
        for fn in (lambda p, v: wireframe.render_rows_wireframe_tiled(p, v, vcfg),
                   lambda p, v: render.render_rows(p, v, vcfg)):
            p = pos0.cuda().requires_grad_()
            v = vel0.cuda().requires_grad_()
            shade, depth = fn(p, v)
            ((shade * us).sum() + (depth * ud).sum()).backward()
            grads.append((p.grad, v.grad))
        torch.cuda.synchronize()
        for name, g, x in zip(("pos", "vel"), *grads):
            scale = x.abs().max().item()
            err = (g - x).abs().max().item()
            log("kernels", f"RenderRowsWireframeDiff (cuda) vs plain autograd (cuda), aa={aa}, "
                f"d{name}: max_abs_err {err:.3e}, max|want| {scale:.3e} "
                f"(rtol 2e-4, atol 2e-4 max|want|)")
            expect(scale > 0 and bool(torch.isfinite(g).all()), f"finite nonzero d{name}")
            torch.testing.assert_close(g, x, rtol=2e-4, atol=2e-4 * scale)


def phase_wireframe_slice() -> dict:
    """Serving with the exact wireframe eye: Scene rollouts at config 2
    (N=1,024, W=64, gravity) and reference-100 (N=100, W=1,024, boids: the
    reference's own eye), launch counts read before and after."""
    common.reset_launch_counts()
    t0 = time.perf_counter()
    scene = Scene(wf_cfg(PRESETS["gravity-vision-1024"]()), device="cuda")
    state, traj = scene.rollout(scene.spawn(0), 100, record=("obs",))
    finite_cuda("config 2 wireframe", state.pos, state.vel, traj["obs"])
    expect(traj["obs"].shape == (100, 1024, 64), "config-2 wireframe obs [100, 1024, 64]")
    scene = Scene(wf_cfg(PRESETS["reference-100"]()), device="cuda")
    state, traj = scene.rollout(scene.spawn(0), 100, record=("obs",))
    finite_cuda("reference-100 wireframe", state.pos, state.vel, traj["obs"])
    expect(traj["obs"].shape == (100, 100, 1024), "reference-100 wireframe obs [100, 100, 1024]")
    expect(bool((traj["obs"] != scene.cfg.vision.background).any()), "sprites in view")
    torch.cuda.synchronize()
    counts = common.launch_counts()
    log("wireframe", f"config 2 and reference-100 wireframe rollouts ran in "
        f"{time.perf_counter() - t0:.2f} s; launches {counts}")
    missing = [k for k in WF_SERVING if counts[k] == 0]
    if missing:
        raise AssertionError(f"the wireframe serving path never launched {missing}")
    return counts


def phase_wireframe_train():
    """The trainers with wireframe observations at config-5 width, each
    with its launch counts read before and after: `train --algo reinforce
    --sprite-mode wireframe` of the CLI (3 iterations), then APG with
    diff_vision, antialias and the visibility reward (2 iterations).
    Returns (each run's metric rows, the summed launch counts)."""
    runs, total = {}, {k: 0 for k in KERNEL_INFO}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    common.reset_launch_counts()
    out = io.StringIO()
    with ParamWatch() as watch, contextlib.redirect_stdout(out):
        rc = cli.main(["train", "--algo", "reinforce", "--sprite-mode", "wireframe",
                       "--envs", str(TRAIN_ENVS), "--agents", str(TRAIN_AGENTS),
                       "--vision-width", str(TRAIN_WIDTH), "--horizon", str(TRAIN_HORIZON),
                       "--iters", "3", "--seed", "0"])
    expect(rc == 0, "train --algo reinforce --sprite-mode wireframe exits 0")
    runs["reinforce"] = [json.loads(line) for line in out.getvalue().splitlines()]
    check_metrics("train --algo reinforce --sprite-mode wireframe", runs["reinforce"], 3,
                  watch.moved())
    counts = [common.launch_counts()]

    common.reset_launch_counts()
    env = VisionEnv(wf_cfg(SimConfig(n=TRAIN_AGENTS, controller="gravity",
                                     vision=VisionConfig(width=TRAIN_WIDTH)), antialias=True),
                    reward_mode="visibility")
    ts = apg.init_apg_state(env, seed=0, device="cuda")
    step = apg.make_apg_step(env, horizon=TRAIN_HORIZON, num_envs=TRAIN_ENVS, diff_vision=True)
    rows = []
    with ParamWatch() as watch:
        for i in range(2):
            t1 = time.perf_counter()
            ts, metrics = step(ts)
            row = {k: float(v) for k, v in metrics.items()}
            row.update(iter=i, sec=time.perf_counter() - t1,
                       agent_frames=TRAIN_ENVS * TRAIN_AGENTS * TRAIN_HORIZON)
            rows.append(row)
    runs["apg diff_vision"] = rows
    check_metrics("wireframe apg diff_vision (antialias, visibility)", rows, 2, watch.moved())
    torch.cuda.synchronize()
    counts.append(common.launch_counts())
    for (label, needed), c in zip(WF_TRAINING.items(), counts):
        log("wireframe", f"{label} launches {c}")
        missing = [k for k in needed if c[k] == 0]
        if missing:
            raise AssertionError(f"the wireframe {label} path never launched {missing}")
        for k in total:
            total[k] += c[k]
    log("wireframe", f"wireframe REINFORCE and APG diff_vision at {TRAIN_ENVS} x "
        f"{TRAIN_AGENTS} x {TRAIN_WIDTH}, horizon {TRAIN_HORIZON}, ran in "
        f"{time.perf_counter() - t0:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return runs, total


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: float, moved: int):
    """(bound ms, what bounds it): the larger of the operations over the
    fp32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def env_chunks(fn):
    """Sum `fn(pos, dirs, vcfg)` over chunks of 128 envs of a batch."""
    def summed(pos, dirs, vcfg) -> int:
        if pos.dim() == 2:
            return fn(pos, dirs, vcfg)
        return sum(fn(pos[i:i + 128], dirs[i:i + 128], vcfg) for i in range(0, len(pos), 128))
    return summed


@env_chunks
def disc_covered(pos, dirs, vcfg) -> int:
    """(eye, target, pixel) triples of a self-render where the disc covers
    the pixel: the pixel work this input needs."""
    u, du, _, visible = camera.project(pos[..., None, :, :] - pos[..., :, None, :], dirs, vcfg)
    u_p = camera.pixel_centers(vcfg, device=pos.device)
    reach = du + (1.0 / vcfg.width if vcfg.antialias else 0.0)
    return int((visible[..., None] & ((u_p - u[..., None]).abs() < reach[..., None])).sum())


@env_chunks
def wireframe_covered(pos, dirs, vcfg) -> int:
    """(eye, target, pixel) triples of a self-render where the sprite's
    near/far-clipped u-interval, widened by half a pixel, covers the pixel:
    the pixels whose 3 edges this input needs evaluated."""
    f, l, live = render.sprite_view(pos[..., :, None, :], dirs[..., :, None, :],
                                    pos[..., None, :, :], dirs[..., None, :, :], vcfg)
    aa = dataclasses.replace(vcfg, antialias=True)
    u0 = torch.zeros((), device=pos.device)
    lo = hi = None
    for a, b in render.SPRITE_EDGES:
        _, _, e_lo, e_hi = render.edge_fragment(f[a], l[a], f[b], l[b], live, u0, aa)
        lo = e_lo if lo is None else torch.minimum(lo, e_lo)
        hi = e_hi if hi is None else torch.maximum(hi, e_hi)
    u_p, hp = camera.pixel_centers(vcfg, device=pos.device), 1.0 / vcfg.width
    return int(((hi[..., None] > u_p - hp) & (lo[..., None] < u_p + hp)).sum())


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def alternate(plain, kernel, iters_plain: int, iters_kernel: int):
    """(plain ms, kernel ms), each the mean of two runs in the order plain,
    kernel, kernel, plain."""
    p1 = cuda_ms(plain, iters_plain)
    k1 = cuda_ms(kernel, iters_kernel)
    k2 = cuda_ms(kernel, iters_kernel)
    p2 = cuda_ms(plain, iters_plain)
    return (p1 + p2) / 2, (k1 + k2) / 2


def phase_times(gen, card: str) -> dict:
    times = {}
    n = 65536
    pos = uniform(gen, (n, 2), -100, 100)
    vel = uniform(gen, (n, 2), -1, 1)
    gcfg, bcfg = GravityConfig(), BoidsConfig()
    p_ms, k_ms = alternate(lambda: pairwise.gravity_forces_plain(pos, gcfg),
                           lambda: pairwise.gravity_forces_tiled(pos, gcfg), 2, 5)
    times["gravity"] = (k_ms, p_ms, *bound(n * n * GRAVITY_OPS, 2 * nbytes(pos)))
    log("times", f"gravity N=65536: kernel {k_ms:.3f} ms = {n * n / k_ms * 1e3:.4e} pair evals/s; "
        f"plain {p_ms:.3f} ms = {n * n / p_ms * 1e3:.4e} pair evals/s [{card}]")
    p_ms, k_ms = alternate(lambda: boids_ops.boids_velocity_plain(pos, vel, bcfg),
                           lambda: boids_ops.boids_velocity_tiled(pos, vel, bcfg), 1, 5)
    log("times", f"boids N=65536: kernel {k_ms:.3f} ms = {n * n / k_ms * 1e3:.4e} pair evals/s; "
        f"plain {p_ms:.3f} ms = {n * n / p_ms * 1e3:.4e} pair evals/s [{card}]")
    pos4 = uniform(gen, (4096, 2), -100, 100)
    vel4 = uniform(gen, (4096, 2), -1, 1)
    p4, k4 = alternate(lambda: boids_ops.boids_velocity_plain(pos4, vel4, bcfg),
                       lambda: boids_ops.boids_velocity_tiled(pos4, vel4, bcfg), 3, 20)
    times["boids"] = (k4, p4, *bound(4096 * 4096 * BOIDS_OPS, nbytes(pos4, vel4, vel4)))
    log("times", f"boids N=4096 (config 3): kernel {k4:.3f} ms; plain {p4:.3f} ms [{card}]")

    for b, n_e, w in EYE_SHAPES:
        shape = (b, n_e, 2) if b > 1 else (n_e, 2)
        epos = uniform(gen, shape, -100, 100)
        dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
        for aa in (False, True):
            vcfg = VisionConfig(width=w, antialias=aa)
            p_ms, k_ms = alternate(lambda: raycast.disc_eye_plain(epos, dirs, epos, vcfg),
                                   lambda: raycast.disc_eye(epos, dirs, epos, vcfg), 2, 10)
            frames = b * n_e
            if (b, n_e, w, aa) == (1, 1024, 64, False):
                ops = (b * n_e * n_e * DISC_PAIR_OPS
                       + disc_covered(epos, dirs, vcfg) * DISC_PIXEL_OPS)
                times["disc_eye"] = (k_ms, p_ms, *bound(ops, nbytes(epos, dirs)
                                                         + 2 * b * n_e * w * 4))
            log("times", f"disc_eye B={b} N={n_e} W={w} aa={aa}: kernel {k_ms:.3f} ms = "
                f"{frames / k_ms * 1e3:.4e} agent-frames/s; plain {p_ms:.3f} ms = "
                f"{frames / p_ms * 1e3:.4e} agent-frames/s [{card}]")

    # the backward kernels against their plain versions
    u = torch.randn((n, 2), generator=gen, device="cuda")
    p_ms, k_ms = alternate(lambda: pairwise.gravity_vjp_plain(pos, u, gcfg),
                           lambda: pairwise.gravity_vjp_tiled(pos, u, gcfg), 2, 5)
    times["gravity_vjp"] = (k_ms, p_ms, *bound(n * n * GRAVITY_VJP_OPS, nbytes(pos, u, u)))
    log("times", f"gravity_vjp N=65536: kernel {k_ms:.3f} ms = {n * n / k_ms * 1e3:.4e} pair "
        f"evals/s; plain {p_ms:.3f} ms = {n * n / p_ms * 1e3:.4e} pair evals/s [{card}]")
    for b, n_e, w in ((1, 1024, 64), (64, 256, 64)):
        shape = (b, n_e, 2) if b > 1 else (n_e, 2)
        epos = uniform(gen, shape, -100, 100)
        dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
        us = torch.randn(shape[:-1] + (w,), generator=gen, device="cuda")
        ud = torch.randn(shape[:-1] + (w,), generator=gen, device="cuda") * 1e-3
        for aa in (False, True):
            vcfg = VisionConfig(width=w, antialias=aa)
            _, _, winner = raycast.disc_eye_with_winner(epos, dirs, epos, vcfg)
            p_ms, k_ms = alternate(
                lambda: raycast.render_rows_vjp_cross_plain(epos, dirs, us, ud, vcfg),
                lambda: raycast.render_rows_vjp_cross(epos, dirs, winner, us, ud, vcfg), 2, 10)
            if (b, n_e, w, aa) == (1, 1024, 64, False):
                ops = int((winner >= 0).sum()) * DISC_BWD_PIXEL_OPS
                times["disc_eye_bwd"] = (k_ms, p_ms, *bound(
                    ops, nbytes(epos, dirs, winner, us, ud) + 3 * nbytes(epos)))
            log("times", f"disc_eye_bwd B={b} N={n_e} W={w} aa={aa}: kernel {k_ms:.3f} ms = "
                f"{b * n_e / k_ms * 1e3:.4e} agent-frames/s; plain (autograd through the "
                f"plain renderer) {p_ms:.3f} ms [{card}]")
    # what writing the winner index costs the forward, at the trainers' shape
    shape = (TRAIN_ENVS, TRAIN_AGENTS, 2)
    epos = uniform(gen, shape, -100, 100)
    dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
    for aa in (False, True):
        vcfg = VisionConfig(width=TRAIN_WIDTH, antialias=aa)
        bare, with_winner = alternate(
            lambda: raycast.disc_eye(epos, dirs, epos, vcfg),
            lambda: raycast.disc_eye_with_winner(epos, dirs, epos, vcfg), 5, 5)
        log("times", f"disc_eye {TRAIN_ENVS} x {TRAIN_AGENTS} x {TRAIN_WIDTH} aa={aa}: "
            f"without the winner index {bare:.3f} ms, writing it {with_winner:.3f} ms "
            f"({with_winner / bare - 1:+.2%}) [{card}]")

    # the wireframe eye against its plain version, and its bound, at the
    # phase-3 shapes; at the trainers' shape the kernel alone, with and
    # without its winner index
    for b, n_e, w in WF_SHAPES + [(TRAIN_ENVS, TRAIN_AGENTS, TRAIN_WIDTH)]:
        shape = (b, n_e, 2) if b > 1 else (n_e, 2)
        epos = uniform(gen, shape, -100, 100)
        dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
        for aa in (False, True):
            vcfg = VisionConfig(width=w, antialias=aa, sprite_mode="wireframe")
            ops = (b * n_e * n_e * (WF_PAIR_AA_OPS if aa else WF_PAIR_OPS)
                   + wireframe_covered(epos, dirs, vcfg) * 3 * WF_EDGE_OPS)
            b_ms, b_by = bound(ops, nbytes(epos, dirs) + 2 * b * n_e * w * 4)
            frames = b * n_e
            if b == TRAIN_ENVS:
                k_ms, with_winner = alternate(
                    lambda: wireframe.wireframe_eye(epos, dirs, epos, dirs, vcfg),
                    lambda: wireframe.wireframe_eye_with_winner(epos, dirs, epos, dirs, vcfg),
                    3, 3)
                log("times", f"wireframe_eye {b} x {n_e} x {w} aa={aa}: kernel {k_ms:.3f} ms = "
                    f"{frames / k_ms * 1e3:.4e} agent-frames/s, writing the winner index "
                    f"{with_winner:.3f} ms; bound {b_ms:.4f} ms ({b_by}) [{card}]")
                continue
            p_ms, k_ms = alternate(lambda: wireframe.wireframe_eye_plain(epos, dirs, epos, dirs,
                                                                         vcfg),
                                   lambda: wireframe.wireframe_eye(epos, dirs, epos, dirs, vcfg),
                                   2, 10)
            if (b, n_e, w, aa) == (1, 1024, 64, False):
                times["wireframe_eye"] = (k_ms, p_ms, b_ms, b_by)
            log("times", f"wireframe_eye B={b} N={n_e} W={w} aa={aa}: kernel {k_ms:.3f} ms = "
                f"{frames / k_ms * 1e3:.4e} agent-frames/s; plain {p_ms:.3f} ms = "
                f"{frames / p_ms * 1e3:.4e} agent-frames/s; bound {b_ms:.4f} ms ({b_by}) "
                f"[{card}]")

    # steps/s of the rollouts and of entry(): kernels vs dense, on the card
    def rollout_rate(backend: str, preset: str = "gravity-vision-1024",
                     sprite: str = "disc") -> float:
        cfg = dataclasses.replace(PRESETS[preset](), backend=backend)
        scene = Scene(cfg if sprite == "disc" else wf_cfg(cfg), device="cuda")
        state = scene.spawn(0)
        scene.rollout(state, 2, record=("obs",))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene.rollout(state, 50, record=("obs",))
        torch.cuda.synchronize()
        return 50 / (time.perf_counter() - t0)

    def entry_rate(backend: str) -> float:
        cfg = dataclasses.replace(PRESETS["gravity-vision-1024"](), backend=backend)
        fn, (policy, pos, vel) = entry("cuda", cfg=cfg)
        fn(policy, pos, vel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            pos, vel, _, _ = fn(policy, pos, vel)
        torch.cuda.synchronize()
        return 50 / (time.perf_counter() - t0)

    for name, rate in (
            ("config-2 rollout (record obs)", rollout_rate),
            ("config-2 wireframe rollout (record obs)",
             lambda be: rollout_rate(be, sprite="wireframe")),
            ("reference-100 wireframe rollout (record obs)",
             lambda be: rollout_rate(be, "reference-100", "wireframe")),
            ("entry() step", entry_rate)):
        d1, k1, k2, d2 = rate("dense"), rate("pallas"), rate("pallas"), rate("dense")
        log("times", f"{name}: kernels {(k1 + k2) / 2:.2f} steps/s; dense "
            f"{(d1 + d2) / 2:.2f} steps/s [{card}]")
    return times


def log_train_times(runs: dict, card: str, prefix: str = "") -> None:
    """Seconds per training iteration (host clock; each iteration ends when
    its metrics reach the host) and agent-frames/s, first iteration (build
    and warm-up) left out."""
    for label, rows in runs.items():
        label = prefix + label
        secs = [row["sec"] for row in rows[1:]]
        sec = sum(secs) / len(secs)
        log("times", f"train {label} at {TRAIN_ENVS} x {TRAIN_AGENTS} x {TRAIN_WIDTH}, horizon "
            f"{TRAIN_HORIZON}: {sec:.4f} s/iteration ({', '.join(f'{x:.4f}' for x in secs)}) = "
            f"{rows[0]['agent_frames'] / sec:.4e} agent-frames/s; first iteration "
            f"{rows[0]['sec']:.4f} s [{card}]")


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{kind}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}; nvidia-smi: {smi}")

    lib = common.kernel_library()
    log("build", f"{lib.path.name} built in {lib.build_seconds:.1f} s")
    for line in lib.ptxas_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log("build", line.strip())

    gen = torch.Generator(device="cuda").manual_seed(0)
    errors = Errors()
    with torch.no_grad():
        phase_kernels(errors, gen)
        phase_backward_kernels(errors, gen)
        phase_wireframe_kernel(errors, gen)
        phase_small_reference()
    phase_grad_reference()
    phase_wireframe_grads()
    with torch.no_grad():
        paths = [phase_slice(), phase_wireframe_slice()]
    phase_apg_routes()
    runs, training = phase_train()
    wf_runs, wf_training = phase_wireframe_train()
    paths += [training, wf_training]
    with torch.no_grad():
        times = phase_times(gen, smi)
    log_train_times(runs, smi)
    log_train_times(wf_runs, smi, prefix="wireframe ")

    log("done", f"all phases ran in {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, info in KERNEL_INFO.items():
        k_ms, p_ms, b_ms, b_by = times[name]
        kernels.append({"name": name, "route": "cuda", **info,
                        "launches": sum(counts[name] for counts in paths),
                        "max_abs_err": errors.max_abs[name], "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
