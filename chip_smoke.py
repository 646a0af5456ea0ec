#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nenbody_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is non-zero):
  1. device   — the card's name and power limit; TF32 off.
  2. build    — nvcc builds the eleven kernels from the eight sources in
                nenbody_tpu_torch/csrc (boids.cu holds the fused rules and
                the ring's partials) into build/nenbody_tpu_torch/ (one
                nvcc per source, all at once); ptxas reports registers,
                shared memory and spills.
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the main paths' shapes (the backward kernels and the
                wireframe eye also at the trainers'), with the tolerance
                stated (the disc eye and the wireframe eye equal to it at
                power-of-two widths, spread and clustered, the wireframe
                eye also at rows cut into segments, on sprites straddling
                the near plane and on edges along a pixel's ray; gravity's
                split sum and batch 20 more times bit-identical; boids at
                each N where its launch plan changes T, R or S, the
                kernel's plan equal to boids_plan); the autograd Functions' gradients on the card
                against plain autograd; the ring's kernels (the boids
                partials at 16,384 x 16,384, the gravity VJP's cross form
                against float64, the wireframe backward at the eye's shapes
                and split into 4 ring hops); the gravity VJP's and the
                partials' plans (nbt_gravity_vjp_plan,
                nbt_boids_partials_plan) equal to their twins at the path
                shapes, and each form of both 20 more times bit-identical.
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
                and after. Runs with autograd on. Then the other trainers
                through the CLI at config-5 width, 3 iterations each:
                `--algo ppo`, `--algo ppo --critic central`, `--algo ac`,
                `--algo es --population 8`, `--algo reinforce-gru` and
                `--algo reinforce --net conv` (all at the full 4,096 envs:
                the conv run's peak is about 53 GiB, PERF.md), each with
                its peak device memory and its launch counts read just
                before and after (gravity and disc_eye each launched).
     cli      — the CLI's simulation and data surface through cli.main at
                the BASELINE shapes, each command's launch counts set to 0
                just before it and read just after: `run` at config 4
                with checkpoints and a resume that continues t (gravity),
                config 3 with --record (boids; 4 frames through the
                native host library, built with g++), config 2 plain and under a trained policy; `train
                --algo reinforce` at config-5 width, 2 iterations +
                --checkpoint + --resume 1 against 3 uninterrupted (equal
                params, else the difference beside two uninterrupted
                runs'); `eval --policy`; `datagen` at BASELINE config 5
                (2 shards, agent-frames/s with and without the writes,
                chunk 1's host copy overlapping chunk 2's compute on the
                card's timeline); `bc` on those shards; `export --check` at
                config-5 width, its step bit-equal to the live step and
                timed against it (gravity and disc_eye launched by train,
                eval, datagen and export).
     viewer   — the viewer through the CLI and the Scene, each part's launch
                counts set to 0 just before it and read just after: `gif`
                at BASELINE config 3 (boids N=4,096, 256 px) and at config
                2 with --first-person (GIF89a header, frame count, size,
                delay, loop), ms per config-3 GIF frame (compose, encode);
                `run --capture 10 --first-person --record` at config 2,
                each PNG decoded (viz.image.read_png) and equal to the
                frame composed again from the recorded state, `replay` of
                the recording; render_eye_view's row (render_eye_row)
                against the plain render_single_row on the card (disc at
                config 3, 480 and 512 px, wireframe at reference-100, 1,024
                px with AA; bare, colors, texture; bit-equal at 512 and
                1,024 without a texture), one launch of the eye kernel a
                channel; the call's time against its kernel's; run_live's
                whole loop at config 2 under a pyplot stub (StubPlt).
     cells    — Scene(backend="cells") at config 3 and at N=65,536, the
                capacity sized by cells_stats, each step from a shared
                state within RING_BOIDS_BOUND of backend="pallas"
                (boids.cu); the step's time against boids.cu's and its
                peak memory; its observe launches the disc eye.
     wireframe —the exact wireframe eye's paths, each with its launch
                counts read before and after: Scene rollouts with
                sprite_mode='wireframe' at config 2 and reference-100, then
                `train --algo reinforce --sprite-mode wireframe` of the CLI
                and APG with diff_vision (antialias, visibility) at
                config-5 width (its backward now the wireframe backward
                kernel).
     ring     — the agent-axis ring (nenbody_tpu_torch.parallel) at full
                width on a mesh that names cuda:0 4 times, each part held
                against the one-device result: ring gravity at config 4,
                ring boids at N=65,536, ring_render_rows (disc, wireframe)
                at config 2; Scene(backend="ring") rollouts at configs 2
                and 3 on default_mesh(); `train --mesh auto` of the CLI;
                REINFORCE and APG diff_vision (wireframe, disc) at config-5
                width on a {"data": 2, "agents": 2} mesh of cuda:0, horizon
                8, and APG's parameter gradients at horizon 1 on that mesh
                against one device's; the launch counts set to 0 just
                before each ring call and read just after it, peak device
                memory.
     rdma     — the RDMA ring (nenbody_tpu_torch.parallel.rdma, one launch
                per card walking every hop) on the same 4-shard mesh:
                gravity at config 4 and at config-5 width, boids at
                N=65,536, disc rows at config 2 and at config-5 width, each
                spread and clustered (U(-8, 8)), each
                against its plain version, the per-hop ring and one device,
                then 20 more launches bit-identical; the launch counts set
                to 0 just before each call and read just after (one launch
                of the call's kernel, nothing else).
     appearance — per-target albedo and skin textures: each eye kernel's
                albedo, texture and albedo+texture forms against their plain
                versions at the eyes' shapes, AA off and on, and the
                wireframe backward's albedo and texture cotangents against
                winner_pullback (at config-5 width the texture's sum also
                as near float64 as the plain version's); then the paths,
                each with the launch counts set to 0 just before it and read
                just after: Scene.observe_textured at config-5 width (4,096
                x 256 x 64), both sprites; Scene.observe_rgb with
                default_agent_colors at config 2, both sprites;
                ring_render_rows(texture=) at config 2 on 4 shards of cuda:0
                against one device; one gradient through
                render_rows_wireframe_diff(albedo=, texture=) at config-5
                width (antialias) with finite, nonzero d pos, d vel,
                d albedo and d texture.
  5. times    — CUDA-event times of each kernel and its plain version,
                alternated (plain, kernel, kernel, plain), gravity, the
                disc eye, the wireframe eye and boids at each shape of the
                main paths with its bound (GRAVITY_TIME_SHAPES,
                DISC_TIME_SHAPES, WF_TIME_SHAPES, BOIDS_TIME_SHAPES: spread
                and clustered, AA off and on), the gravity VJP (self and
                cross forms) and the boids partials at VJP_TIME_SHAPES and
                PARTIALS_TIME_SHAPES, the two eye backward
                kernels' device times (graph_ms) at DISC_BWD_TIME_SHAPES
                and WF_BWD_TIME_SHAPES (AA off and on, the wireframe's
                also with a texture), the share of pairs the
                wireframe eye's frustum test keeps and its mean pixel range
                per kept sprite, the eyes with and
                without their winner index, steps/s of the config-2 rollout
                (both sprites), reference-100 (wireframe) and entry(), ms
                per Scene step + observe at configs 2-5 and reference-100
                and of Scene(backend="ring") at config 3 on default_mesh(), the
                ring's kernels and the ring path against one device, the
                RDMA kernels' device time (torch.profiler) beside the RDMA
                call, the per-hop ring and one device (the eye's rows also
                clustered, with the row bytes its hops move; gravity with
                its launch plan T, R, P and units, checked against the
                kernel's nbt_rdma_gravity_plan, and its registers), each eye kernel's
                appearance forms against their plain versions,
                Scene.observe_textured against observe at config-5 width,
                and seconds per training iteration and agent-frames/s of
                each trainer.
The line before the last is a JSON object with one entry per kernel
(`launches` sums the paths' counts; `bound_ms` is the larger of the
operations over the card's fp32 peak and the bytes over its memory rate,
for the inputs timed; `library_ms` is null: no single PyTorch call computes
any of these functions; the three eye kernels carry their appearance
forms' times and bounds under `forms`, gravity and the disc eye their
per-shape ms, plain_ms and bound_ms under `shapes`, as do the wireframe
eye, boids, the gravity VJP, the boids partials and the two eye backward
kernels, whose `ms` is a host loop of 10 calls, wrapper time included,
while `shapes` holds device times);
the last line is {"ok": true, "device": {...}}.
`python3 chip_smoke.py --rdma-cards N` runs the RDMA phases alone with one
shard on each of N cards; `--kernel-times [GROUP ...]` the device timings
of phase 5 and the serving steps alone, or only the GROUPs named (of
TIME_GROUPS), with another checkout first on sys.path its kernels under
the same harness. Imports no jax.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import itertools
import json
import math
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.optim.optimizer import register_optimizer_step_pre_hook
from torch.profiler import ProfilerActivity, profile

from nenbody_tpu_torch import PRESETS, Scene, SimConfig, VisionConfig, cli
from nenbody_tpu_torch.config import BoidsConfig, GravityConfig
from nenbody_tpu_torch.entry import entry
from nenbody_tpu_torch.ops import boids as boids_ops
from nenbody_tpu_torch.ops import common, pairwise, raycast, wireframe
from nenbody_tpu_torch.parallel import default_mesh, make_mesh, rdma, ring
from nenbody_tpu_torch.physics import dense
from nenbody_tpu_torch.rl import apg, train
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.vision import camera, render
from nenbody_tpu_torch.viz import image, live
from nenbody_tpu_torch.viz import viewer as viewer_lib

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
    "boids_partials": dict(source="nenbody_tpu_torch/csrc/boids.cu",
                           replaces="nenbody_tpu/ops/boids.py:119"),
    "wireframe_eye_bwd": dict(source="nenbody_tpu_torch/csrc/wireframe_eye_bwd.cu",
                              replaces="nenbody_tpu/ops/wireframe.py:2424",
                              also_replaces="nenbody_tpu/ops/wireframe.py:2024"),
    "rdma_gravity": dict(source="nenbody_tpu_torch/csrc/rdma_ring.cu",
                         replaces="nenbody_tpu/parallel/rdma.py:94"),
    "rdma_boids": dict(source="nenbody_tpu_torch/csrc/rdma_ring.cu",
                       replaces="nenbody_tpu/parallel/rdma.py:271"),
    "rdma_vision": dict(source="nenbody_tpu_torch/csrc/rdma_ring.cu",
                        replaces="nenbody_tpu/parallel/rdma.py:475"),
}
EYE_SHAPES = [(1, 1024, 64), (1, 100, 1024), (1, 4096, 256), (64, 256, 64)]
WF_SHAPES = [(1, 1024, 64), (1, 100, 1024), (1, 1024, 1024), (64, 256, 64)]
SERVING = ("gravity", "boids", "disc_eye")
# phase 5's shapes of the serving path's gravity (envs, N) and disc eye
# (label, envs, N, W, spawn half-range: U(-8, 8) is a swarm after a long
# gravity collapse, where every target reaches every pixel), and the
# serving steps timed (label, preset, steps per run, envs)
GRAVITY_TIME_SHAPES = [(1, 1024), (1, 65536), (4096, 256)]
DISC_TIME_SHAPES = [("config 2", 1, 1024, 64, 100), ("reference-100", 1, 100, 1024, 100),
                    ("config 3", 1, 4096, 256, 100), ("64 envs", 64, 256, 64, 100),
                    ("config-5 width", 4096, 256, 64, 100),
                    ("config 2 clustered", 1, 1024, 64, 8),
                    ("config-5 width clustered", 4096, 256, 64, 8)]
# phase 5's shapes of the wireframe eye (label, envs, N, W, spawn half-range;
# each spread and clustered) and of boids (label, envs, N, half-range)
WF_TIME_SHAPES = [(label, b, n, w, half)
                  for label, b, n, w in (("config 2", 1, 1024, 64),
                                         ("reference-100", 1, 100, 1024),
                                         ("N=1,024 W=1,024", 1, 1024, 1024),
                                         ("64 envs", 64, 256, 64),
                                         ("config-5 width", 4096, 256, 64))
                  for half in (100, 8)]
BOIDS_TIME_SHAPES = [("reference-100", 1, 100, 100), ("config 3", 1, 4096, 100),
                     ("config 3 clustered", 1, 4096, 8), ("config 4", 1, 65536, 100),
                     ("64 envs", 64, 256, 100)]
# phase 5's shapes of the gravity VJP (label, envs, N, M; M None for the self
# form) and of the boids partials (label, envs, N, M, the hop-0 form: the
# shard against its own block, the diagonal masked)
VJP_TIME_SHAPES = [("config 4", 1, 65536, None), ("APG at config-5 width", 4096, 256, None),
                   ("2 x 2 mesh shard", 2048, 128, None),
                   ("ring hop at config 4 on 4 shards", 1, 16384, 16384),
                   ("2 x 2 mesh hop", 2048, 128, 128)]
PARTIALS_TIME_SHAPES = [("ring hop at N=65,536 on 4 shards", 1, 16384, 16384, True),
                        ("the same, another block", 1, 16384, 16384, False),
                        ("ring Scene at config 3 on one card", 1, 4096, 4096, True),
                        ("config 3 on 4 shards", 1, 1024, 1024, True)]
# what `--kernel-times GROUP ...` may name
TIME_GROUPS = ("gravity", "disc_eye", "wireframe_eye", "boids", "gravity_vjp", "boids_partials",
               "backward", "serving", "rdma")
# phase 5's shapes of the backward kernels (label, envs, N, W): each AA off
# and on, the wireframe's trainers' shape also with a texture; reference-100
# is the wide row, where the grid's segments of a row (GRID_WARPS) bind
WF_BWD_TIME_SHAPES = [("config 2", 1, 1024, 64), ("reference-100", 1, 100, 1024),
                      ("config-5 width", 4096, 256, 64)]
DISC_BWD_TIME_SHAPES = [("config 2", 1, 1024, 64), ("reference-100", 1, 100, 1024),
                        ("64 envs", 64, 256, 64), ("config-5 width", 4096, 256, 64)]
SERVING_STEPS = [("config 2", "gravity-vision-1024", 50, None, "disc"),
                 ("config 3", "boids-4096", 20, None, "disc"),
                 ("config 3 ring (default_mesh())", "boids-4096", 20, None, "ring"),
                 ("config 4", "gravity-65536", 10, None, "disc"),
                 ("config 5", "envs-4096x256", 5, 4096, "disc"),
                 ("reference-100", "reference-100", 50, None, "disc"),
                 ("config 2 wireframe", "gravity-vision-1024", 50, None, "wireframe"),
                 ("reference-100 wireframe", "reference-100", 50, None, "wireframe")]
TRAINING = ("gravity", "disc_eye", "gravity_vjp", "disc_eye_bwd")
# the other trainers' CLI runs at config-5 width; each launches MORE_TRAINING
MORE_TRAINERS = ("--algo ppo", "--algo ppo --critic central", "--algo ac",
                 "--algo es --population 8", "--algo reinforce-gru",
                 "--algo reinforce --net conv")
MORE_TRAINING = ("gravity", "disc_eye")
WF_SERVING = ("gravity", "boids", "wireframe_eye")
WF_TRAINING = {"reinforce": ("gravity", "wireframe_eye"),
               "apg diff_vision": ("gravity", "gravity_vjp", "wireframe_eye",
                                   "wireframe_eye_bwd")}
RING = {"physics and rows": ("gravity", "boids_partials", "disc_eye", "wireframe_eye"),
        "scene": ("gravity", "boids_partials", "disc_eye"),
        "train --mesh auto": ("gravity", "disc_eye"),
        "reinforce 2x2": ("gravity", "disc_eye"),
        "apg diff_vision wireframe 2x2": ("gravity", "gravity_vjp", "wireframe_eye",
                                          "wireframe_eye_bwd"),
        "apg diff_vision disc 2x2": ("gravity", "gravity_vjp", "disc_eye", "disc_eye_bwd")}
# The ring against one device, each bound a small multiple of the reading on
# the card (PERF.md section 5) and far below what a dropped hop (a quarter
# of the sum at 4 shards) or a hop rounded to bfloat16 (2^-9 of its partial)
# would give: ring gravity and boids (err / max|one device|), the Scene
# rollouts (max|dpos| and the share of obs pixels off by > 1e-3), the
# trainers' first loss (relative) and APG's gradients at horizon 1
# (|difference| / |one device|).
RING_GRAVITY_BOUND, RING_BOIDS_BOUND = 1e-4, 1e-5
RING_SCENE_DPOS, RING_SCENE_PIXELS = 1e-5, 1e-4
RING_LOSS_RTOL, RING_GRAD_BOUND = 1e-5, 1e-3
# The RDMA ring: each call one launch per card, of its own kernel alone
RDMA_KERNEL = {"gravity": "rdma_gravity", "boids": "rdma_boids", "rows": "rdma_vision"}
RDMA_REPEATS = 20  # launches that must give the same bits as the first
PROFILE_TRACES = 3  # torch.profiler traces kernel_device_ms may take for one timing
# the wireframe APG diff_vision iteration with the plain pullback (PERF.md
# section 5, profile_train: NVIDIA H100 80GB HBM3, 700.00 W)
WF_DIFF_PLAIN_SEC = 2.6347
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
# the wireframe pullback per live pixel, with antialias: the 3-edge
# re-evaluation with the slab clips, u-intervals, union span and coverage
# (about 150 operations) and its reverse sweep (about twice that); without:
# the 3 edge tests (3 WF_EDGE_OPS), the merge and the shade (about 50) and
# its reverse sweep (about twice that)
WF_BWD_PIXEL_OPS, WF_BWD_PIXEL_OPS_NOAA = 450, 150
# the appearance per shaded pixel: the bilinear sample (about 20
# operations; 3 times that in the pullback, as above) and the albedo's product
TEX_SAMPLE_OPS, ALBEDO_OPS = 20, 1
# the appearance forms, and the eyes' tolerance with a texture
# (tests/test_texture_kernel.py: the sample's texel picks are threshold
# tests on the winner's uv)
FORMS = ("albedo", "texture", "albedo+texture")
TEX_RTOL, TEX_ATOL = 1e-5, 3e-4
# the viewer phase: the first-person viewport widths of render_eye_view
# (config 3's disc eye, reference-100's wireframe eye with AA), and the
# keys run_live's loop takes under the pyplot stub (select, first person
# on, capture, first person off, quit)
EYE_VIEW_CASES = [("config 3 disc", "boids-4096", "disc", False, 480),
                  ("config 3 disc", "boids-4096", "disc", False, 512),
                  ("reference-100 wireframe", "reference-100", "wireframe", True, 1024)]
LIVE_KEYS = ("]", "v", "c", "v", "escape")
# the cells phase: Scene(backend="cells") against backend="pallas" (boids.cu)
# at config 3 and at N=65,536, steps held from shared states
CELLS_SHAPES = [("config 3", 4096), ("N=65,536", 65536)]
CELLS_STEPS = 3
# the wireframe backward's texture gradient (a sum over every pixel of
# every env) against its plain version, normalised by its largest texel:
# the sums run in another (atomic) order
TEX_GRAD_BOUND = 1e-4


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo


class Errors:
    """The largest absolute error each kernel showed against its plain
    version in phase 3."""

    def __init__(self):
        self.max_abs = {k: 0.0 for k in KERNEL_INFO}
        self.witnessed = 0  # elements the float64 witness held, over the run

    def check(self, kernel, label, got, want, rtol, atol, witness=None):
        """Every element within rtol/atol, or, with `witness`, every element
        beyond it vouched for by `witness(label, bad, got, want)`."""
        torch.cuda.synchronize()
        got, want = got.double(), want.double()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{label}: shape {tuple(got.shape)} or non-finite output")
        diff = (got - want).abs()
        bad = diff > atol + rtol * want.abs()
        err = diff.max().item()
        self.max_abs[kernel] = max(self.max_abs[kernel], err)
        differing = (diff > 0).double().mean().item()
        beyond = bad.double().mean().item()
        log("kernels", f"{label}: max_abs_err={err:.3e} differing={differing:.2e} "
            f"beyond_tol={beyond:.2e} (rtol={rtol}, atol={atol})")
        if witness is not None:
            self.witnessed += int(bad.sum())
            log("kernels", f"{label}: {int(bad.sum())} of {bad.numel()} elements fall to the "
                f"float64 witness ({self.witnessed} so far in this run)")
        if bad.any():
            worst = torch.topk((diff - rtol * want.abs()).flatten(), min(3, int(bad.sum()))).indices
            log("kernels", f"{label}: worst got {got.flatten()[worst].tolist()} want "
                f"{want.flatten()[worst].tolist()}")
            if witness is None or not witness(label, bad, got, want):
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


def boids_plan_edges(sms: int, n_max: int) -> list:
    """Each N <= n_max where boids_plan(1, N) changes T, R or S on a card of
    `sms` SMs, and the N before it."""
    edges, prev = set(), None
    for n in range(1, n_max + 1):
        plan = boids_ops.boids_plan(1, n, sms)[:3]
        if prev is not None and plan != prev:
            edges |= {n - 1, n}
        prev = plan
    return sorted(edges)


def boids_plan_of_card(batch: int, n: int, sms: int) -> tuple:
    out = (ctypes.c_int * 5)()
    common.kernel_library().call("nbt_boids_plan", batch, n, sms, ctypes.addressof(out))
    return tuple(out)


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
    # the launch plan on this card: at each N where it changes T, R or S and
    # the N before, ragged tails included, the kernel's plan (nbt_boids_plan)
    # equals boids_plan, and the kernel its plain version, with and without
    # global_alignment (from its own generator: later phases keep their
    # inputs). Beyond N=16,385 the cohesion sums run over thousands of
    # positions and cancel where the mean is near 0, and the summation order
    # alone moves such elements past atol (N=65,536: by up to 1.8e-6 on the
    # H100), so there the error is held, normalised by max |want|, to the ring
    # boids' bound against one device (RING_BOIDS_BOUND)
    own = torch.Generator(device="cuda").manual_seed(9)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in sorted(set(boids_plan_edges(sms, 65536)) | {65536}):
        half = 20 if n < 1024 else 100
        pos = uniform(own, (n, 2), -half, half)
        vel = uniform(own, (n, 2), -1, 1)
        plan = boids_ops.boids_plan(1, n, sms)
        expect(boids_plan_of_card(1, n, sms) == plan, f"nbt_boids_plan(1, {n}) == {plan}")
        want = boids_ops.boids_velocity_plain(pos, vel, bcfg)
        for glob in (False, True):
            got = boids_ops.boids_velocity_tiled(pos, vel, BoidsConfig(global_alignment=glob))
            label = f"boids N={n} plan {plan[:3]} global_alignment={glob}"
            if n <= 16385:
                errors.check("boids", label, got, want, 3e-5, 1e-6)
            else:
                errors.check_scaled("boids", label, got, want, RING_BOIDS_BOUND)

    # The checks below that the parent tree lacked draw from their own
    # generator, so every later phase sees the inputs it always saw.
    own = torch.Generator(device="cuda").manual_seed(7)
    # the split sum (N=1,024 splits the j range across a cluster) and the
    # batch of config 5 against the plain version; those and config 4 20
    # more times, each giving the first launch's bits (the cluster's leader
    # adds the partials in rank order)
    for shape in ((1024, 2), (4096, 256, 2), (65536, 2)):
        label = f"gravity {'x'.join(map(str, shape[:-1]))}"
        pos = uniform(own, shape, -100, 100)
        first = pairwise.gravity_forces_tiled(pos, gcfg)
        if shape[0] != 65536:  # held against float64 above
            errors.check("gravity", label, first, pairwise.gravity_forces_plain(pos, gcfg),
                         3e-5, 1e-7)
        same = all(torch.equal(pairwise.gravity_forces_tiled(pos, gcfg), first)
                   for _ in range(RDMA_REPEATS))
        log("kernels", f"{label}: {RDMA_REPEATS} more launches bit-identical: {same}")
        expect(same, f"{label}: repeated launches to give the same bits")

    # the disc eye, spread and clustered (a collapsed swarm, where every
    # target reaches every pixel): equal to the plain version at power-of-two
    # widths (both compute the same float32 expressions), else within
    # tests/test_kernels.py:209-210's tolerances
    for b, n, w in EYE_SHAPES:
        shape = (b, n, 2) if b > 1 else (n, 2)
        exact = w & (w - 1) == 0
        for half, g in ((100, gen), (8, own)):
            pos = uniform(g, shape, -half, half)
            dirs = camera.unit_heading(uniform(g, shape, -1, 1))
            for aa in (False, True):
                vcfg = VisionConfig(width=w, antialias=aa)
                gs, gd = raycast.disc_eye(pos, dirs, pos, vcfg)
                ws, wd = raycast.disc_eye_plain(pos, dirs, pos, vcfg)
                label = f"disc_eye B={b} N={n} W={w} U(-{half}, {half}) aa={aa}"
                errors.check("disc_eye", label + " depth", gd, wd,
                             *((0, 0) if exact else (1e-5, 1e-4)))
                errors.check("disc_eye", label + " shade", gs, ws,
                             *((0, 0) if exact else (1e-5, 1e-5)))


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


def cli_rows(argv) -> list:
    """The JSON rows `cli.main(argv)` prints; it must exit 0."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    expect(rc == 0, f"{' '.join(argv)} exits 0")
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def step_rows(step, ts, iters: int):
    """Run a trainer's step `iters` times: (the last state, one metric row
    per iteration with its host seconds and agent-frames)."""
    rows = []
    for i in range(iters):
        t1 = time.perf_counter()
        ts, metrics = step(ts)
        row = {k: float(v) for k, v in metrics.items()}
        row.update(iter=i, sec=time.perf_counter() - t1,
                   agent_frames=TRAIN_ENVS * TRAIN_AGENTS * TRAIN_HORIZON)
        rows.append(row)
    return ts, rows


def phase_train():
    """The training path at config-5 width; returns (each run's metric rows,
    the launch counts of the path)."""
    common.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runs = {}
    for algo in ("reinforce", "apg"):
        with ParamWatch() as watch:
            runs[algo] = cli_rows(["train", "--algo", algo, "--envs", str(TRAIN_ENVS),
                                   "--agents", str(TRAIN_AGENTS), "--vision-width",
                                   str(TRAIN_WIDTH), "--horizon", str(TRAIN_HORIZON), "--iters",
                                   "3", "--seed", "0"])
        check_metrics(f"train --algo {algo}", runs[algo], 3, watch.moved())

    env = VisionEnv(SimConfig(n=TRAIN_AGENTS, controller="gravity",
                              vision=VisionConfig(width=TRAIN_WIDTH, antialias=True)),
                    reward_mode="visibility")
    ts = apg.init_apg_state(env, seed=0, device="cuda")
    step = apg.make_apg_step(env, horizon=TRAIN_HORIZON, num_envs=TRAIN_ENVS, diff_vision=True)
    with ParamWatch() as watch:
        ts, rows = step_rows(step, ts, 2)
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


def phase_more_trainers():
    """The other trainers through the CLI at config-5 width, 3 iterations
    each (MORE_TRAINERS), each with its launch counts set to 0 just before
    it and read just after, and its peak device memory. Returns (each
    run's metric rows, the summed launch counts)."""
    runs, total = {}, {k: 0 for k in KERNEL_INFO}
    t0 = time.perf_counter()
    for label in MORE_TRAINERS:
        torch.cuda.reset_peak_memory_stats()
        common.reset_launch_counts()
        with ParamWatch() as watch:
            runs[label] = cli_rows(["train", *label.split(), "--envs", str(TRAIN_ENVS), "--agents",
                                    str(TRAIN_AGENTS), "--vision-width", str(TRAIN_WIDTH),
                                    "--horizon", str(TRAIN_HORIZON), "--iters", "3",
                                    "--seed", "0"])
        torch.cuda.synchronize()
        counts = common.launch_counts()
        check_metrics(f"train {label}", runs[label], 3, watch.moved())
        log("train", f"train {label} at {TRAIN_ENVS} x {TRAIN_AGENTS} x {TRAIN_WIDTH}, horizon "
            f"{TRAIN_HORIZON}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches {counts}")
        missing = [k for k in MORE_TRAINING if counts[k] == 0]
        if missing:
            raise AssertionError(f"train {label} never launched {missing}")
        for k in total:
            total[k] += counts[k]
    log("train", f"the other trainers ran in {time.perf_counter() - t0:.2f} s")
    return runs, total


def cli_counted(argv, need=(), rows=True):
    """`cli.main(argv)` with the launch counts set to 0 just before it and
    read just after; it must exit 0 and launch each kernel of `need`.
    Returns (the JSON rows it printed, or its whole stdout, the counts, its
    host seconds, its peak device memory in GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launch_counts()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = common.launch_counts()
    expect(rc == 0, f"{' '.join(argv)} exits 0")
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise AssertionError(f"{' '.join(argv[:1])} never launched {missing}")
    text = out.getvalue()
    got = [json.loads(x) for x in text.splitlines() if x.startswith("{")] if rows else text
    return got, counts, sec, torch.cuda.max_memory_allocated() / 2 ** 30


def log_run_rate(label: str, rows, card: str) -> None:
    """`run`'s last StepTimer report (its EMA skips the first chunk)."""
    last = rows[-1]
    log("cli", f"run {label}: {last['step_ms']:.4f} ms per step, {last['steps_per_s']:.2f} "
        f"steps/s (StepTimer's EMA over chunks 2 on), t {last['t']} [{card}]")


def params_diff(a: str, b: str) -> float:
    """The largest |difference| between two params npz files' leaves."""
    import numpy as np

    with np.load(a) as x, np.load(b) as y:
        expect(sorted(x.files) == sorted(y.files), f"{a} and {b} hold the same leaves")
        return max(float(np.abs(x[k] - y[k]).max()) for k in x.files)


def phase_cli_surface(card: str):
    """The CLI's simulation and data surface in-process through cli.main, at
    the BASELINE shapes, each command with its launch counts set to 0 just
    before it and read just after: `run` at config 4 with checkpoints and
    its `--resume`, config 3 with `--record`, config 2 plain and under a
    trained policy; `train --algo reinforce` at config-5 width, resumed
    against uninterrupted; `eval --policy`; `datagen` at BASELINE config 5
    (2 shards) with the copy's overlap shown on the card's timeline; `bc`
    on its shards; `export --check` at config-5 width, its step bit-equal
    to the live step. Files go to build/chip_smoke_cli, deleted afterwards.
    Returns the summed launch counts."""
    import os
    import shutil

    import numpy as np

    from nenbody_tpu_torch.rl import bc as bc_lib
    from nenbody_tpu_torch.rl import datagen as dg
    from nenbody_tpu_torch.utils import export as export_lib
    from nenbody_tpu_torch.utils import native

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    path = lambda name: os.path.join(root, name)  # noqa: E731
    total = {k: 0 for k in KERNEL_INFO}
    t_phase = time.perf_counter()

    def add(counts):
        for k in total:
            total[k] += counts[k]

    width5 = ["--envs", str(TRAIN_ENVS), "--agents", str(TRAIN_AGENTS), "--vision-width",
              str(TRAIN_WIDTH)]
    try:
        log("cli", f"disk free under build/: "
            f"{shutil.disk_usage(root).free / 2 ** 30:.1f} GiB")
        # config 4: checkpoints every 20 steps, then a resume from t = 40
        rows, counts, _, _ = cli_counted(
            ["run", "--preset", "gravity-65536", "--steps", "40", "--log-every", "10",
             "--checkpoint-dir", path("ck"), "--checkpoint-every", "20"], need=("gravity",))
        add(counts)
        expect(rows[-1]["t"] == 40 and sorted(os.listdir(path("ck"))) == [
            "state_000000020.npz", "state_000000040.npz"], "config 4 run: t 40, 2 checkpoints")
        log_run_rate("config 4 (gravity N=65,536)", rows, card)
        rows, counts, _, _ = cli_counted(
            ["run", "--preset", "gravity-65536", "--resume", path("ck/state_000000040.npz"),
             "--steps", "10", "--log-every", "10"], need=("gravity",))
        add(counts)
        expect(rows[-1]["t"] == 50, f"the resumed run continues at t 50, got {rows[-1]['t']}")
        # config 3 with a recording, when the host library builds here
        rows, counts, _, _ = cli_counted(
            ["run", "--preset", "boids-4096", "--steps", "20", "--log-every", "5", "--record",
             path("r.nentraj")], need=("boids",))
        add(counts)
        log_run_rate("config 3 (boids N=4,096)", rows, card)
        # the card's machine has g++ and zlib's header, so the host
        # library builds there and the recording is required
        expect(native.available(), "the native host library (g++, zlib) built for --record")
        frames = len(native.read_trajectory(path("r.nentraj"))[0])
        expect(frames == 4, f"4 recorded frames, got {frames}")
        log("cli", f"--record: {frames} frames of 4,096 agents through libnenhost")
        rows, counts, _, _ = cli_counted(
            ["run", "--preset", "gravity-vision-1024", "--steps", "40", "--log-every", "10"],
            need=("gravity",))
        add(counts)
        log_run_rate("config 2 (gravity N=1,024, no observe)", rows, card)

        # train at config-5 width: 3 iterations against 2 + checkpoint + resume 1
        base = ["train", "--algo", "reinforce", *width5, "--horizon", str(TRAIN_HORIZON),
                "--seed", "0"]
        for argv in (base + ["--iters", "3", "--save", path("a.npz")],
                     base + ["--iters", "2", "--checkpoint", path("ts.npz")],
                     base + ["--iters", "1", "--resume", path("ts.npz"), "--save", path("p.npz")]):
            rows, counts, sec, _ = cli_counted(argv, need=MORE_TRAINING)
            add(counts)
            expect(all(math.isfinite(v) for r in rows for v in r.values()), "finite metrics")
        resumed = params_diff(path("a.npz"), path("p.npz"))
        if resumed:
            _, counts, _, _ = cli_counted(base + ["--iters", "3", "--save", path("b.npz")],
                                          need=MORE_TRAINING)
            add(counts)
            rerun = params_diff(path("a.npz"), path("b.npz"))
            log("cli", f"train resumed against uninterrupted: max |dparam| {resumed:.3e}; "
                f"two uninterrupted runs {rerun:.3e} (bound 2x)")
            expect(rerun > 0 and resumed <= 2 * rerun, "the resumed params equal the "
                   "uninterrupted run's up to the card's run-to-run difference")
        else:
            log("cli", "train 2 + checkpoint + resume 1 equals 3 iterations bit for bit")

        # eval of that policy, and config-2 playback under it
        rows, counts, sec, _ = cli_counted(["eval", "--policy", path("p.npz"), *width5,
                                            "--horizon", str(TRAIN_HORIZON)], need=MORE_TRAINING)
        add(counts)
        expect(math.isfinite(rows[-1]["reward_mean"]), "eval: finite reward_mean")
        log("cli", f"eval --policy at config-5 width, horizon {TRAIN_HORIZON}: {sec:.3f} s; "
            f"{json.dumps(rows[-1])}")
        rows, counts, _, _ = cli_counted(
            ["run", "--n", "1024", "--controller", "gravity", "--vision-width", "64", "--policy",
             path("p.npz"), "--steps", "20", "--log-every", "5"], need=MORE_TRAINING)
        add(counts)
        log_run_rate("config 2 under the policy (observe, MLP, dynamics)", rows, card)

        # datagen at BASELINE config 5: 2 shards of 8 steps
        frames = 16 * TRAIN_ENVS * TRAIN_AGENTS
        rows, counts, sec, peak = cli_counted(
            ["datagen", *width5, "--steps", "16", "--horizon", "8", "--out-dir", path("ds")],
            need=MORE_TRAINING)
        add(counts)
        expect([r["obs_shape"] for r in rows] == [[8, TRAIN_ENVS, TRAIN_AGENTS, TRAIN_WIDTH + 2]]
               * 2, "datagen: 2 shards of obs [8, 4096, 256, 66]")
        env = VisionEnv(SimConfig(n=TRAIN_AGENTS, controller="gravity",
                                  vision=VisionConfig(width=TRAIN_WIDTH)))
        stats, chunks = [], []
        t0 = time.perf_counter()
        for _, chunk in dg.collect(env, TRAIN_ENVS, 16, horizon=8, device="cuda", stats=stats):
            chunks.append(chunk)
        no_write = time.perf_counter() - t0
        for row in stats:
            expect(all(math.isfinite(v) for v in row["compute"] + row["copy"]), "finite timeline")
        c0, k0, c1 = stats[0]["compute"], stats[0]["copy"], stats[1]["compute"]
        overlap = min(k0[1], c1[1]) - max(k0[0], c1[0])
        t0 = time.perf_counter()
        np.savez(path("timing_shard.npz"), **chunks[0])
        write_s = time.perf_counter() - t0
        log("cli", f"datagen at config 5 (4,096 x 256 x 64, 16 steps, 2 shards of "
            f"{chunks[0]['obs'].nbytes / 1e9:.2f} GB obs): {sec:.3f} s with the shard writes = "
            f"{frames / sec:.4e} agent-frames/s; without writes {no_write:.3f} s = "
            f"{frames / no_write:.4e}; a chunk {c0[1] - c0[0]:.3f} ms on the card (chunk 2 "
            f"{c1[1] - c1[0]:.3f}); chunk 1's copy to pinned host memory {k0[1] - k0[0]:.3f} ms "
            f"({k0[0]:.3f}-{k0[1]:.3f}) overlaps chunk 2's compute ({c1[0]:.3f}-{c1[1]:.3f}) "
            f"by {overlap:.3f} ms; a shard's np.savez {write_s:.3f} s; peak device memory "
            f"{peak:.2f} GiB [{card}]")
        expect(overlap > 0, "chunk 1's host copy overlaps chunk 2's compute")
        os.remove(path("timing_shard.npz"))

        # bc on those shards, and its steps/s on one chunk on the card
        rows, counts, sec, _ = cli_counted(
            ["bc", "--data", path("ds"), "--agents", str(TRAIN_AGENTS), "--vision-width",
             str(TRAIN_WIDTH), "--steps", "50", "--batch-size", "4096"])
        add(counts)
        expect(math.isfinite(rows[-1]["bc_loss"]), "bc: finite loss")
        obs = torch.as_tensor(chunks[0]["obs"].reshape(-1, TRAIN_WIDTH + 2), device="cuda")
        act = torch.as_tensor(chunks[0]["action"].reshape(-1, 2), device="cuda")
        del chunks
        ts = bc_lib._bc_state(env, 0, 1e-3, None, torch.device("cuda"))
        step = bc_lib.make_bc_step(4096)
        for _ in range(5):
            ts, loss = step(ts, obs, act)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            ts, loss = step(ts, obs, act)
        torch.cuda.synchronize()
        bc_rate = 50 / (time.perf_counter() - t0)
        log("cli", f"bc --data (2 shards, 16.8 M samples) --steps 50 --batch-size 4096: "
            f"{sec:.3f} s with the shard load, loss {rows[-1]['bc_loss']:.4f}; {bc_rate:.1f} "
            f"steps/s on the card [{card}]")
        del obs, act

        # export at config-5 width, checked, then held against the live step
        rows, counts, sec, peak = cli_counted(
            ["export", "--policy", path("p.npz"), *width5, "--out", path("e.pt2"), "--check"],
            need=MORE_TRAINING)
        add(counts)
        expect(rows[-1]["checked"], "export --check")
        hold_export(env, path("e.pt2"), path("p.npz"), peak, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("cli", f"the CLI surface ran in {time.perf_counter() - t_phase:.2f} s; launches {total}")
    return total


def hold_export(env: VisionEnv, artifact: str, params: str, peak: float, card: str) -> None:
    """The exported step (its kernels through the custom ops) against the
    live closed-loop step (VisionEnv.observe, the policy's mean,
    VisionEnv.dynamics: the direct wrappers) on one spawn at config-5
    width: bit-equal; then ms per step of both, alternated (live, export,
    export, live), 20 chained steps each, CUDA events."""
    from nenbody_tpu_torch.state import SceneState, spawn_batch
    from nenbody_tpu_torch.utils import export as export_lib

    step = export_lib.load_policy_step(artifact)
    policy = cli._load_policy(env, params, "mlp", torch.device("cuda"))

    @torch.no_grad()
    def live(pos, vel):
        state = SceneState(pos=pos, vel=vel,
                           t=torch.zeros(pos.shape[:-2], dtype=torch.int32, device=pos.device))
        action, _ = policy(env.observe(state))
        nxt = env.dynamics(state, action)
        return nxt.pos, nxt.vel, action

    gen = torch.Generator(device="cuda").manual_seed(3)
    s = spawn_batch(env.cfg, gen, TRAIN_ENVS, "cuda")
    common.reset_launch_counts()
    got = step(s.pos, s.vel)
    torch.cuda.synchronize()
    counts = common.launch_counts()
    expect(counts["gravity"] == 1 and counts["disc_eye"] == 1,
           f"one exported step launches gravity and the disc eye once each, got {counts}")
    want = live(s.pos, s.vel)
    for name, g, w in zip(("pos", "vel", "action"), got, want):
        expect(torch.equal(g, w), f"the exported step's {name} equals the live step's bit for bit")

    def chained(fn):
        pos, vel = s.pos, s.vel
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            pos, vel, _ = fn(pos, vel)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 20

    chained(live)
    chained(step)
    live_a, exp_a, exp_b, live_b = chained(live), chained(step), chained(step), chained(live)
    log("cli", f"export at config-5 width: the .pt2 step equals the live step bit for bit; "
        f"{exp_a:.4f}, {exp_b:.4f} ms per step against the live step's {live_a:.4f}, {live_b:.4f} "
        f"(20 chained steps, CUDA events); export --check peak device memory {peak:.2f} GiB "
        f"[{card}]")


class StubPlt:
    """A pyplot stand-in for run_live's `_plt` hook: it keeps the shape of
    every eye-panel image the loop shows (the smoke needs no matplotlib
    and no display)."""

    def __init__(self):
        self.eye_shapes = []
        stub = self

        class Artist:
            def __init__(self, data, log):
                self.data, self.log = data, log
                log.append(data.shape)

            def set_data(self, data):
                self.data = data
                self.log.append(data.shape)

            def get_array(self):
                return self.data

            def remove(self):
                pass

        class Axis:
            def __init__(self, log):
                self.log = log

            def imshow(self, img, **kw):
                return Artist(img, self.log)

            def set_axis_off(self):
                pass

            def set_title(self, *a, **kw):
                pass

        class Canvas:
            def mpl_connect(self, *a):
                return 0

            def draw_idle(self):
                pass

        class Fig:
            canvas = Canvas()

        self._axes = (Axis([]), Axis(stub.eye_shapes))
        self._fig = Fig()

    def subplots(self, *a, **kw):
        return self._fig, self._axes

    def pause(self, *_):
        pass

    def close(self, *_):
        pass


def counted(total: dict, fn, need=(), label: str = ""):
    """fn() with the launch counts set to 0 just before it and read just
    after, added into `total`; each kernel of `need` must have launched."""
    torch.cuda.synchronize()
    common.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = common.launch_counts()
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label} never launched {missing}")
    for k, v in counts.items():
        total[k] += v
    return out, counts


def eye_view_rows(errors: Errors, label: str, scene: Scene, state, w: int, vcfg: VisionConfig,
                  colors, texture, kernel: str, total: dict) -> None:
    """render_eye_row on the card (the eye kernel, one launch a channel)
    against the plain render_single_row on the card: bit-equal at a
    power-of-two width without a texture, else within the eye's tolerances
    (the disc's 1e-5/1e-4 of tests/test_kernels.py, the wireframe's 2e-4,
    the texture's TEX_RTOL/TEX_ATOL), the hit mask equal."""
    (shade, depth), counts = counted(
        total, lambda: scene.render_eye_row(state, 7, w, colors, texture), (kernel,), label)
    chans = 3 if colors is not None else 1
    expect(counts[kernel] == chans and sum(counts.values()) == chans,
           f"{label}: {chans} launch(es) of {kernel} and nothing else, got {counts}")
    wcfg = dataclasses.replace(vcfg, width=w)
    plain = []
    for c in range(chans):
        ccfg = (dataclasses.replace(wcfg, background=render.BACKGROUND_RGB[c])
                if colors is not None else wcfg)
        s, d = render.render_single_row(state.pos, state.vel, 7, ccfg,
                                        None if colors is None else colors[:, c].contiguous(),
                                        texture)
        plain.append(s)
    want_s = torch.stack(plain, -1) if colors is not None else plain[0]
    exact = w & (w - 1) == 0 and texture is None
    if texture is not None:
        tol = (TEX_RTOL, TEX_ATOL)
    else:
        tol = (1e-5, 2e-4 if kernel == "wireframe_eye" else 1e-5)
    depth_tol = (1e-5, 2e-4 if kernel == "wireframe_eye" else 1e-4)
    errors.check(kernel, label + " depth", depth, d, *((0, 0) if exact else depth_tol))
    errors.check(kernel, label + " shade", shade, want_s, *((0, 0) if exact else tol))
    flips = int(((depth < wcfg.far) != (d < wcfg.far)).sum())
    log("viewer", f"{label}: hit pixels {int((d < wcfg.far).sum())} of {w}, flipped {flips} "
        f"(bound 0){', bit-equal required' if exact else ''}")
    expect(flips == 0, f"{label}: no pixel flips between hit and miss")


def phase_viewer(errors: Errors, card: str) -> dict:
    """The viewer through the user's entry points on the card, each part
    with its launch counts set to 0 just before it and read just after:
    `gif` at config 3 (boids N=4,096, 256-pixel eye) and at config 2 with
    --first-person; `run --capture 10 --first-person --record` at config 2
    (each PNG decoded by viz.image.read_png and held equal to the frame
    Viewer.compose makes again from the recorded state) and `replay` of
    that recording; render_eye_view and its rows (render_eye_row) against
    the plain render_single_row on the card (EYE_VIEW_CASES, with and
    without colors and texture); run_live's whole loop under StubPlt.
    Files go to build/chip_smoke_viewer, deleted afterwards. Returns the
    summed launch counts."""
    import os
    import shutil

    import numpy as np

    from nenbody_tpu_torch.state import SceneState

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_viewer")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    path = lambda name: os.path.join(root, name)  # noqa: E731
    total = dict.fromkeys(KERNEL_INFO, 0)
    t_phase = time.perf_counter()
    try:
        # gif at config 3 and at config 2 with the first-person panel
        for label, argv, need, size in (
            ("config 3 (boids N=4,096, W=256)", ["--preset", "boids-4096"],
             ("boids", "disc_eye"), (480, 270 + 4 + 48)),
            ("config 2 --first-person (gravity N=1,024, W=64)",
             ["--preset", "gravity-vision-1024", "--first-person"], ("gravity", "disc_eye"),
             (480, 270 + 4 + 96 + 48)),
        ):
            out = path("g.gif")
            _, counts, sec, _ = cli_counted(["gif", *argv, "--steps", "16", "--stride", "4",
                                             "--out", out], need=need, rows=False)
            for k in total:
                total[k] += counts[k]
            info = image.gif_info(out)
            with open(out, "rb") as f:
                head = f.read(6)
            expect(head == b"GIF89a" and info["frames"] == 4 and info["loop"] == 0
                   and (info["width"], info["height"]) == size
                   and info["delays_ms"] == [40.0] * 4, f"gif {label}: {info}")
            log("viewer", f"gif {label}: 4 frames {size[0]} x {size[1]}, {sec:.3f} s "
                f"({1e3 * sec / 4:.2f} ms a frame, stride 4, kernel build excluded: the "
                f"library is built); launches {counts} [{card}]")

        # the parts of a config-3 GIF frame: compose (with its host copies)
        # and the GIF encoding, host ms each
        scene = Scene(PRESETS["boids-4096"](), device="cuda")
        state = scene.spawn(0)
        v = viewer_lib.Viewer(out_dir=path("unused"), size=(270, 480), use_native=False,
                              follow="centroid")
        frames, t_compose = [], []
        for _ in range(8):
            state, _ = scene.rollout(state, 4)
            obs = scene.observe(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames.append(v.compose(state, obs))
            t_compose.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        data = image.gif_bytes(frames, 40.0)
        t_gif = time.perf_counter() - t0
        log("viewer", f"config 3 GIF frame (270 x 480 + strip): compose {1e3 * min(t_compose):.2f}"
            f"-{1e3 * max(t_compose):.2f} ms (median {1e3 * sorted(t_compose)[4]:.2f}), GIF "
            f"encoding {1e3 * t_gif / 8:.2f} ms a frame ({len(data) / 8 / 1e3:.1f} kB a frame) "
            f"[{card}]")

        # run --capture --first-person --record at config 2, then replay
        cfg2 = PRESETS["gravity-vision-1024"]()
        rows, counts, sec, _ = cli_counted(
            ["run", "--preset", "gravity-vision-1024", "--steps", "40", "--log-every", "10",
             "--capture", "10", "--first-person", "--out-dir", path("frames"), "--record",
             path("r.nentraj")], need=("gravity", "disc_eye"))
        for k in total:
            total[k] += counts[k]
        expect(rows[-1]["t"] == 40, "run --capture: t 40")
        from nenbody_tpu_torch.utils import native

        ts, pos, vel = native.read_trajectory(path("r.nentraj"))
        names = sorted(os.listdir(path("frames")))
        expect(list(ts) == [10, 20, 30, 40] and names == [f"frame_{i:06d}.png" for i in range(4)],
               f"4 recorded frames and 4 PNGs, got {list(ts)}, {names}")
        fp_scene = Scene(cfg2, device="cuda")
        again = viewer_lib.Viewer(out_dir=path("unused"), first_person=True, scene=fp_scene,
                                  use_native=False)
        for i, name in enumerate(names):
            got = image.read_png(path(f"frames/{name}"))
            st = SceneState(pos=torch.as_tensor(pos[i], device="cuda"),
                            vel=torch.as_tensor(vel[i], device="cuda"),
                            t=torch.tensor(int(ts[i]), dtype=torch.int32, device="cuda"))
            want = again.compose(st, fp_scene.observe(st))
            expect(got.shape == want.shape == (540 + 4 + 96 + 48, 960, 3)
                   and np.array_equal(got, want),
                   f"{name} decodes to the frame composed from the recorded state")
        log("viewer", f"run --capture 10 --first-person --record at config 2: {sec:.3f} s; 4 PNGs "
            f"688 x 960 decode (viz.image.read_png) to the frames composed again from the "
            f"recording, byte for byte; launches {counts} [{card}]")
        _, counts, sec, _ = cli_counted(["replay", path("r.nentraj"), "--out", path("rp.gif")],
                                        rows=False)
        info = image.gif_info(path("rp.gif"))
        expect(info["frames"] == 4 and (info["width"], info["height"]) == (480, 270)
               and sum(counts.values()) == 0, f"replay: {info}, launches {counts}")
        log("viewer", f"replay of the recording: 4 frames 480 x 270 in {sec:.3f} s, no launch")

        # render_eye_view on the card against the plain render_single_row
        for label, preset, sprite, aa, w in EYE_VIEW_CASES:
            cfg = PRESETS[preset]()
            cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
                cfg.vision, sprite_mode=sprite, antialias=aa))
            scene = Scene(cfg, device="cuda")
            st, _ = scene.rollout(scene.spawn(1), 3)
            kernel = "wireframe_eye" if sprite == "wireframe" else "disc_eye"
            forms = (("bare", None, None),
                     ("colors", render.default_agent_colors(cfg.n, "cuda"), None),
                     ("texture", None, render.checker_texture(32, 4, device="cuda")))
            for form, colors, tex in forms:
                name = f"render_eye_view {label} W={w} aa={aa} {form}"
                eye_view_rows(errors, name, scene, st, w, cfg.vision, colors, tex, kernel, total)
                img, counts = counted(total, lambda: scene.render_eye_view(
                    st, 7, size=(96, w), colors=colors, texture=tex), (kernel,), name)
                expect(img.shape == (96, w, 3) and img.dtype == np.uint8, f"{name}: image")
            one = slice(7, 8)
            dirs = camera.unit_heading(st.vel)
            wcfg = dataclasses.replace(cfg.vision, width=w)
            if sprite == "wireframe":
                row = lambda: wireframe.wireframe_eye(st.pos[one], dirs[one], st.pos, dirs, wcfg)
            else:
                row = lambda: raycast.disc_eye(st.pos[one], dirs[one], st.pos, wcfg)
            k_ms = graph_ms(row, 20)
            call_ms = cuda_ms(lambda: scene.render_eye_view(st, 7, size=(96, w)), 10)
            log("viewer", f"render_eye_view {label} W={w}: {call_ms:.4f} ms a call (96 x {w} "
                f"frame, host copy and compose included), its {kernel} launch {k_ms:.4f} ms on "
                f"the card (graph_ms) [{card}]")

        # run_live's whole loop on the kernels under the pyplot stub
        scene = Scene(cfg2, device="cuda")
        plt = StubPlt()
        out, counts = counted(total, lambda: live.run_live(
            scene, scene.spawn(0), steps_per_frame=10, capture_dir=path("live"), max_frames=20,
            _plt=plt, _key_source=iter(LIVE_KEYS)), ("gravity", "disc_eye"), "run_live")
        captured = sorted(os.listdir(path("live")))
        expect(int(out.t) == 50 and captured == ["frame_000000.png"]
               and plt.eye_shapes == [(24, 64, 3), (96, 480, 3), (96, 480, 3), (24, 64, 3),
                                      (24, 64, 3)],
               f"run_live: t {int(out.t)}, captures {captured}, eye panels {plt.eye_shapes}")
        log("viewer", f"run_live at config 2 under the stub: 5 frames (select, first person on, "
            f"capture, off, quit), t 50, 1 capture; launches {counts}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("viewer", f"the viewer ran in {time.perf_counter() - t_phase:.2f} s; launches {total}")
    return total


def phase_cells(card: str) -> dict:
    """Scene(backend="cells") on the card at config 3 and at N=65,536
    (CELLS_SHAPES): the capacity from cells_stats over the states held
    (the largest bucket, so the rules are exact), each of CELLS_STEPS steps
    from a state of the backend="pallas" (boids.cu) rollout held against
    that rollout's next state within RING_BOIDS_BOUND (err / max|pallas|),
    then one step of each timed (CUDA events, alternated) with the cells
    step's peak device memory; and the cells scene's observe, which must
    launch the disc eye. Returns the launch counts of the cells calls."""
    from nenbody_tpu_torch.physics import cells

    total = dict.fromkeys(KERNEL_INFO, 0)
    t_phase = time.perf_counter()
    for label, n in CELLS_SHAPES:
        cfg = dataclasses.replace(PRESETS["boids-4096"](), n=n, backend="pallas")
        kernel = Scene(cfg, device="cuda")
        states = [kernel.spawn(0)]
        for _ in range(CELLS_STEPS):
            states.append(kernel.step(states[-1]))
        r = math.sqrt(cfg.boids.cohesion_dist_sq)
        stats = [cells.cells_stats(s.pos, r) for s in states]
        cap = max(s["max_occupancy"] for s in stats)
        ccfg = dataclasses.replace(cfg, backend="cells",
                                   boids=dataclasses.replace(cfg.boids, cells_capacity=cap))
        scene = Scene(ccfg, device="cuda")
        for i, (s, want) in enumerate(zip(states[:-1], states[1:])):
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got, counts = counted(total, lambda: scene.step(s), label=f"cells {label}")
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            expect(sum(counts.values()) == 0, f"cells {label}: the cell list launches nothing")
            errs = []
            for k in ("pos", "vel"):
                a, b = getattr(got, k).double(), getattr(want, k).double()
                errs.append(((a - b).abs().max() / b.abs().max()).item())
                expect(bool(torch.isfinite(a).all()) and errs[-1] < RING_BOIDS_BOUND,
                       f"cells {label} step {i + 1} {k}: err/max|boids.cu| {errs[-1]:.3e} "
                       f"within {RING_BOIDS_BOUND:.0e}")
        _, counts = counted(total, lambda: scene.observe(states[-1]), ("disc_eye",),
                            f"cells {label} observe")
        p_ms, c_ms = alternate(lambda: kernel.step(states[0]), lambda: scene.step(states[0]),
                               20 if n <= 4096 else 5, 10 if n <= 4096 else 2)
        log("cells", f"{label}: capacity {cap} (cells_stats max occupancy over {len(states)} "
            f"states; table {stats[0]['table_size']}, mean occupancy "
            f"{stats[0]['mean_occupancy']:.1f}, {stats[0]['used_buckets']} buckets used), "
            f"{CELLS_STEPS} steps within {RING_BOIDS_BOUND:.0e} of boids.cu (last err/max "
            f"{max(errs):.3e}); a step {c_ms:.4f} ms against the boids.cu step {p_ms:.4f} "
            f"({c_ms / p_ms:.1f}x); the cells step's peak device memory {peak:.2f} GiB above "
            f"its inputs (agent chunks of {max(1, cells.CELLS_PAIR_BUDGET // (9 * cap))}) "
            f"[{card}]")
    log("cells", f"the cells backend ran in {time.perf_counter() - t_phase:.2f} s; launches "
        f"{total}")
    return total


def wf_cfg(cfg: SimConfig, antialias: bool | None = None) -> SimConfig:
    """`cfg` with the exact wireframe sprite (and antialias, if given)."""
    aa = cfg.vision.antialias if antialias is None else antialias
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, sprite_mode="wireframe", antialias=aa))


def hold_wireframe(errors: Errors, label: str, got, want, vcfg: VisionConfig) -> None:
    """The wireframe eye's (shade, depth, winner) against its plain
    version's, at the JAX suite's tolerance (rtol 1e-5, atol 2e-4,
    tests/test_wireframe_kernel.py): the kernel follows the plain division
    route op for op, so no pixel may flip between hit and miss, the winner
    index must equal the plain argmin's wherever the depths differ, and at a
    power-of-two width (where the pixel centres agree) all three must be
    equal."""
    gs, gd, gw = got
    ws, wd, ww = want
    errors.check("wireframe_eye", label + " depth", gd, wd, 1e-5, 2e-4)
    errors.check("wireframe_eye", label + " shade", gs, ws, 1e-5, 2e-4)
    flips = int(((gd < vcfg.far) != (wd < vcfg.far)).sum())
    other = gw.long() != ww
    pow2 = vcfg.width & (vcfg.width - 1) == 0
    equal = torch.equal(gd, wd) and torch.equal(gs, ws) and not other.any()
    log("kernels", f"{label}: hit pixels {(wd < vcfg.far).double().mean().item():.3f}, "
        f"flipped {flips} (bound 0), winners differing {int(other.sum())}, of them at "
        f"differing depths {int((other & (gd != wd)).sum())} (bound 0); bit-equal {equal}"
        + (" (required)" if pow2 else ""))
    if flips or (other & (gd != wd)).any() or (pow2 and not equal):
        raise AssertionError(f"{label}: flipped pixels or winners, or not bit-equal")


def wf_frame(kind: str, b: int, m: int, w: int, gen):
    """(eye_pos, eye_dir [b, 1, 2], tgt, hdg [b, m, 2]) on the card: sprites
    in each env's eye frame (t = 1) straddling the near plane ('near_plane':
    centres within 1.5 r of it) or with edge 0 along the ray of a pixel
    centre, turned by less than 1e-6 rad ('edge_on': |den| near 0)."""
    eye = uniform(gen, (b, 1, 2), -50, 50)
    d = camera.unit_heading(uniform(gen, (b, 1, 2), -1, 1))
    right = torch.stack([d[..., 1], -d[..., 0]], dim=-1)
    if kind == "near_plane":
        f = 1.0 + uniform(gen, (b, m), -1.5, 1.5)
        lat = uniform(gen, (b, m), -1.5, 1.5) * f.clamp(min=0.5)
        tgt = eye + f[..., None] * d + lat[..., None] * right
        return eye, d, tgt.contiguous(), camera.unit_heading(uniform(gen, (b, m, 2), -1, 1))
    f = uniform(gen, (b, m), 3.0, 40.0)
    u = 2.0 * (torch.randint(0, w, (b, m), generator=gen, device="cuda") + 0.5) / w - 1.0
    flip = (torch.rand((b, m), generator=gen, device="cuda") < 0.5) * math.pi
    phi = torch.atan2(u, torch.ones_like(u)) + uniform(gen, (b, m), -1e-6, 1e-6) + flip
    world = torch.cos(phi)[..., None] * d + torch.sin(phi)[..., None] * right
    theta = torch.atan2(world[..., 1], world[..., 0]) - math.atan2(1.0, 2.0)  # edge 0 is (2, 1) r
    c, s_ = torch.cos(theta), torch.sin(theta)
    vert0 = eye + f[..., None] * d + (u * f)[..., None] * right
    tgt = vert0 - torch.stack([-c + s_, -s_ - c], dim=-1)  # vert 0 is (-1, -1) r, turned
    return eye, d, tgt.contiguous(), torch.stack([c, s_], dim=-1)


def phase_wireframe_kernel(errors: Errors, gen) -> None:
    """wireframe_eye against its plain version (hold_wireframe) at the paths'
    shapes, AA off and on; at the trainers' shape (4,096 envs) the plain
    version runs on the first and last 64 envs of the kernel's batch. Then,
    from their own generator (later phases keep their inputs): clustered
    swarms (U(-8, 8), every sprite reaching many pixels) at the same shapes
    and at rows cut into segments, sprites straddling the near plane, and
    edges almost along a pixel's ray."""
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
                label = f"wireframe_eye B={b} N={n} W={w} aa={aa}" + (
                    "" if envs is None else f" envs[{part.start}:{part.stop}]")
                hold_wireframe(errors, label, tuple(x[part] for x in got),
                               wireframe.wireframe_eye_plain(pos[part], dirs[part], pos[part],
                                                             dirs[part], vcfg), vcfg)
    own = torch.Generator(device="cuda").manual_seed(8)
    for b, n, w in WF_SHAPES + [(1, 300, 512), (3, 200, 2048)]:
        shape = (b, n, 2) if b > 1 else (n, 2)
        pos = uniform(own, shape, -8, 8)
        dirs = camera.unit_heading(uniform(own, shape, -1, 1))
        for aa in (False, True):
            vcfg = VisionConfig(width=w, antialias=aa, sprite_mode="wireframe")
            hold_wireframe(errors, f"wireframe_eye B={b} N={n} W={w} U(-8, 8) aa={aa}",
                           wireframe.wireframe_eye_with_winner(pos, dirs, pos, dirs, vcfg),
                           wireframe.wireframe_eye_plain(pos, dirs, pos, dirs, vcfg), vcfg)
    for kind in ("near_plane", "edge_on"):
        for w in (64, 1024):
            eye, d, tgt, hdg = wf_frame(kind, 8, 300, w, own)
            for aa in (False, True):
                vcfg = VisionConfig(width=w, antialias=aa, sprite_mode="wireframe")
                hold_wireframe(errors, f"wireframe_eye {kind} 8 x 1 eye x 300 W={w} aa={aa}",
                               wireframe.wireframe_eye_with_winner(eye, d, tgt, hdg, vcfg),
                               wireframe.wireframe_eye_plain(eye, d, tgt, hdg, vcfg), vcfg)


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
    with ParamWatch() as watch:
        runs["reinforce"] = cli_rows(["train", "--algo", "reinforce", "--sprite-mode",
                                      "wireframe", "--envs", str(TRAIN_ENVS), "--agents",
                                      str(TRAIN_AGENTS), "--vision-width", str(TRAIN_WIDTH),
                                      "--horizon", str(TRAIN_HORIZON), "--iters", "3",
                                      "--seed", "0"])
    check_metrics("train --algo reinforce --sprite-mode wireframe", runs["reinforce"], 3,
                  watch.moved())
    counts = [common.launch_counts()]

    common.reset_launch_counts()
    env = VisionEnv(wf_cfg(SimConfig(n=TRAIN_AGENTS, controller="gravity",
                                     vision=VisionConfig(width=TRAIN_WIDTH)), antialias=True),
                    reward_mode="visibility")
    ts = apg.init_apg_state(env, seed=0, device="cuda")
    step = apg.make_apg_step(env, horizon=TRAIN_HORIZON, num_envs=TRAIN_ENVS, diff_vision=True)
    with ParamWatch() as watch:
        ts, rows = step_rows(step, ts, 2)
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


RING_PAIRS = 16384  # the ring kernels' phase-3 shape: one hop at config 4 on 4 shards
# how far the wireframe backward's total distance from float64 over its
# elements beyond tolerance may exceed the plain fp32 version's
WITNESS_FACTOR = 2.0


def pullback_witness(inputs, winner, us, ud, vcfg: VisionConfig, out: int, rtol, atol,
                     albedo=None, texture=None):
    """A witness for Errors.check of the wireframe backward's output `out`
    (0-4: d eye pos, d eye dir, d target pos, d target heading, d albedo;
    the forward's appearance `albedo` and `texture`), run on the
    envs that hold an element beyond tolerance. The exact value is
    winner_pullback in float64 (the same winner index). Each element
    beyond tolerance must be within its largest per-pixel-column share
    (pixel_shares, float64 or plain fp32, whichever is larger) of the
    exact value, plus the tolerance: the kernel and the exact value differ
    by no more than one pixel on another side of a branch or a cancelling
    difference would move it. And over those elements the kernel's total
    distance from the exact value must be within WITNESS_FACTOR times the
    plain fp32 version's: it is not the less exact side there."""
    def witness(label, bad, got, want) -> bool:
        batched = inputs[0].dim() == 3
        envs = bad.flatten(1).any(1).nonzero().flatten() if batched else None
        sel = (lambda x: x[envs]) if batched else (lambda x: x)
        ins32 = [sel(x) for x in (*inputs, us, ud)] + [
            None if albedo is None else sel(albedo), texture]
        ins64 = [None if x is None else x.double() for x in ins32]
        win = sel(winner)
        args = lambda xs: (*xs[:4], win, *xs[4:6], vcfg, *xs[6:])
        ref = wireframe.winner_pullback(*args(ins64))[out]
        share = torch.maximum(pixel_shares(*args(ins64), out),
                              pixel_shares(*args(ins32), out).double())
        b = sel(bad)
        k, p, f, m = sel(got)[b], sel(want)[b], ref[b], share[b]
        k_err, p_err = (k - f).abs(), (p - f).abs()
        outside = k_err > m + atol + rtol * f.abs()
        for i in range(min(12, len(k))):
            log("kernels", f"{label}: float64 witness kernel {k[i].item():.6e} plain "
                f"{p[i].item():.6e} float64 {f[i].item():.6e} largest pixel share "
                f"{m[i].item():.3e}: |kernel - float64| {k_err[i].item():.3e}, "
                f"|plain - float64| {p_err[i].item():.3e}")
        total_k, total_p = k_err.sum().item(), p_err.sum().item()
        log("kernels", f"{label}: float64 witness over {len(k)} elements beyond tolerance in "
            f"{1 if envs is None else len(envs)} envs: outside their largest pixel share "
            f"{int(outside.sum())} (bound 0); total |kernel - float64| {total_k:.3e}, total "
            f"|plain - float64| {total_p:.3e} (bound {WITNESS_FACTOR} x the plain's)")
        return not outside.any() and total_k <= WITNESS_FACTOR * total_p

    return witness


def pixel_shares(eye_pos, eye_dir, tgt, tgt_hdg, winner, us, ud, vcfg: VisionConfig,
                 albedo, texture, out: int):
    """The largest absolute per-pixel-column share of winner_pullback's
    output `out`, in the inputs' precision: the pullback with the
    cotangents of one pixel column at a time (one replica of the envs per
    column)."""
    w = vcfg.width
    ins = [eye_pos, eye_dir, tgt, tgt_hdg]
    batched = eye_pos.dim() == 3
    if not batched:
        ins, winner, us, ud = [x[None] for x in ins], winner[None], us[None], ud[None]
        albedo = None if albedo is None else albedo[None]
    one = torch.eye(w, dtype=us.dtype, device=us.device)[:, None, None, None, :]
    reps = [x.repeat(w, 1, 1) for x in ins]
    alb = None if albedo is None else albedo.repeat(w, 1)
    col = lambda x: (x[None] * one).flatten(0, 1)
    terms = wireframe.winner_pullback(*reps, winner.repeat(w, 1, 1), col(us), col(ud), vcfg, alb,
                                      texture)[out]
    largest = terms.unflatten(0, (w, -1)).abs().amax(0)
    return largest if batched else largest[0]


def phase_ring_kernels(errors: Errors, gen) -> None:
    """The ring's kernels against their plain versions on the card.
    Boids partials at 16,384 x 16,384 (an aliased block with the diagonal
    masked, as on hop 0, and two distinct blocks): counts exact; the sums
    normalised by their largest, bound N * 2^-24 (a worst-case sequential
    fp32 sum of N terms; the alignment sum runs over every agent and
    cancels). The gravity VJP's cross form at 16,384 x 16,384, both
    outputs, against its plain version in float64, normalised, the same
    bound. The wireframe backward against winner_pullback at the eye's
    shapes and the trainers', AA off and on, the trainers' also as the 4
    hops of shard 0 on a 4-shard agent axis (eyes against their own block,
    then the 3 others): rtol 2e-4, atol 2e-4 of the largest component
    (per-pixel terms round apart; target sums in atomic, run-to-run
    order). At config-5 width a few components per million may sit at a
    near-degenerate edge (the ray almost along it, or the pixel centre
    clamped to a slab-clip endpoint), where both sides differentiate
    through a cancelling difference and round apart by more; each such
    element must pass the float64 witness (pullback_witness) instead, and
    each check logs how many fell to it."""
    n = RING_PAIRS
    bound = n * 2.0 ** -24
    bcfg = BoidsConfig()
    pos, vel = uniform(gen, (n, 2), -100, 100), uniform(gen, (n, 2), -1, 1)
    pos_j, vel_j = uniform(gen, (n, 2), -100, 100), uniform(gen, (n, 2), -1, 1)
    for excl, pj, vj in ((True, pos, vel), (False, pos_j, vel_j)):
        got = boids_ops.boids_partials_tiled(pos, vel, pj, vj, bcfg, excl)
        want = boids_ops.boids_partials_plain(pos, vel, pj, vj, bcfg, excl)
        for name, g, w in zip(("sum1", "cnt1", "repel", "sum3", "cnt3"), got, want):
            label = f"boids_partials {n} x {n} exclude_diagonal={excl} {name}"
            if name.startswith("cnt"):
                errors.check("boids_partials", label, g, w, 0.0, 0.0)
            else:
                errors.check_scaled("boids_partials", label, g, w, bound)

    gcfg = GravityConfig()
    u = torch.randn((n, 2), generator=gen, device="cuda")
    got = pairwise.gravity_vjp_cross_tiled(pos, pos_j, u, gcfg)
    want64 = pairwise.gravity_vjp_cross_plain(pos.double(), pos_j.double(), u.double(), gcfg)
    plain32 = pairwise.gravity_vjp_cross_plain(pos, pos_j, u, gcfg)
    for name, g, w, p32 in zip(("d pos_i", "d pos_j"), got, want64, plain32):
        p_err = ((p32.double() - w).abs().max() / w.abs().max()).item()
        log("kernels", f"gravity_vjp cross {n} x {n} {name}: plain fp32 err/max|grad| vs "
            f"float64 {p_err:.3e}")
        errors.check_scaled("gravity_vjp", f"gravity_vjp cross {n} x {n} {name} vs float64",
                            g, w, bound)

    for b, n_e, w in ((1, 1024, 64), (1, 100, 1024), (TRAIN_ENVS, TRAIN_AGENTS, TRAIN_WIDTH)):
        shape = (b, n_e, 2) if b > 1 else (n_e, 2)
        epos = uniform(gen, shape, -100, 100)
        dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
        us = torch.randn(shape[:-1] + (w,), generator=gen, device="cuda")
        ud = torch.randn(shape[:-1] + (w,), generator=gen, device="cuda") * 1e-2
        for aa in (False, True):
            vcfg = VisionConfig(width=w, antialias=aa, sprite_mode="wireframe")
            hops = [(f"B={b} N={n_e} W={w} aa={aa}", epos, dirs, epos, dirs, us, ud)]
            if b == TRAIN_ENVS:
                m = n_e // 4
                blk = lambda x, j: x[:, j * m:(j + 1) * m].contiguous()
                hops += [(f"{b} x {n_e} x {w} aa={aa} shard 0 hop {k}", blk(epos, 0),
                          blk(dirs, 0), blk(epos, (0 - k) % 4), blk(dirs, (0 - k) % 4),
                          blk(us, 0), blk(ud, 0)) for k in range(4)]
            for label, ep, ed, tp, th, cs, cd in hops:
                _, _, winner = wireframe.wireframe_eye_with_winner(ep, ed, tp, th, vcfg)
                got = wireframe.wireframe_eye_vjp(ep, ed, tp, th, winner, cs, cd, vcfg)
                want = wireframe.winner_pullback(ep, ed, tp, th, winner, cs, cd, vcfg)
                for i, (name, g, x) in enumerate(zip(("d_eye", "d_dir", "d_tgt", "d_hdg"),
                                                     got, want)):
                    atol = 2e-4 * x.abs().max().item()
                    errors.check("wireframe_eye_bwd", f"wireframe_eye_bwd {label} {name}", g, x,
                                 2e-4, atol, witness=pullback_witness(
                                     (ep, ed, tp, th), winner, cs, cd, vcfg, i, 2e-4, atol))


def vjp_plan_of_card(batch: int, n: int, m: int, sms: int) -> tuple:
    out = (ctypes.c_int * 5)()
    common.kernel_library().call("nbt_gravity_vjp_plan", batch, n, m, sms, ctypes.addressof(out))
    return tuple(out)


def partials_plan_of_card(batch: int, n: int, m: int, sms: int) -> tuple:
    out = (ctypes.c_int * 5)()
    common.kernel_library().call("nbt_boids_partials_plan", batch, n, m, sms,
                                 ctypes.addressof(out))
    return tuple(out)


def phase_vjp_partials_plans(errors: Errors) -> None:
    """The gravity VJP's and the boids partials' launch plans on this card
    (and at 132 and 16 SMs) equal to their plain twins at the path shapes
    (VJP_TIME_SHAPES, PARTIALS_TIME_SHAPES, and a batch of 64 envs, 512
    agents against 1,536); the 2 x 2 mesh's shapes (128-thread blocks)
    against their plain versions (the self form at the scaled bound of
    phase_backward_kernels, the cross form against float64 at the VJP's
    3e-5); then each form of both kernels 20 more times, each launch giving
    the first one's bits (the cluster's leader adds the partials in rank
    order). Inputs from a generator of their own."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = {(b, n, m or n) for _, b, n, m in VJP_TIME_SHAPES}
    shapes |= {(b, n, m) for _, b, n, m, _ in PARTIALS_TIME_SHAPES} | {(64, 512, 1536)}
    for count in sorted({sms, 132, 16}):
        for b, n, m in sorted(shapes):
            for twin, card_plan, name in (
                    (pairwise.gravity_vjp_plan, vjp_plan_of_card, "nbt_gravity_vjp_plan"),
                    (boids_ops.boids_partials_plan, partials_plan_of_card,
                     "nbt_boids_partials_plan")):
                for n_, m_ in {(n, m), (m, n)}:  # both launches of a cross form
                    plan = twin(b, n_, m_, count)
                    expect(card_plan(b, n_, m_, count) == plan,
                           f"{name}({b}, {n_}, {m_}, {count}) == {plan}")
    log("kernels", f"nbt_gravity_vjp_plan and nbt_boids_partials_plan equal their twins at "
        f"{len(shapes)} shapes, both launches, on {sorted({sms, 132, 16})} SMs")
    for b, n, m in sorted(shapes):
        log("kernels", f"plans on this card ({sms} SMs) at {b} x {n} x {m}: VJP "
            f"{pairwise.gravity_vjp_plan(b, n, m, sms)}, partials "
            f"{boids_ops.boids_partials_plan(b, n, m, sms)} (T, R, S, chunk, i-blocks)")

    gcfg, bcfg = GravityConfig(), BoidsConfig()
    pos = uniform(gen, (2048, 128, 2), -100, 100)
    pos_j = uniform(gen, (2048, 128, 2), -100, 100)
    u = torch.randn((2048, 128, 2), generator=gen, device="cuda")
    errors.check_scaled("gravity_vjp", "gravity_vjp 2048 x 128",
                        pairwise.gravity_vjp_tiled(pos, u, gcfg),
                        pairwise.gravity_vjp_plain(pos, u, gcfg), 3e-5)
    got = pairwise.gravity_vjp_cross_tiled(pos, pos_j, u, gcfg)
    want64 = pairwise.gravity_vjp_cross_plain(pos.double(), pos_j.double(), u.double(), gcfg)
    for name, g, w in zip(("d pos_i", "d pos_j"), got, want64):
        errors.check_scaled("gravity_vjp", f"gravity_vjp cross 2048 x 128 x 128 {name} vs "
                            "float64", g, w, 3e-5)

    runs = {}
    for b, n in ((1, 65536), (TRAIN_ENVS, TRAIN_AGENTS), (2048, 128)):
        shape = (b, n, 2) if b > 1 else (n, 2)
        p, c = uniform(gen, shape, -100, 100), torch.randn(shape, generator=gen, device="cuda")
        runs[f"gravity_vjp {b} x {n}"] = lambda p=p, c=c: (
            pairwise.gravity_vjp_tiled(p, c, gcfg),)
    for b, n in ((1, RING_PAIRS), (2048, 128)):
        shape = (b, n, 2) if b > 1 else (n, 2)
        p, q = uniform(gen, shape, -100, 100), uniform(gen, shape, -100, 100)
        c = torch.randn(shape, generator=gen, device="cuda")
        runs[f"gravity_vjp cross {b} x {n} x {n}"] = (
            lambda p=p, q=q, c=c: pairwise.gravity_vjp_cross_tiled(p, q, c, gcfg))
    for _, b, n, m, excl in PARTIALS_TIME_SHAPES:
        pi, vi = uniform(gen, (n, 2), -100, 100), uniform(gen, (n, 2), -1, 1)
        pj, vj = (pi, vi) if excl else (uniform(gen, (m, 2), -100, 100),
                                        uniform(gen, (m, 2), -1, 1))
        runs[f"boids_partials {n} x {m} exclude_diagonal={excl}"] = (
            lambda pi=pi, vi=vi, pj=pj, vj=vj, excl=excl:
            boids_ops.boids_partials_tiled(pi, vi, pj, vj, bcfg, excl))
    for label, run in runs.items():
        first = run()
        same = all(all(torch.equal(a, b) for a, b in zip(run(), first))
                   for _ in range(RDMA_REPEATS))
        log("kernels", f"{label}: {RDMA_REPEATS} more launches bit-identical: {same}")
        expect(same, f"{label}: repeated launches to give the same bits")


def hold_scaled(label: str, got, want, bound: float) -> float:
    """|got - want| / max|want| < bound for one path against another."""
    torch.cuda.synchronize()
    expect(got.shape == want.shape and bool(torch.isfinite(got).all()), f"{label}: finite")
    err = ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()
    log("ring", f"{label}: err/max|one device| {err:.3e} (bound {bound:.1e})")
    expect(err < bound, f"{label} within its bound")
    return err


def hold_rows(label: str, got, want, vcfg: VisionConfig) -> None:
    """Rows at the eye's tolerances (depth rtol 1e-5 / atol 1e-4, shade
    rtol 1e-5 / atol 1e-5, the wireframe's 2e-4), no pixel flipped."""
    torch.cuda.synchronize()
    shade_atol = 2e-4 if vcfg.sprite_mode == "wireframe" else 1e-5
    flips = int(((got[1] < vcfg.far) != (want[1] < vcfg.far)).sum())
    log("ring", f"{label}: max|d depth| {(got[1] - want[1]).abs().max().item():.3e}, "
        f"max|d shade| {(got[0] - want[0]).abs().max().item():.3e}, flipped pixels {flips} "
        f"(bound 0)")
    expect(flips == 0, f"{label}: no flipped pixel")
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=shade_atol)


# |off| within this of 1 in float64: a footprint's edge within rounding of
# the pixel centre, where the RDMA eye's off = (u_p - u_c) f t / r and the
# single-device eye's (u_p - u_c) / du may decide its coverage apart
EDGE_OFF = 1e-5
# that target's off^2 (float64) against the winning row's, decoded from its
# shade: within twice EDGE_OFF of each other, and the decode's rounding
EDGE_O2 = 2 * EDGE_OFF + 1e-6
EDGE_SHARE = 1e-5  # the most pixels a comparison may leave to edge_witness


def edge_witness(got, want, pos, vel, vcfg: VisionConfig):
    """(pixels beyond the eye's tolerances, how many of them edge-decided):
    got and want are (shade, depth) rows [(B,) N, W] of the agents pos, vel
    rendered by the two disc arithmetics. A pixel is edge-decided where a
    target with |off| within EDGE_OFF of 1 (float64) lies at the nearer of
    the two depths and is the one that row chose, its off^2 within EDGE_O2
    of the row's (shade = albedo (1 - off^2 / 4)): its coverage is a matter
    of rounding, and the rows differ only in whether it won."""
    bad = ~(torch.isclose(got[1], want[1], rtol=1e-5, atol=1e-4)
            & torch.isclose(got[0], want[0], rtol=1e-5, atol=1e-5))
    if pos.dim() == 2:
        bad, pos, vel = bad[None], pos[None], vel[None]
        got, want = tuple(x[None] for x in got), tuple(x[None] for x in want)
    b, e, px = bad.nonzero(as_tuple=True)
    if len(b) == 0:
        return 0, 0
    t = camera.tan_half_fov(vcfg)
    d = camera.unit_heading(vel)[b, e].double()[:, None, :]  # [K, 1, 2]
    rel = (pos[b].double() - pos[b, e].double()[:, None, :])  # [K, N, 2]
    f = (rel * d).sum(-1)
    lat = rel[..., 0] * d[..., 1] - rel[..., 1] * d[..., 0]
    u_p = 2.0 * (px.double() + 0.5) / vcfg.width - 1.0
    off = (u_p[:, None] - lat / (f * t)) * f * t / vcfg.sprite_radius
    near = torch.minimum(got[1][b, e, px], want[1][b, e, px]).double()
    chosen = torch.zeros_like(f, dtype=torch.bool)  # [K, N]: the nearer row's winner
    for shade, depth in (got, want):
        d_row = depth[b, e, px].double()
        o2_row = 4.0 * (1.0 - shade[b, e, px].double() / vcfg.sprite_albedo)
        nearer = (d_row < vcfg.far) & ((d_row - near).abs() <= 1e-5 * near)
        chosen |= nearer[:, None] & ((off * off - o2_row[:, None]).abs() <= EDGE_O2)
    edge = ((f > vcfg.near) & (f < vcfg.far) & ((off.abs() - 1.0).abs() < EDGE_OFF)
            & ((f - near[:, None]).abs() <= 1e-5 * near[:, None]) & chosen)
    return len(b), int(edge.any(dim=-1).sum())


def hold_rows_edges(label: str, got, want, vcfg: VisionConfig, pos, vel) -> None:
    """hold_rows for rows of the two disc arithmetics: every pixel within
    the eye's tolerances except edge-decided ones (edge_witness), at most
    EDGE_SHARE of the pixels."""
    torch.cuda.synchronize()
    beyond, witnessed = edge_witness(got, want, pos, vel, vcfg)
    share = beyond / got[1].numel()
    log("ring", f"{label}: {beyond} of {got[1].numel()} pixels beyond the eye's tolerances, "
        f"{witnessed} of them edge-decided (|off| within {EDGE_OFF} of 1 in float64)")
    expect(witnessed == beyond and share <= EDGE_SHARE,
           f"{label}: every differing pixel edge-decided, at most {EDGE_SHARE} of them")


def phase_ring(card: str):
    """The agent-axis ring's path at full width (module docstring), each
    part against the one-device result, launch counts read before and
    after each part. Returns (the launch counts of each part, the mesh
    trainers' metric rows)."""
    cuda = torch.device("cuda", 0)
    mesh4 = make_mesh({"agents": 4}, devices=[cuda] * 4)
    mesh22 = make_mesh({"data": 2, "agents": 2}, devices=[cuda] * 4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    counts = {part: dict.fromkeys(KERNEL_INFO, 0) for part in RING}
    runs = {}
    t0 = time.perf_counter()

    def on_ring(part: str, fn):
        """fn(), the ring's call, with the launch counts set to 0 just
        before it and read just after, added to `part`'s: the one-device
        results it is held against run outside."""
        common.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for k, v in common.launch_counts().items():
            counts[part][k] += v
        return out

    with torch.no_grad():
        cfg4 = PRESETS["gravity-65536"]()
        pos = uniform(gen, (cfg4.n, 2), -100, 100)
        vel = uniform(gen, (cfg4.n, 2), 0, 0.1)
        one = pairwise.gravity_forces_tiled(pos, cfg4.gravity)
        hold_scaled("ring gravity config 4 (N=65,536, 4 shards)",
                    on_ring("physics and rows",
                            lambda: ring.ring_gravity_forces(pos, cfg4, mesh=mesh4)),
                    one, RING_GRAVITY_BOUND)
        bcfg = SimConfig(n=cfg4.n, controller="boids")
        one = boids_ops.boids_velocity_tiled(pos, vel, bcfg.boids)
        hold_scaled("ring boids N=65,536 (4 shards)",
                    on_ring("physics and rows",
                            lambda: ring.ring_boids_velocity(pos, vel, bcfg, mesh=mesh4)),
                    one, RING_BOIDS_BOUND)
        cfg2 = PRESETS["gravity-vision-1024"]()
        s2 = Scene(cfg2, device="cuda").spawn(0)
        for sprite in ("disc", "wireframe"):
            vcfg = dataclasses.replace(cfg2.vision, sprite_mode=sprite)
            one = (wireframe.render_rows_wireframe_tiled(s2.pos, s2.vel, vcfg) if sprite ==
                   "wireframe" else raycast.render_rows_tiled(s2.pos, s2.vel, vcfg))
            hold_rows(f"ring_render_rows {sprite} config 2 (4 shards)",
                      on_ring("physics and rows",
                              lambda: ring.ring_render_rows(s2.pos, s2.vel, vcfg, mesh=mesh4)),
                      one, vcfg)

        log("ring", f"default_mesh(): {default_mesh()}")
        for preset, steps in (("gravity-vision-1024", 20), ("boids-4096", 5)):
            base = PRESETS[preset]()
            scene = Scene(dataclasses.replace(base, backend="pallas"), device="cuda")
            one_traj = scene.rollout(scene.spawn(0), steps, record=("pos", "obs"))[1]
            scene = Scene(dataclasses.replace(base, backend="ring"), device="cuda")
            s0 = scene.spawn(0)
            ring_traj = on_ring("scene", lambda: scene.rollout(s0, steps,
                                                               record=("pos", "obs"))[1])
            finite_cuda(f"{preset} ring rollout", ring_traj["pos"], ring_traj["obs"])
            dpos = (ring_traj["pos"] - one_traj["pos"]).abs().max().item()
            flips = ((ring_traj["obs"] - one_traj["obs"]).abs() > 1e-3).double().mean().item()
            log("ring", f"Scene(backend='ring') {preset}, {steps} steps against backend "
                f"'pallas': max|dpos| {dpos:.3e} (bound {RING_SCENE_DPOS:.0e}), obs pixels off "
                f"by >1e-3 {flips:.2e} (bound {RING_SCENE_PIXELS:.0e})")
            expect(dpos < RING_SCENE_DPOS and flips < RING_SCENE_PIXELS,
                   f"{preset}: the ring rollout agrees")

    argv = ["train", "--envs", str(TRAIN_ENVS), "--agents", str(TRAIN_AGENTS),
            "--vision-width", str(TRAIN_WIDTH), "--horizon", str(TRAIN_HORIZON), "--iters", "2",
            "--seed", "0"]
    one = cli_rows(argv)
    runs["train --mesh auto"] = on_ring("train --mesh auto",
                                        lambda: cli_rows(argv + ["--mesh", "auto"]))
    for a, b in zip(runs["train --mesh auto"], one):
        expect(math.isclose(a["loss"], b["loss"], rel_tol=RING_LOSS_RTOL),
               f"train --mesh auto loss {a} equals one device's {b}")
    log("ring", f"train --mesh auto: losses {[r['loss'] for r in runs['train --mesh auto']]} "
        f"(one device {[r['loss'] for r in one]}, rtol {RING_LOSS_RTOL:.0e})")

    torch.cuda.reset_peak_memory_stats()
    for label, sprite, algo in (("reinforce 2x2", "disc", "reinforce"),
                                ("apg diff_vision wireframe 2x2", "wireframe", "apg"),
                                ("apg diff_vision disc 2x2", "disc", "apg")):
        vcfg = VisionConfig(width=TRAIN_WIDTH, sprite_mode=sprite, antialias=algo == "apg")
        env = VisionEnv(SimConfig(n=TRAIN_AGENTS, controller="gravity", vision=vcfg),
                        reward_mode="visibility" if algo == "apg" else "cohesion")
        rows = {}
        for mesh in (mesh22, None):
            if algo == "apg":
                ts = apg.init_apg_state(env, seed=0, device="cuda")
                step = apg.make_apg_step(env, horizon=TRAIN_HORIZON, num_envs=TRAIN_ENVS,
                                         mesh=mesh, diff_vision=True)
            else:
                ts = train.init_train_state(env, TRAIN_ENVS, seed=0, device="cuda", mesh=mesh)
                step = train.make_train_step(env, horizon=TRAIN_HORIZON, mesh=mesh)
            with ParamWatch() as watch:
                if mesh is None:
                    ts, out = step_rows(step, ts, 2)
                else:
                    ts, out = on_ring(label, lambda: step_rows(step, ts, 2))
                    check_metrics(label, out, 2, watch.moved())
            rows["mesh" if mesh is not None else "one"] = out
        runs[label] = rows["mesh"]
        ring_loss, one_loss = rows["mesh"][0]["loss"], rows["one"][0]["loss"]
        rel = abs(ring_loss - one_loss) / abs(one_loss)
        log("ring", f"{label} at {TRAIN_ENVS} x {TRAIN_AGENTS} x {TRAIN_WIDTH}, horizon "
            f"{TRAIN_HORIZON}: first loss {ring_loss:.8e} against one device's {one_loss:.8e}, "
            f"|difference| / |one device| {rel:.3e} (bound {RING_LOSS_RTOL:.0e}: sums in "
            f"another order through 8 steps); s/iteration mesh {rows['mesh'][1]['sec']:.4f}, "
            f"one device {rows['one'][1]['sec']:.4f} [{card}]"
            + (f"; grad_norm mesh {rows['mesh'][0]['grad_norm']:.6e}, one device "
               f"{rows['one'][0]['grad_norm']:.6e} (no bound at horizon 8: ill-conditioned)"
               if algo == "apg" else ""))
        expect(rel < RING_LOSS_RTOL, f"{label}: the mesh loss agrees with one device's")
        if algo == "apg":
            hold_mesh_grads(label, env, mesh22)
    log("ring", f"peak device memory of the 2x2 trainers {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    log("ring", f"the ring path ran in {time.perf_counter() - t0:.2f} s")
    for part, needed in RING.items():
        log("ring", f"{part} launches {counts[part]}")
        missing = [k for k in needed if counts[part][k] == 0]
        if missing:
            raise AssertionError(f"the ring's {part} never launched {missing}")
    total = {k: sum(c[k] for c in counts.values()) for k in KERNEL_INFO}
    return total, runs


def hold_mesh_grads(label: str, env: VisionEnv, mesh) -> None:
    """APG diff_vision's parameter gradients at horizon 1 (where they are
    well conditioned) on `mesh` against one device's, same seed, at the
    trainers' width: the ring's composed backward (each hop's eye Function,
    merge_rows' routing, the gravity VJP's cross form, the copies'
    transposes) held at RING_GRAD_BOUND of their norm."""
    grads = {}
    for name, m in (("mesh", mesh), ("one", None)):
        ts = apg.init_apg_state(env, seed=0, device="cuda")
        apg.make_apg_step(env, horizon=1, num_envs=TRAIN_ENVS, mesh=m, diff_vision=True)(ts)
        grads[name] = torch.cat([p.grad.flatten() for p in ts.policy.parameters()])
    got, want = grads["mesh"], grads["one"]
    expect(bool(torch.isfinite(got).all()) and want.norm().item() > 0,
           f"{label}: finite nonzero gradients at horizon 1")
    rel = ((got - want).norm() / want.norm()).item()
    log("ring", f"{label} at {TRAIN_ENVS} x {TRAIN_AGENTS} x {TRAIN_WIDTH}, horizon 1: grad_norm "
        f"mesh {got.norm().item():.6e}, one device {want.norm().item():.6e}, |difference| / "
        f"|one device| {rel:.3e} (bound {RING_GRAD_BOUND:.0e})")
    expect(rel < RING_GRAD_BOUND, f"{label}: the mesh's gradients agree with one device's")


def rdma_mesh(cards: int):
    """The RDMA phases' agent axis: 4 shards of cuda:0 (cards=1), or one
    shard on each of the first `cards` cards."""
    devs = ([torch.device("cuda", 0)] * 4 if cards == 1
            else [torch.device("cuda", i) for i in range(cards)])
    return make_mesh({"agents": len(devs)}, devices=devs)


def rdma_rows_cases(gen, s2, cfg2, s5, cfg5):
    """(label, state, vision config, clustered) of the RDMA eye's shapes:
    config 2 and config-5 width as spawned, then each clustered, positions
    U(-8, 8) (the cull's worst case: every target reaches many pixels) and
    headings from U(-1, 1) velocities drawn from `gen`."""
    def clustered(st):
        return dataclasses.replace(st, pos=uniform(gen, st.pos.shape, -8, 8),
                                   vel=uniform(gen, st.vel.shape, -1, 1))
    c5 = f"config-5 width ({TRAIN_ENVS} x {TRAIN_AGENTS} x {TRAIN_WIDTH})"
    return [("config 2", s2, cfg2.vision, False), (c5, s5, cfg5.vision, False),
            ("config 2 clustered U(-8, 8)", clustered(s2), cfg2.vision, True),
            (f"{c5} clustered U(-8, 8)", clustered(s5), cfg5.vision, True)]


def rdma_row_bytes(pos, vel, vcfg: VisionConfig, shards: int) -> tuple:
    """(bytes, pixels a later hop wins): the row traffic of the RDMA eye on
    `shards` shards. Hop 0 writes both rows of every pixel (8 bytes); each
    later hop reads every pixel's depth (4 bytes, its keys' seeds) and
    writes both rows where one of its targets is strictly nearer (8 bytes).
    From the plain hop (rdma._disc_hop_plain) over chunks of 128 envs."""
    p_b, d_b = pos.chunk(shards, dim=-2), camera.unit_heading(vel).chunk(shards, dim=-2)
    envs = pos.shape[0] if pos.dim() == 3 else 1
    wins = 0
    for s in range(shards):
        for i in range(0, envs, 128):
            part = slice(i, i + 128) if pos.dim() == 3 else slice(None)
            best = None
            for k in range(shards):
                depth, _ = rdma._disc_hop_plain(p_b[s][part], d_b[s][part],
                                                p_b[(s - k) % shards][part], vcfg)
                if best is not None:
                    wins += int((depth < best).sum())
                best = depth if best is None else torch.minimum(best, depth)
    pixels = pos[..., 0].numel() * vcfg.width
    return 8 * pixels + 4 * pixels * (shards - 1) + 8 * wins, wins


def phase_rdma(errors: Errors, card: str, mesh4):
    """The RDMA ring (nenbody_tpu_torch.parallel.rdma) at full width on
    `mesh4` (rdma_mesh): gravity at config 4 (N=65,536), boids at N=65,536,
    disc rows at config 2 (N=1,024, W=64), and gravity and rows at config-5
    width (4,096 envs x 256 agents x 64 px), the rows also on clustered
    U(-8, 8) spawns (rdma_rows_cases), the inputs on cuda:0. The
    launch counts are set to 0 just before each call and read just after:
    one launch of the call's own kernel per card and nothing else. Each
    result is held against the kernel's plain version on the card (Errors,
    the kernels' max_abs_err), the per-hop ring and one device: the physics
    under the RING_* bounds, the rows at the eye's tolerances with no pixel
    flipped (hold_rows); then RDMA_REPEATS more launches must give the
    same bits.
    Returns the launch counts of the counted calls."""
    cards = len(set(mesh4.devices))
    gen = torch.Generator(device="cuda").manual_seed(6)
    counts = dict.fromkeys(KERNEL_INFO, 0)
    t0 = time.perf_counter()

    def counted(kind: str, fn):
        common.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = common.launch_counts()
        expect(got[RDMA_KERNEL[kind]] == cards and sum(got.values()) == cards,
               f"one launch of {RDMA_KERNEL[kind]} per card and nothing else, got {got}")
        for k, v in got.items():
            counts[k] += v
        return out

    def repeats(label: str, fn, first) -> None:
        first = first if isinstance(first, tuple) else (first,)
        for _ in range(RDMA_REPEATS):
            again = fn()
            again = again if isinstance(again, tuple) else (again,)
            expect(all(torch.equal(a, b) for a, b in zip(again, first)),
                   f"{label}: the same bits on every launch")
        torch.cuda.synchronize()
        log("rdma", f"{label}: {RDMA_REPEATS} more launches bit-identical to the first")

    with torch.no_grad():
        cfg4 = PRESETS["gravity-65536"]()
        pos = uniform(gen, (cfg4.n, 2), -100, 100)
        vel = uniform(gen, (cfg4.n, 2), 0, 0.1)
        cfg5 = PRESETS["envs-4096x256"]()
        s5 = Scene(cfg5, device="cuda").spawn_envs(TRAIN_ENVS, seed=0)
        for label, p, cfg in (("config 4 (N=65,536)", pos, cfg4),
                              (f"config-5 width ({TRAIN_ENVS} x {TRAIN_AGENTS})", s5.pos, cfg5)):
            run = lambda: rdma.rdma_ring_gravity_forces(p, cfg, mesh=mesh4)
            got = counted("gravity", run)
            errors.check_scaled("rdma_gravity", f"rdma gravity {label} vs its plain version", got,
                                rdma.rdma_ring_gravity_forces_plain(p, cfg, mesh=mesh4),
                                RING_GRAVITY_BOUND)
            hold_scaled(f"rdma gravity {label} vs the per-hop ring", got,
                        ring.ring_gravity_forces(p, cfg, mesh=mesh4), RING_GRAVITY_BOUND)
            hold_scaled(f"rdma gravity {label} vs one device", got,
                        pairwise.gravity_forces_tiled(p, cfg.gravity), RING_GRAVITY_BOUND)
            repeats(f"rdma gravity {label}", run, got)

        bcfg = SimConfig(n=cfg4.n, controller="boids")
        run = lambda: rdma.rdma_ring_boids_velocity(pos, vel, bcfg, mesh=mesh4)
        got = counted("boids", run)
        errors.check_scaled("rdma_boids", "rdma boids N=65,536 vs its plain version", got,
                            rdma.rdma_ring_boids_velocity_plain(pos, vel, bcfg, mesh=mesh4),
                            RING_BOIDS_BOUND)
        hold_scaled("rdma boids N=65,536 vs the per-hop ring", got,
                    ring.ring_boids_velocity(pos, vel, bcfg, mesh=mesh4), RING_BOIDS_BOUND)
        hold_scaled("rdma boids N=65,536 vs one device", got,
                    boids_ops.boids_velocity_tiled(pos, vel, bcfg.boids), RING_BOIDS_BOUND)
        repeats("rdma boids N=65,536", run, got)

        cfg2 = PRESETS["gravity-vision-1024"]()
        s2 = Scene(cfg2, device="cuda").spawn(0)
        for label, st, vcfg, clustered in rdma_rows_cases(gen, s2, cfg2, s5, cfg5):
            run = lambda: rdma.rdma_ring_render_rows(st.pos, st.vel, vcfg, mesh=mesh4)
            got = counted("rows", run)
            want = rdma.rdma_ring_render_rows_plain(st.pos, st.vel, vcfg, mesh=mesh4)
            errors.check("rdma_vision", f"rdma rows {label} depth vs its plain version", got[1],
                         want[1], 1e-5, 1e-4)
            errors.check("rdma_vision", f"rdma rows {label} shade vs its plain version", got[0],
                         want[0], 1e-5, 1e-5)
            expect(bool((got[1] < vcfg.far).any()), f"rdma rows {label}: sprites in view")
            # the clustered swarms put footprint edges on pixel centres, where
            # the RDMA arithmetic and the eye's may round apart (edge_witness)
            hold = (lambda lbl, g, w: hold_rows_edges(lbl, g, w, vcfg, st.pos, st.vel)
                    if clustered else hold_rows(lbl, g, w, vcfg))
            hold(f"rdma rows {label} vs the per-hop ring", got,
                 ring.ring_render_rows(st.pos, st.vel, vcfg, mesh=mesh4))
            hold(f"rdma rows {label} vs one device", got,
                 raycast.render_rows_tiled(st.pos, st.vel, vcfg))
            repeats(f"rdma rows {label}", run, got)
    log("rdma", f"the RDMA ring ran in {time.perf_counter() - t0:.2f} s; launches "
        f"{ {k: v for k, v in counts.items() if v} } [{card}]")
    return counts


def kernel_device_ms(fn, name: str, iters: int, per_call: int = 1) -> float:
    """Mean device time per launch of the kernel whose name holds `name`
    over `iters` calls of fn, `per_call` launches each, after one warm-up
    call (torch.profiler). A trace that misses launches (the profiler has
    dropped kernel events on the card) is taken again, PROFILE_TRACES
    times in all."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRACES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name]
        if len(times) == iters * per_call:
            return sum(times) / len(times) / 1e3
        log("times", f"the trace holds {len(times)} of {iters * per_call} launches of {name}; "
            f"tracing again ({attempt + 1} of {PROFILE_TRACES})")
    expect(False, f"{iters * per_call} traced launches of {name} in one of {PROFILE_TRACES} traces")


def rdma_gravity_launch(pos, mesh) -> str:
    """The RDMA gravity kernel's launch for pos [(B,) N, 2] on `mesh`: its
    plan (T threads, R rows a thread, units of one shard; rdma_gravity_plan,
    which the kernel's nbt_rdma_gravity_plan must equal), the blocks P of a
    shard that the launch sizes from the occupancy of that instantiation,
    and its registers a thread (nvcc -Xptxas -v). Empty for an older
    package (--kernel-times with another checkout first) that has no plan."""
    if not hasattr(rdma, "rdma_gravity_plan"):
        return ""
    devs = list(mesh.devices)
    nb, nl = pos[..., 0, 0].numel(), -(-pos.shape[-2] // len(devs))
    shards, sms = rdma._card_shape(devs)
    t, r, units = rdma.rdma_gravity_plan(nb, nl, shards, sms)
    out = (ctypes.c_int * 3)()
    lib = common.kernel_library()
    lib.call("nbt_rdma_gravity_plan", nb, nl, shards, sms, ctypes.addressof(out))
    expect(tuple(out) == (t, r, units), f"nbt_rdma_gravity_plan {tuple(out)} equals "
           f"rdma_gravity_plan {(t, r, units)} at {nb} x {nl} on {shards} shards a card")
    p = min(min(common.resident_blocks("rdma_gravity", t, c, r) for c in set(devs)) // shards,
            units)
    regs = registers_of(lib.ptxas_log, "rdma_ring.cu", f"rdma_gravity_kernelILi{t}ELi{r}E")
    return f"; plan T={t}, R={r}, P={p}, {units} units a shard; {regs} registers a thread"


def phase_rdma_times(gen, card: str, mesh4) -> dict:
    """The RDMA kernels on `mesh4` (rdma_mesh): each kernel's device time
    (torch.profiler, per launch) and its bound (one device's work), the
    plain version's time, and the RDMA call (its launches plus the split,
    gather and epilogue), the per-hop ring and one device alternated (CUDA
    events on cuda:0, whose stream the call joins), at the phase's shapes."""
    times = {}
    cards = len(set(mesh4.devices))
    where = "4 shards of one card" if cards == 1 else f"{cards} cards"
    cfg4 = PRESETS["gravity-65536"]()
    n = cfg4.n
    pos = uniform(gen, (n, 2), -100, 100)
    vel = uniform(gen, (n, 2), 0, 0.1)
    bcfg = SimConfig(n=n, controller="boids")
    cfg2 = PRESETS["gravity-vision-1024"]()
    s2 = Scene(cfg2, device="cuda").spawn(0)
    cfg5 = PRESETS["envs-4096x256"]()
    s5 = Scene(cfg5, device="cuda").spawn_envs(TRAIN_ENVS, seed=0)
    cases = [
        ("rdma_gravity", "gravity config 4 (N=65,536)",
         lambda: rdma.rdma_ring_gravity_forces(pos, cfg4, mesh=mesh4),
         lambda: rdma.rdma_ring_gravity_forces_plain(pos, cfg4, mesh=mesh4),
         lambda: ring.ring_gravity_forces(pos, cfg4, mesh=mesh4),
         lambda: pairwise.gravity_forces_tiled(pos, cfg4.gravity),
         bound(n * n * GRAVITY_OPS, 2 * nbytes(pos)), 5, rdma_gravity_launch(pos, mesh4)),
        ("rdma_gravity", f"gravity config-5 width ({TRAIN_ENVS} x {TRAIN_AGENTS})",
         lambda: rdma.rdma_ring_gravity_forces(s5.pos, cfg5, mesh=mesh4),
         lambda: rdma.rdma_ring_gravity_forces_plain(s5.pos, cfg5, mesh=mesh4),
         lambda: ring.ring_gravity_forces(s5.pos, cfg5, mesh=mesh4),
         lambda: pairwise.gravity_forces_tiled(s5.pos, cfg5.gravity),
         bound(TRAIN_ENVS * TRAIN_AGENTS ** 2 * GRAVITY_OPS, 2 * nbytes(s5.pos)), 20,
         rdma_gravity_launch(s5.pos, mesh4)),
        ("rdma_boids", "boids N=65,536",
         lambda: rdma.rdma_ring_boids_velocity(pos, vel, bcfg, mesh=mesh4),
         lambda: rdma.rdma_ring_boids_velocity_plain(pos, vel, bcfg, mesh=mesh4),
         lambda: ring.ring_boids_velocity(pos, vel, bcfg, mesh=mesh4),
         lambda: boids_ops.boids_velocity_tiled(pos, vel, bcfg.boids),
         bound(n * n * BOIDS_OPS, nbytes(pos, vel, vel)), 5, ""),
    ]
    for label, st, vcfg, _ in rdma_rows_cases(gen, s2, cfg2, s5, cfg5):
        # the eye's pixel work where a footprint covers the pixel, and the
        # bytes its hops move in the rows
        dirs = camera.unit_heading(st.vel)
        n_e = st.pos.shape[-2]
        moved, wins = rdma_row_bytes(st.pos, st.vel, vcfg, len(mesh4.devices))
        cases.append(
            ("rdma_vision", f"disc rows {label}",
             lambda st=st, vcfg=vcfg: rdma.rdma_ring_render_rows(st.pos, st.vel, vcfg,
                                                                  mesh=mesh4),
             lambda st=st, vcfg=vcfg: rdma.rdma_ring_render_rows_plain(st.pos, st.vel, vcfg,
                                                                        mesh=mesh4),
             lambda st=st, vcfg=vcfg: ring.ring_render_rows(st.pos, st.vel, vcfg, mesh=mesh4),
             lambda st=st, vcfg=vcfg: raycast.render_rows_tiled(st.pos, st.vel, vcfg),
             bound(st.pos[..., 0, 0].numel() * n_e * n_e * DISC_PAIR_OPS
                   + disc_covered(st.pos, dirs, vcfg) * DISC_PIXEL_OPS,
                   nbytes(st.pos, dirs) + 2 * st.pos[..., 0].numel() * vcfg.width * 4),
             20 if st.pos.dim() == 2 else 3,
             f"; row traffic {moved} bytes ({wins} pixels won at hops "
             f"1-{len(mesh4.devices) - 1}), {moved / PEAK_BYTES * 1e3:.4g} ms at the memory "
             f"rate"))
    for name, label, fn, plain, ring_fn, one_fn, b, iters, rows in cases:
        k_ms = kernel_device_ms(fn, name + "_kernel", iters, cards)
        p_ms, call_ms = alternate(plain, fn, 1, iters)
        one_ms, ring_ms = alternate(one_fn, ring_fn, iters, iters)
        log("times", f"{name} {label} on {where}: kernel {k_ms:.4f} ms (device time per "
            f"launch, {cards} per call), bound {b[0]:.4g} ms ({b[1]}){rows}; the RDMA call "
            f"{call_ms:.4f} ms; plain {p_ms:.3f} ms; the per-hop ring {ring_ms:.4f} ms; one "
            f"device {one_ms:.4f} ms [{card}]")
        times.setdefault(name, (k_ms, p_ms, *b))
    return times


APPEARANCE = {"observe_textured": ("disc_eye", "wireframe_eye"),
              "observe_rgb": ("disc_eye", "wireframe_eye"),
              "ring texture": ("disc_eye", "wireframe_eye"),
              "textured gradient": ("wireframe_eye", "wireframe_eye_bwd")}


def appearance_of(form: str, albedo, texture):
    """(albedo or None, texture or None) of an appearance form."""
    return (albedo if "albedo" in form else None), (texture if "texture" in form else None)


def phase_appearance_kernels(errors: Errors, gen) -> None:
    """The eye kernels' appearance forms against their plain versions on the
    card: the disc and the wireframe eye at their phase-3 shapes, AA off and
    on, with a distinct albedo per target, with a 32 x 32 checker texture,
    and with both (TEX_RTOL, TEX_ATOL; the depth equal to the bare kernel's:
    appearance moves no winner). Then the wireframe backward's gradients
    with albedo and texture against winner_pullback at config 2's shape and
    at config-5 width, AA off and on: the positions', headings' and
    albedo's at rtol 2e-4, atol 2e-4 of the largest (pullback_witness for
    the few near-degenerate edges); the texture's, a sum over every pixel,
    at config-5 width within TEX_GRAD_BOUND of its largest texel, and no
    farther from float64 than WITNESS_FACTOR times the plain version; at
    config 2's as the others."""
    tex = render.checker_texture(32, 4, device="cuda")
    for sprite, shapes in (("disc", EYE_SHAPES), ("wireframe", WF_SHAPES)):
        name = f"{sprite}_eye"
        for b, n, w in shapes:
            shape = (b, n, 2) if b > 1 else (n, 2)
            pos = uniform(gen, shape, -100, 100)
            dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
            albedo = uniform(gen, shape[:-1], 0.3, 1.0)
            for aa in (False, True):
                vcfg = VisionConfig(width=w, antialias=aa, sprite_mode=sprite)
                if sprite == "disc":
                    kernel = lambda *a: raycast.disc_eye(pos, dirs, pos, vcfg, *a)
                    plain = lambda *a: raycast.disc_eye_plain(pos, dirs, pos, vcfg, *a)
                else:
                    kernel = lambda *a: wireframe.wireframe_eye(pos, dirs, pos, dirs, vcfg, *a)
                    plain = lambda *a: wireframe.wireframe_eye_plain(pos, dirs, pos, dirs, vcfg,
                                                                     *a)[:2]
                bare = kernel()[1]
                for form in FORMS:
                    ap = appearance_of(form, albedo, tex)
                    (gs, gd), (ws, wd) = kernel(*ap), plain(*ap)
                    label = f"{name} {form} B={b} N={n} W={w} aa={aa}"
                    expect(torch.equal(gd, bare), f"{label}: the depth of the bare kernel")
                    errors.check(name, label + " depth", gd, wd, TEX_RTOL, TEX_ATOL)
                    errors.check(name, label + " shade", gs, ws, TEX_RTOL, TEX_ATOL)

    for b, n, w in ((1, 1024, 64), (TRAIN_ENVS, TRAIN_AGENTS, TRAIN_WIDTH)):
        shape = (b, n, 2) if b > 1 else (n, 2)
        pos = uniform(gen, shape, -100, 100)
        dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
        albedo = uniform(gen, shape[:-1], 0.3, 1.0)
        us = torch.randn(shape[:-1] + (w,), generator=gen, device="cuda")
        ud = torch.randn(shape[:-1] + (w,), generator=gen, device="cuda") * 1e-2
        for aa in (False, True):
            vcfg = VisionConfig(width=w, antialias=aa, sprite_mode="wireframe")
            ins = (pos, dirs, pos, dirs)
            _, _, winner = wireframe.wireframe_eye_with_winner(*ins, vcfg, albedo, tex)
            got = wireframe.wireframe_eye_vjp(*ins, winner, us, ud, vcfg, albedo, tex)
            want = wireframe.winner_pullback(*ins, winner, us, ud, vcfg, albedo, tex)
            label = f"wireframe_eye_bwd albedo+texture B={b} N={n} W={w} aa={aa}"
            for i, out in enumerate(("d_eye", "d_dir", "d_tgt", "d_hdg", "d_albedo")):
                atol = 2e-4 * want[i].abs().max().item()
                errors.check("wireframe_eye_bwd", f"{label} {out}", got[i], want[i], 2e-4, atol,
                             witness=pullback_witness(ins, winner, us, ud, vcfg, i, 2e-4, atol,
                                                      albedo, tex))
            if b == 1:
                errors.check("wireframe_eye_bwd", f"{label} d_texture", got[5], want[5], 2e-4,
                             2e-4 * want[5].abs().max().item())
                continue
            errors.check_scaled("wireframe_eye_bwd", f"{label} d_texture", got[5], want[5],
                                TEX_GRAD_BOUND)
            # float64 takes another branch at a few pixels (a hit, a winning
            # edge), each worth a whole pixel's share: the kernel must be no
            # farther from it than WITNESS_FACTOR times the plain version
            want64 = wireframe.winner_pullback(*(x.double() for x in ins), winner, us.double(),
                                               ud.double(), vcfg, albedo.double(),
                                               tex.double())[5]
            k_err, p_err = ((x.double() - want64).abs().max().item() for x in (got[5], want[5]))
            log("appearance", f"{label} d_texture vs float64: kernel max_abs_err {k_err:.3e}, "
                f"plain fp32 {p_err:.3e} (bound {WITNESS_FACTOR} x the plain's), "
                f"max|grad| {want64.abs().max().item():.3e}")
            expect(k_err <= WITNESS_FACTOR * p_err, f"{label} d_texture: as near float64 as "
                   f"the plain version")


def phase_appearance(errors: Errors, card: str) -> dict:
    """The appearance paths at full width through the user's entry points
    (module docstring), each with the launch counts set to 0 just before it
    and read just after; each output held against its plain version or one
    device. Returns the summed launch counts."""
    cuda = torch.device("cuda", 0)
    counts = {part: dict.fromkeys(KERNEL_INFO, 0) for part in APPEARANCE}
    gen = torch.Generator(device="cuda").manual_seed(7)
    tex = render.checker_texture(32, 4, device="cuda")
    t0 = time.perf_counter()

    def counted(part: str, fn):
        common.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for k, v in common.launch_counts().items():
            counts[part][k] += v
        return out

    cfg5, cfg2 = PRESETS["envs-4096x256"](), PRESETS["gravity-vision-1024"]()
    with torch.no_grad():
        for sprite in ("disc", "wireframe"):
            scene = Scene(cfg5 if sprite == "disc" else wf_cfg(cfg5), device="cuda")
            st = scene.spawn_envs(TRAIN_ENVS, seed=0)
            obs = counted("observe_textured", lambda: scene.observe_textured(st, tex))
            finite_cuda(f"observe_textured {sprite}", obs)
            expect(obs.shape == (TRAIN_ENVS, TRAIN_AGENTS, TRAIN_WIDTH),
                   f"observe_textured {sprite} [4096, 256, 64]")
            bare = scene.observe(st)
            changed = (obs != bare).double().mean().item()
            log("appearance", f"observe_textured {sprite} at config-5 width: {changed:.3f} of the "
                f"pixels differ from observe's")
            expect(changed > 0.01, f"observe_textured {sprite}: the skin shows")
            part = slice(0, 64)
            dirs = camera.unit_heading(st.vel[part])
            plain = (wireframe.wireframe_eye_plain(st.pos[part], dirs, st.pos[part], dirs,
                                                   scene.cfg.vision, None, tex)
                     if sprite == "wireframe" else
                     raycast.disc_eye_plain(st.pos[part], dirs, st.pos[part], scene.cfg.vision,
                                            None, tex))
            errors.check(f"{sprite}_eye", f"observe_textured {sprite} envs[0:64] vs the plain "
                         f"version", obs[part], plain[0], TEX_RTOL, TEX_ATOL)

        colors = render.default_agent_colors(cfg2.n, device="cuda")
        for sprite in ("disc", "wireframe"):
            scene = Scene(cfg2 if sprite == "disc" else wf_cfg(cfg2), device="cuda")
            st = scene.spawn(0)
            rgb = counted("observe_rgb", lambda: scene.observe_rgb(st, colors))
            finite_cuda(f"observe_rgb {sprite}", rgb)
            expect(rgb.shape == (cfg2.n, cfg2.vision.width, 3), f"observe_rgb {sprite} [1024, 64, 3]")
            want = render.render_rows_rgb(st.pos, st.vel, scene.cfg.vision, colors, backend="dense")
            errors.check(f"{sprite}_eye", f"observe_rgb {sprite} config 2 vs the plain version",
                         rgb, want, 1e-5, 2e-4)

        mesh4 = make_mesh({"agents": 4}, devices=[cuda] * 4)
        st = Scene(cfg2, device="cuda").spawn(0)
        for sprite in ("disc", "wireframe"):
            vcfg = dataclasses.replace(cfg2.vision, sprite_mode=sprite)
            one = (wireframe.render_rows_wireframe_tiled(st.pos, st.vel, vcfg, texture=tex)
                   if sprite == "wireframe" else
                   raycast.render_rows_tiled(st.pos, st.vel, vcfg, texture=tex))
            got = counted("ring texture", lambda: ring.ring_render_rows(st.pos, st.vel, vcfg,
                                                                        mesh=mesh4, texture=tex))
            hold_rows(f"ring_render_rows(texture=) {sprite} config 2 (4 shards)", got, one, vcfg)

    vcfg = VisionConfig(width=TRAIN_WIDTH, antialias=True, sprite_mode="wireframe")
    st = Scene(wf_cfg(cfg5, antialias=True), device="cuda").spawn_envs(TRAIN_ENVS, seed=1)
    leaves = [st.pos.clone().requires_grad_(), st.vel.clone().requires_grad_(),
              uniform(gen, (TRAIN_ENVS, TRAIN_AGENTS), 0.3, 1.0).requires_grad_(),
              tex.clone().requires_grad_()]

    def textured_gradient():
        shade, depth = wireframe.render_rows_wireframe_diff(*leaves[:2], vcfg, *leaves[2:])
        ((shade - vcfg.background).mean() + 1e-4 * depth.mean()).backward()

    torch.cuda.reset_peak_memory_stats()
    counted("textured gradient", textured_gradient)
    for x, name in zip(leaves, ("pos", "vel", "albedo", "texture")):
        g = x.grad
        finite_cuda(f"textured gradient d {name}", g)
        expect(g.abs().max().item() > 0, f"textured gradient: nonzero d {name}")
        log("appearance", f"textured gradient at config-5 width (AA): max|d {name}| "
            f"{g.abs().max().item():.6e}, |d {name}| {g.norm().item():.6e}")
    log("appearance", f"the appearance paths ran in {time.perf_counter() - t0:.2f} s; peak "
        f"device memory of the gradient {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
        f"[{card}]")
    for part, needed in APPEARANCE.items():
        log("appearance", f"{part} launches { {k: v for k, v in counts[part].items() if v} }")
        missing = [k for k in needed if counts[part][k] == 0]
        if missing:
            raise AssertionError(f"the appearance path {part} never launched {missing}")
    return {k: sum(c[k] for c in counts.values()) for k in KERNEL_INFO}


def phase_appearance_times(gen, card: str) -> dict:
    """CUDA-event times of each eye kernel's appearance forms against their
    plain versions, with their bounds (the bare eye's work, plus per shaded
    pixel the albedo's product and the sample's operations, plus the albedo
    and texture bytes): the eyes at config 2 (N=1,024, W=64, AA off, the
    kernels line's shape), the wireframe backward at config-5 width with
    antialias; then Scene.observe_textured at config-5 width against
    observe. Returns forms[kernel][form] = {ms, plain_ms, bound_ms,
    bound_by}."""
    forms = {name: {} for name in ("disc_eye", "wireframe_eye", "wireframe_eye_bwd")}
    tex = render.checker_texture(32, 4, device="cuda")
    n_e, w = 1024, 64
    epos = uniform(gen, (n_e, 2), -100, 100)
    dirs = camera.unit_heading(uniform(gen, (n_e, 2), -1, 1))
    albedo = uniform(gen, (n_e,), 0.3, 1.0)
    for sprite in ("disc", "wireframe"):
        vcfg = VisionConfig(width=w, sprite_mode=sprite)
        name = f"{sprite}_eye"
        if sprite == "disc":
            kernel = lambda *a: raycast.disc_eye(epos, dirs, epos, vcfg, *a)
            plain = lambda *a: raycast.disc_eye_plain(epos, dirs, epos, vcfg, *a)
            ops = n_e * n_e * DISC_PAIR_OPS + disc_covered(epos, dirs, vcfg) * DISC_PIXEL_OPS
        else:
            kernel = lambda *a: wireframe.wireframe_eye(epos, dirs, epos, dirs, vcfg, *a)
            plain = lambda *a: wireframe.wireframe_eye_plain(epos, dirs, epos, dirs, vcfg, *a)
            ops = (n_e * n_e * WF_PAIR_OPS
                   + wireframe_covered(epos, dirs, vcfg) * 3 * WF_EDGE_OPS)
        hits = int((kernel()[1] < vcfg.far).sum())
        for form in FORMS:
            alb, t = appearance_of(form, albedo, tex)
            p_ms, k_ms = alternate(lambda: plain(alb, t), lambda: kernel(alb, t), 2, 10)
            b = bound(ops + hits * ((ALBEDO_OPS if alb is not None else 0)
                                    + (TEX_SAMPLE_OPS if t is not None else 0)),
                      nbytes(epos, dirs, *[x for x in (alb, t) if x is not None])
                      + 2 * n_e * w * 4)
            forms[name][form] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b[0], bound_by=b[1])
            log("times", f"{name} {form} N={n_e} W={w}: kernel {k_ms:.3f} ms; plain {p_ms:.3f} ms; "
                f"bound {b[0]:.4g} ms ({b[1]}) [{card}]")

    shape = (TRAIN_ENVS, TRAIN_AGENTS, 2)
    epos = uniform(gen, shape, -100, 100)
    dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
    albedo = uniform(gen, shape[:-1], 0.3, 1.0)
    us = torch.randn(shape[:-1] + (TRAIN_WIDTH,), generator=gen, device="cuda")
    ud = torch.randn(shape[:-1] + (TRAIN_WIDTH,), generator=gen, device="cuda") * 1e-2
    vcfg = VisionConfig(width=TRAIN_WIDTH, antialias=True, sprite_mode="wireframe")
    ins = (epos, dirs, epos, dirs)
    _, _, winner = wireframe.wireframe_eye_with_winner(*ins, vcfg)
    live = int((winner >= 0).sum())
    for form in FORMS:
        alb, t = appearance_of(form, albedo, tex)
        p_ms, k_ms = alternate(
            lambda: wireframe.winner_pullback(*ins, winner, us, ud, vcfg, alb, t),
            lambda: wireframe.wireframe_eye_vjp(*ins, winner, us, ud, vcfg, alb, t), 1, 10)
        b = bound(live * (WF_BWD_PIXEL_OPS + (3 * ALBEDO_OPS if alb is not None else 0)
                          + (3 * TEX_SAMPLE_OPS if t is not None else 0)),
                  nbytes(epos, dirs, winner, us, ud) + 4 * nbytes(epos)
                  + 2 * nbytes(*[x for x in (alb, t) if x is not None]))
        forms["wireframe_eye_bwd"][form] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b[0],
                                                bound_by=b[1])
        log("times", f"wireframe_eye_bwd {form} {TRAIN_ENVS} x {TRAIN_AGENTS} x {TRAIN_WIDTH} "
            f"aa=True ({live} live pixels): kernel {k_ms:.3f} ms; plain (winner_pullback) "
            f"{p_ms:.3f} ms; bound {b[0]:.4g} ms ({b[1]}) [{card}]")

    cfg5 = PRESETS["envs-4096x256"]()
    for sprite in ("disc", "wireframe"):
        scene = Scene(cfg5 if sprite == "disc" else wf_cfg(cfg5), device="cuda")
        st = scene.spawn_envs(TRAIN_ENVS, seed=0)
        bare, textured = alternate(lambda: scene.observe(st),
                                   lambda: scene.observe_textured(st, tex), 3, 3)
        log("times", f"Scene.observe_textured {sprite} at config-5 width ({TRAIN_ENVS} x "
            f"{TRAIN_AGENTS} x {TRAIN_WIDTH}, 32 x 32 texture): {textured:.3f} ms; observe "
            f"{bare:.3f} ms ({textured / bare - 1:+.2%}) [{card}]")
    return forms


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


def graph_ms(fn, launches: int) -> float:
    """ms per call of fn from CUDA events around replays of a CUDA graph of
    `launches` calls: the device time alone, without the wrapper's host
    time, which exceeds a small kernel's (the mean of 3 replays after a
    warm-up call and a warm-up replay)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (3 * launches)
    del graph
    torch.cuda.empty_cache()
    return ms


def alternate_graph(plain, kernel, iters_plain: int, launches: int):
    """(plain ms, kernel ms) in the order plain, kernel, kernel, plain: the
    plain version as `alternate` times it, the kernel by graph_ms."""
    p1 = cuda_ms(plain, iters_plain)
    k1 = graph_ms(kernel, launches)
    k2 = graph_ms(kernel, launches)
    p2 = cuda_ms(plain, iters_plain)
    return (p1 + p2) / 2, (k1 + k2) / 2


def alternate(plain, kernel, iters_plain: int, iters_kernel: int):
    """(plain ms, kernel ms), each the mean of two runs in the order plain,
    kernel, kernel, plain."""
    p1 = cuda_ms(plain, iters_plain)
    k1 = cuda_ms(kernel, iters_kernel)
    k2 = cuda_ms(kernel, iters_kernel)
    p2 = cuda_ms(plain, iters_plain)
    return (p1 + p2) / 2, (k1 + k2) / 2


def shape_entry(shape: str, k_ms: float, p_ms: float, b_ms: float) -> dict:
    return {"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms}


def phase_kernel_times(gen, card: str, groups=TIME_GROUPS):
    """The serving path's gravity, disc eye, wireframe eye and boids, the
    gravity VJP and the boids partials at the main paths' shapes, each
    kernel's device time (graph_ms) alternated with its plain version (not
    timed for the wireframe eye at config-5 width, where it takes minutes),
    each with its bound, then the eye backward kernels', for the TIME_GROUPS
    in `groups`: (times of the `kernels` line's shapes, {kernel: per-shape
    entries})."""
    times, shapes = {}, {"gravity": [], "disc_eye": [], "wireframe_eye": [], "boids": [],
                         "gravity_vjp": [], "boids_partials": [], "disc_eye_bwd": [],
                         "wireframe_eye_bwd": []}
    timed = lambda group, table: table if group in groups else []
    gcfg = GravityConfig()
    for b, n in timed("gravity", GRAVITY_TIME_SHAPES):
        pos = uniform(gen, (b, n, 2) if b > 1 else (n, 2), -100, 100)
        p_ms, k_ms = alternate_graph(lambda: pairwise.gravity_forces_plain(pos, gcfg),
                                     lambda: pairwise.gravity_forces_tiled(pos, gcfg), 2, 20)
        b_ms, b_by = bound(b * n * n * GRAVITY_OPS, 2 * nbytes(pos))
        label = f"{b} x {n}" if b > 1 else f"N={n}"
        shapes["gravity"].append(shape_entry(label, k_ms, p_ms, b_ms))
        if (b, n) == (1, 65536):
            times["gravity"] = (k_ms, p_ms, b_ms, b_by)
        log("times", f"gravity {label}: kernel {k_ms:.4f} ms = {b * n * n / k_ms * 1e3:.4e} pair "
            f"evals/s; plain {p_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}) [{card}]")

    for label, b, n_e, w, half in timed("disc_eye", DISC_TIME_SHAPES):
        shape = (b, n_e, 2) if b > 1 else (n_e, 2)
        epos = uniform(gen, shape, -half, half)
        dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
        for aa in (False, True):
            vcfg = VisionConfig(width=w, antialias=aa)
            big = b * n_e * n_e * w > 1 << 28
            p_ms, k_ms = alternate_graph(lambda: raycast.disc_eye_plain(epos, dirs, epos, vcfg),
                                         lambda: raycast.disc_eye(epos, dirs, epos, vcfg),
                                         1 if big else 2, 10 if big else 20)
            covered = disc_covered(epos, dirs, vcfg)
            b_ms, b_by = bound(b * n_e * n_e * DISC_PAIR_OPS + covered * DISC_PIXEL_OPS,
                               nbytes(epos, dirs) + 2 * b * n_e * w * 4)
            shapes["disc_eye"].append(shape_entry(f"{label} {b} x {n_e} x {w} aa={aa}",
                                                  k_ms, p_ms, b_ms))
            if (b, n_e, w, half, aa) == (1, 1024, 64, 100, False):
                times["disc_eye"] = (k_ms, p_ms, b_ms, b_by)
            log("times", f"disc_eye {label} B={b} N={n_e} W={w} U(-{half}, {half}) aa={aa}: "
                f"kernel {k_ms:.4f} ms = {b * n_e / k_ms * 1e3:.4e} agent-frames/s; plain "
                f"{p_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}; {covered} covered pixels) "
                f"[{card}]")

    for label, b, n_e, w, half in timed("wireframe_eye", WF_TIME_SHAPES):
        shape = (b, n_e, 2) if b > 1 else (n_e, 2)
        epos = uniform(gen, shape, -half, half)
        dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
        for aa in (False, True):
            vcfg = VisionConfig(width=w, antialias=aa, sprite_mode="wireframe")
            kernel = lambda: wireframe.wireframe_eye(epos, dirs, epos, dirs, vcfg)
            if b == TRAIN_ENVS:
                p_ms, k_ms = None, (graph_ms(kernel, 5) + graph_ms(kernel, 5)) / 2
            else:
                big = b * n_e * n_e * w > 1 << 26
                p_ms, k_ms = alternate_graph(
                    lambda: wireframe.wireframe_eye_plain(epos, dirs, epos, dirs, vcfg), kernel,
                    1 if big else 2, 10 if big else 20)
            ops = (b * n_e * n_e * (WF_PAIR_AA_OPS if aa else WF_PAIR_OPS)
                   + wireframe_covered(epos, dirs, vcfg) * 3 * WF_EDGE_OPS)
            b_ms, b_by = bound(ops, nbytes(epos, dirs) + 2 * b * n_e * w * 4)
            where = f"{label} U(-{half}, {half}) {b} x {n_e} x {w} aa={aa}"
            shapes["wireframe_eye"].append(shape_entry(where, k_ms, p_ms, b_ms))
            if (b, n_e, w, half, aa) == (1, 1024, 64, 100, False):
                times["wireframe_eye"] = (k_ms, p_ms, b_ms, b_by)
            plain = "not timed" if p_ms is None else f"{p_ms:.4f} ms"
            log("times", f"wireframe_eye {where}: kernel {k_ms:.4f} ms = "
                f"{b * n_e / k_ms * 1e3:.4e} agent-frames/s; plain {plain}; bound {b_ms:.5f} ms "
                f"({b_by}) [{card}]")

    bcfg = BoidsConfig()
    for label, b, n, half in timed("boids", BOIDS_TIME_SHAPES):
        shape = (b, n, 2) if b > 1 else (n, 2)
        pos = uniform(gen, shape, -half, half)
        vel = uniform(gen, shape, -1, 1)
        big = b * n * n > 1 << 26
        p_ms, k_ms = alternate_graph(lambda: boids_ops.boids_velocity_plain(pos, vel, bcfg),
                                     lambda: boids_ops.boids_velocity_tiled(pos, vel, bcfg),
                                     1 if big else 3, 10 if big else 20)
        b_ms, b_by = bound(b * n * n * BOIDS_OPS, nbytes(pos, vel, vel))
        shapes["boids"].append(shape_entry(f"{label} {b} x {n} U(-{half}, {half})", k_ms, p_ms,
                                           b_ms))
        if (b, n, half) == (1, 4096, 100):
            times["boids"] = (k_ms, p_ms, b_ms, b_by)
        log("times", f"boids {label} B={b} N={n} U(-{half}, {half}): kernel {k_ms:.4f} ms = "
            f"{b * n * n / k_ms * 1e3:.4e} pair evals/s; plain {p_ms:.4f} ms; bound "
            f"{b_ms:.5f} ms ({b_by}) [{card}]")
    vjp_and_partials_times(card, shapes, timed("gravity_vjp", VJP_TIME_SHAPES),
                      timed("boids_partials", PARTIALS_TIME_SHAPES))
    if "backward" in groups:
        backward_kernel_times(gen, card, times, shapes)
    return times, shapes


def vjp_and_partials_times(card: str, shapes: dict, vjp_shapes, partials_shapes) -> None:
    """The gravity VJP (self form; the cross form's two launches where M is
    given) at `vjp_shapes` and the boids partials at `partials_shapes`: each
    call's device time (graph_ms) alternated with its plain version, with
    the bound (the cross form counts both launches' pair terms), appended to
    shapes["gravity_vjp"] and shapes["boids_partials"]; then, with the
    partials, the ring boids step at N=65,536 on 4 shards of one card
    against one device (`alternate`). Inputs from a generator of their
    own."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    gcfg, bcfg = GravityConfig(), BoidsConfig()
    for label, b, n, m in vjp_shapes:
        lead = (b,) if b > 1 else ()
        pos = uniform(gen, lead + (n, 2), -100, 100)
        u = torch.randn(lead + (n, 2), generator=gen, device="cuda")
        if m is None:
            plain = lambda: pairwise.gravity_vjp_plain(pos, u, gcfg)
            kernel = lambda: pairwise.gravity_vjp_tiled(pos, u, gcfg)
            pairs, moved, where = b * n * n, nbytes(pos, u, u), f"{label} {b} x {n}"
        else:
            pos_j = uniform(gen, lead + (m, 2), -100, 100)
            plain = lambda: pairwise.gravity_vjp_cross_plain(pos, pos_j, u, gcfg)
            kernel = lambda: pairwise.gravity_vjp_cross_tiled(pos, pos_j, u, gcfg)
            pairs, moved = 2 * b * n * m, nbytes(pos, pos_j, u, pos, pos_j)
            where = f"{label} {b} x {n} x {m} cross (two launches)"
        big = pairs > 1 << 28
        p_ms, k_ms = alternate_graph(plain, kernel, 1 if big else 2, 5 if big else 20)
        b_ms, b_by = bound(pairs * GRAVITY_VJP_OPS, moved)
        shapes["gravity_vjp"].append(shape_entry(where, k_ms, p_ms, b_ms))
        log("times", f"gravity_vjp {where}: kernel {k_ms:.4f} ms = {pairs / k_ms * 1e3:.4e} pair "
            f"terms/s; plain {p_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}), kernel/bound "
            f"{k_ms / b_ms:.2f} [{card}]")
    for label, b, n, m, excl in partials_shapes:
        lead = (b,) if b > 1 else ()
        pi, vi = uniform(gen, lead + (n, 2), -100, 100), uniform(gen, lead + (n, 2), -1, 1)
        pj, vj = ((pi, vi) if excl else
                  (uniform(gen, lead + (m, 2), -100, 100), uniform(gen, lead + (m, 2), -1, 1)))
        p_ms, k_ms = alternate_graph(
            lambda: boids_ops.boids_partials_plain(pi, vi, pj, vj, bcfg, excl),
            lambda: boids_ops.boids_partials_tiled(pi, vi, pj, vj, bcfg, excl),
            1 if b * n * m > 1 << 26 else 3, 20)
        moved = nbytes(pi, vi) + (0 if excl else nbytes(pj, vj)) + 4 * b * n * 8
        b_ms, b_by = bound(b * n * m * BOIDS_OPS, moved)
        where = f"{label} {b} x {n} x {m} exclude_diagonal={excl} U(-100, 100)"
        shapes["boids_partials"].append(shape_entry(where, k_ms, p_ms, b_ms))
        log("times", f"boids_partials {where}: kernel {k_ms:.4f} ms = "
            f"{b * n * m / k_ms * 1e3:.4e} pair evals/s; plain {p_ms:.4f} ms; bound "
            f"{b_ms:.5f} ms ({b_by}), kernel/bound {k_ms / b_ms:.2f} [{card}]")
    if partials_shapes:
        # the ring boids step the partials serve: N=65,536 on 4 shards of one
        # card (16 launches), against one device's fused kernel
        mesh4 = make_mesh({"agents": 4}, devices=[torch.device("cuda", 0)] * 4)
        cfg = SimConfig(n=65536, controller="boids")
        pos, vel = uniform(gen, (cfg.n, 2), -100, 100), uniform(gen, (cfg.n, 2), -1, 1)
        o_ms, r_ms = alternate(lambda: boids_ops.boids_velocity_tiled(pos, vel, cfg.boids),
                               lambda: ring.ring_boids_velocity(pos, vel, cfg, mesh=mesh4), 2, 5)
        log("times", f"ring boids N=65536 on 4 shards of one card: {r_ms:.3f} ms; one device "
            f"{o_ms:.3f} ms [{card}]")


def backward_kernel_times(gen, card: str, times: dict, shapes: dict) -> None:
    """The two eye backward kernels' device times (graph_ms: CUDA events
    around a CUDA graph of 5-20 calls, each the launch and the memsets that
    zero its outputs) at their main paths' shapes, AA off and on, and the
    wireframe's with a texture at the trainers' shape, alternated with the
    plain version (CUDA events; not timed for the disc where its dense
    renderer would hold more than 2^31 (eye, target, pixel) triples, as at
    config-5 width), with the bound; appended to shapes["disc_eye_bwd"] and
    shapes["wireframe_eye_bwd"]. At the `kernels` line's shapes (the disc
    at config 2, AA off; the wireframe at the trainers' shape, AA on, APG
    diff_vision's setting) times also gets the kernel's `ms` from CUDA
    events around a host loop of 10 calls, the wrapper's host time
    included, alternated with the plain version."""
    tex = render.checker_texture(32, 4, device="cuda")
    for sprite, table in (("disc", DISC_BWD_TIME_SHAPES), ("wireframe", WF_BWD_TIME_SHAPES)):
        name = f"{sprite}_eye_bwd"
        for label, b, n_e, w in table:
            shape = (b, n_e, 2) if b > 1 else (n_e, 2)
            epos = uniform(gen, shape, -100, 100)
            dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
            us = torch.randn(shape[:-1] + (w,), generator=gen, device="cuda")
            ud = torch.randn(shape[:-1] + (w,), generator=gen, device="cuda") * 1e-2
            forms = [(aa, None) for aa in (False, True)]
            if sprite == "wireframe" and b == TRAIN_ENVS:
                forms.append((True, tex))
            for aa, t in forms:
                vcfg = VisionConfig(width=w, antialias=aa, sprite_mode=sprite)
                if sprite == "disc":
                    _, _, winner = raycast.disc_eye_with_winner(epos, dirs, epos, vcfg)
                    kernel = lambda: raycast.render_rows_vjp_cross(epos, dirs, winner, us, ud,
                                                                   vcfg)
                    plain = None
                    if b * n_e * n_e * w <= 2 ** 31:
                        plain = lambda: raycast.render_rows_vjp_cross_plain(epos, dirs, us, ud,
                                                                            vcfg)
                    ops = DISC_BWD_PIXEL_OPS
                    moved = nbytes(epos, dirs, winner, us, ud) + 3 * nbytes(epos)
                else:
                    ins = (epos, dirs, epos, dirs)
                    _, _, winner = wireframe.wireframe_eye_with_winner(*ins, vcfg, None, t)
                    kernel = lambda: wireframe.wireframe_eye_vjp(*ins, winner, us, ud, vcfg,
                                                                 None, t)
                    plain = lambda: wireframe.winner_pullback(*ins, winner, us, ud, vcfg, None, t)
                    ops = ((WF_BWD_PIXEL_OPS if aa else WF_BWD_PIXEL_OPS_NOAA)
                           + (3 * TEX_SAMPLE_OPS if t is not None else 0))
                    moved = (nbytes(epos, dirs, winner, us, ud) + 4 * nbytes(epos)
                             + (2 * nbytes(t) if t is not None else 0))
                live = int((winner >= 0).sum())
                launches = 5 if b == TRAIN_ENVS else 20
                iters = 1 if b == TRAIN_ENVS else 3
                b_ms, b_by = bound(live * ops, moved)
                if (sprite, b, n_e, aa, t) in (("disc", 1, 1024, False, None),
                                               ("wireframe", TRAIN_ENVS, TRAIN_AGENTS, True, None)):
                    p_ms, h_ms = alternate(plain, kernel, iters, 10)
                    times[name] = (h_ms, p_ms, b_ms, b_by)
                    log("times", f"{name} {label} aa={aa}: the `kernels` line's ms (a host "
                        f"loop of 10 calls) {h_ms:.4f} [{card}]")
                    k_ms = (graph_ms(kernel, launches) + graph_ms(kernel, launches)) / 2
                elif plain is None:
                    p_ms = None
                    k_ms = (graph_ms(kernel, launches) + graph_ms(kernel, launches)) / 2
                else:
                    p_ms, k_ms = alternate_graph(plain, kernel, iters, launches)
                where = (f"{label} {b} x {n_e} x {w} aa={aa}"
                         + (" texture 32 x 32" if t is not None else ""))
                shapes[name].append(shape_entry(where, k_ms, p_ms, b_ms))
                shown = "not timed" if p_ms is None else f"{p_ms:.4f} ms"
                log("times", f"{name} {where} ({live} live pixels): kernel {k_ms:.4f} ms = "
                    f"{b * n_e / k_ms * 1e3:.4e} agent-frames/s; plain {shown}; bound "
                    f"{b_ms:.5f} ms ({b_by}), kernel/bound {k_ms / b_ms:.2f} [{card}]")


def log_wireframe_culls(gen, card: str) -> None:
    """The wireframe eye's culls at the timed shapes, from their plain models
    on the card (the kernel computes the same expressions): the share of
    (eye, target) pairs the frustum test keeps, and the mean pixel range (the
    union of its edges') per kept sprite."""
    for label, b, n_e, w, half in WF_TIME_SHAPES:
        shape = (min(b, 128), n_e, 2) if b > 1 else (n_e, 2)
        pos = uniform(gen, shape, -half, half)
        dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
        for aa in (False, True):
            vcfg = VisionConfig(width=w, antialias=aa, sprite_mode="wireframe")
            maybe = wireframe.wireframe_maybe_visible(pos, dirs, pos, vcfg)
            lo, hi = wireframe.wireframe_pixel_ranges(pos, dirs, pos, dirs, vcfg)
            width = (hi.max(-1).values - lo.min(-1).values + 1).clamp(min=0)
            kept = maybe.double().mean().item()
            mean = (width * maybe).sum().item() / max(1, int(maybe.sum()))
            log("times", f"wireframe culls {label} U(-{half}, {half}) {shape[0] if b > 1 else 1} "
                f"x {n_e} x {w} aa={aa}: frustum test keeps {kept:.4f} of the pairs; mean "
                f"pixel range per kept sprite {mean:.3f} px [{card}]")


def serving_ms(preset: str, steps: int, envs: int | None = None, variant: str = "disc") -> float:
    """ms per Scene step + observe (step alone without an eye) of `preset`
    with the disc or the wireframe sprite, or (variant "ring") with the disc
    on backend "ring" over default_mesh(): the host clock around `steps`
    steps ending in a synchronize, the median of 5 runs after one of
    warm-up."""
    cfg = PRESETS[preset]()
    if variant == "wireframe":
        cfg = wf_cfg(cfg)
    elif variant == "ring":
        cfg = dataclasses.replace(cfg, backend="ring")
    scene = Scene(cfg, device="cuda")
    state = scene.spawn(0) if envs is None else scene.spawn_envs(envs, seed=0)

    def run() -> float:
        s = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            s = scene.step(s)
            if scene.cfg.vision is not None:
                scene.observe(s)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    run()
    runs = sorted(run() for _ in range(5))
    return runs[2]


def log_serving(card: str) -> None:
    for label, preset, steps, envs, variant in SERVING_STEPS:
        log("times", f"serving {label}: {serving_ms(preset, steps, envs, variant):.4f} ms per step "
            f"+ observe, median of 5 runs of {steps} steps [{card}]")


def phase_times(gen, card: str) -> dict:
    times = {}
    n = 65536
    pos = uniform(gen, (n, 2), -100, 100)
    gcfg = GravityConfig()

    # the gravity VJP against its plain version
    u = torch.randn((n, 2), generator=gen, device="cuda")
    p_ms, k_ms = alternate(lambda: pairwise.gravity_vjp_plain(pos, u, gcfg),
                           lambda: pairwise.gravity_vjp_tiled(pos, u, gcfg), 2, 5)
    times["gravity_vjp"] = (k_ms, p_ms, *bound(n * n * GRAVITY_VJP_OPS, nbytes(pos, u, u)))
    log("times", f"gravity_vjp N=65536: kernel {k_ms:.3f} ms = {n * n / k_ms * 1e3:.4e} pair "
        f"evals/s; plain {p_ms:.3f} ms = {n * n / p_ms * 1e3:.4e} pair evals/s [{card}]")
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

    # what writing the winner index costs the wireframe eye at the trainers' shape
    shape = (TRAIN_ENVS, TRAIN_AGENTS, 2)
    epos = uniform(gen, shape, -100, 100)
    dirs = camera.unit_heading(uniform(gen, shape, -1, 1))
    for aa in (False, True):
        vcfg = VisionConfig(width=TRAIN_WIDTH, antialias=aa, sprite_mode="wireframe")
        bare, with_winner = alternate(
            lambda: wireframe.wireframe_eye(epos, dirs, epos, dirs, vcfg),
            lambda: wireframe.wireframe_eye_with_winner(epos, dirs, epos, dirs, vcfg), 5, 5)
        log("times", f"wireframe_eye {TRAIN_ENVS} x {TRAIN_AGENTS} x {TRAIN_WIDTH} aa={aa}: "
            f"without the winner index {bare:.3f} ms, writing it {with_winner:.3f} ms "
            f"({with_winner / bare - 1:+.2%}) [{card}]")

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
    log_serving(card)
    return times


def phase_ring_times(gen, card: str) -> dict:
    """CUDA-event times of the ring's kernels against their plain versions
    (the boids partials and the gravity VJP's cross form at one hop's shape;
    the wireframe backward's are backward_kernel_times'), and of the ring on
    4 shards of one card against one device."""
    times = {}
    gcfg, bcfg = GravityConfig(), BoidsConfig()
    n_r = RING_PAIRS
    pi, vi = uniform(gen, (n_r, 2), -100, 100), uniform(gen, (n_r, 2), -1, 1)
    p_ms, k_ms = alternate(lambda: boids_ops.boids_partials_plain(pi, vi, pi, vi, bcfg),
                           lambda: boids_ops.boids_partials_tiled(pi, vi, pi, vi, bcfg), 2, 10)
    times["boids_partials"] = (k_ms, p_ms, *bound(n_r * n_r * BOIDS_OPS,
                                                  nbytes(pi, vi) + 4 * n_r * (2 + 1 + 2 + 2 + 1)))
    log("times", f"boids_partials {n_r} x {n_r} (one ring hop at N=65,536 on 4 shards): kernel "
        f"{k_ms:.3f} ms = {n_r * n_r / k_ms * 1e3:.4e} pair evals/s; plain {p_ms:.3f} ms "
        f"[{card}]")
    pj = uniform(gen, (n_r, 2), -100, 100)
    ui = torch.randn((n_r, 2), generator=gen, device="cuda")
    p_ms, k_ms = alternate(lambda: pairwise.gravity_vjp_cross_plain(pi, pj, ui, gcfg),
                           lambda: pairwise.gravity_vjp_cross_tiled(pi, pj, ui, gcfg), 1, 10)
    log("times", f"gravity_vjp cross {n_r} x {n_r}: kernel {k_ms:.3f} ms (two launches of the "
        f"pair loop) = {n_r * n_r / k_ms * 1e3:.4e} pair evals/s; plain (autograd through the "
        f"dense cross form) {p_ms:.3f} ms [{card}]")
    # the ring on 4 shards of one card against one device: the same work
    # split into hops, so the gap is the ring's own cost
    cuda = torch.device("cuda", 0)
    mesh4 = make_mesh({"agents": 4}, devices=[cuda] * 4)
    cfg4 = PRESETS["gravity-65536"]()
    pos = uniform(gen, (cfg4.n, 2), -100, 100)
    o_ms, r_ms = alternate(lambda: pairwise.gravity_forces_tiled(pos, gcfg),
                           lambda: ring.ring_gravity_forces(pos, cfg4, mesh=mesh4), 5, 5)
    log("times", f"ring gravity N=65536 on 4 shards of one card: {r_ms:.3f} ms; one device "
        f"{o_ms:.3f} ms [{card}]")
    cfg2 = PRESETS["gravity-vision-1024"]()
    s2 = Scene(cfg2, device="cuda").spawn(0)
    o_ms, r_ms = alternate(lambda: raycast.render_rows_tiled(s2.pos, s2.vel, cfg2.vision),
                           lambda: ring.ring_render_rows(s2.pos, s2.vel, cfg2.vision, mesh=mesh4),
                           20, 20)
    log("times", f"ring_render_rows disc config 2 on 4 shards of one card: {r_ms:.3f} ms; one "
        f"device {o_ms:.3f} ms [{card}]")

    return times


def log_train_times(runs: dict, card: str, prefix: str = "") -> None:
    """Seconds per training iteration (host clock; each iteration ends when
    its metrics reach the host) and agent-frames/s, first iteration (build
    and warm-up) left out."""
    for label, rows in runs.items():
        label = prefix + label
        secs = [row["sec"] for row in rows[1:]]
        sec = sum(secs) / len(secs)
        was = (f"; with the plain pullback {WF_DIFF_PLAIN_SEC} s/iteration (PERF.md)"
               if label == "wireframe apg diff_vision" else "")
        log("times", f"train {label} at {TRAIN_ENVS} x {TRAIN_AGENTS} x {TRAIN_WIDTH}, horizon "
            f"{TRAIN_HORIZON}: {sec:.4f} s/iteration ({', '.join(f'{x:.4f}' for x in secs)}) = "
            f"{rows[0]['agent_frames'] / sec:.4e} agent-frames/s; first iteration "
            f"{rows[0]['sec']:.4f} s{was} [{card}]")


def print_result(kernels: list, smi: str, kind: str) -> None:
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


def main_rdma_cards(errors: Errors, gen, smi: str, kind: str, t_start: float) -> None:
    """`chip_smoke.py --rdma-cards N`: the RDMA phases alone with one shard
    on each of N cards (peer stores and flags across cards), nothing else."""
    if len(sys.argv) != 3 or sys.argv[1] != "--rdma-cards":
        raise SystemExit("usage: chip_smoke.py [--rdma-cards N]")
    cards = int(sys.argv[2])
    expect(2 <= cards <= torch.cuda.device_count(), f"{cards} visible cards")
    mesh = rdma_mesh(cards)
    log("rdma", f"{mesh}; peer access "
        f"{[torch.cuda.can_device_access_peer(i, (i + 1) % cards) for i in range(cards)]}")
    counts = phase_rdma(errors, smi, mesh)
    with torch.no_grad():
        times = phase_rdma_times(gen, smi, mesh)
    log("done", f"the RDMA phases on {cards} cards ran in {time.perf_counter() - t_start:.1f} s")
    print_result([{"name": name, "route": "cuda", **KERNEL_INFO[name], "launches": counts[name],
                   "max_abs_err": errors.max_abs[name], "ms": times[name][0],
                   "plain_ms": times[name][1], "bound_ms": times[name][2],
                   "bound_by": times[name][3], "library_ms": None}
                  for name in RDMA_KERNEL.values()], smi, kind)


def registers_of(report: str, source: str, entry: str = "") -> list:
    """The registers per thread of each kernel nvcc built from `source`
    (those whose mangled name holds `entry`), read off the library's
    -Xptxas -v report."""
    regs, inside, name = [], False, ""
    for line in report.splitlines():
        if line.startswith("=="):
            inside = line[2:].strip() == source
        elif "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
        elif inside and entry in name and "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split("registers")[0]))
    return regs


def main_kernel_times(gen, smi: str) -> None:
    """`chip_smoke.py --kernel-times [GROUP ...]`: phase 5's device timings
    and the serving steps alone, or only the TIME_GROUPS named, on whichever
    nenbody_tpu_torch is first on sys.path (an older checkout's, to compare
    two trees' kernels in one call with one harness)."""
    import nenbody_tpu_torch
    groups = sys.argv[2:] or TIME_GROUPS
    unknown = set(groups) - set(TIME_GROUPS)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown groups {sorted(unknown)}; of {TIME_GROUPS}")
    log("times", f"package {nenbody_tpu_torch.__file__}; groups {list(groups)}")
    with torch.no_grad():
        phase_kernel_times(gen, smi, groups)
        if "serving" in groups:
            log_serving(smi)
        if "rdma" in groups:
            phase_rdma_times(gen, smi, rdma_mesh(1))


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
        if line.startswith("==") or any(k in line for k in ("registers", "spill",
                                                             "Function properties")):
            log("build", line.strip())
    for source in ("gravity_vjp.cu", "boids.cu", "disc_eye_bwd.cu", "wireframe_eye_bwd.cu"):
        log("build", f"{source}: registers per thread of each entry "
            f"{registers_of(lib.ptxas_log, source)} (nvcc -Xptxas -v)")

    gen = torch.Generator(device="cuda").manual_seed(0)
    errors = Errors()
    if sys.argv[1:2] == ["--kernel-times"]:
        return main_kernel_times(gen, smi)
    if len(sys.argv) > 1:
        return main_rdma_cards(errors, gen, smi, kind, t_start)
    with torch.no_grad():
        phase_kernels(errors, gen)
        phase_backward_kernels(errors, gen)
        phase_wireframe_kernel(errors, gen)
        phase_ring_kernels(errors, gen)
        phase_vjp_partials_plans(errors)
        phase_small_reference()
    phase_grad_reference()
    phase_wireframe_grads()
    with torch.no_grad():
        paths = [phase_slice(), phase_wireframe_slice()]
    phase_apg_routes()
    runs, training = phase_train()
    more_runs, more_training = phase_more_trainers()
    cli_counts = phase_cli_surface(smi)
    with torch.no_grad():
        viewer_counts = phase_viewer(errors, smi)
        cells_counts = phase_cells(smi)
    wf_runs, wf_training = phase_wireframe_train()
    ring_counts, ring_runs = phase_ring(smi)
    rdma_counts = phase_rdma(errors, smi, rdma_mesh(1))
    with torch.no_grad():
        phase_appearance_kernels(errors, gen)
    appearance_counts = phase_appearance(errors, smi)
    paths += [training, more_training, cli_counts, viewer_counts, cells_counts, wf_training,
              ring_counts, rdma_counts, appearance_counts]
    with torch.no_grad():
        times, shapes = phase_kernel_times(gen, smi)
        log_wireframe_culls(gen, smi)
        times.update(phase_times(gen, smi))
        times.update(phase_ring_times(gen, smi))
        times.update(phase_rdma_times(gen, smi, rdma_mesh(1)))
        forms = phase_appearance_times(gen, smi)
    log_train_times(runs, smi)
    log_train_times(more_runs, smi)
    log_train_times(wf_runs, smi, prefix="wireframe ")
    log_train_times(ring_runs, smi, prefix="ring ")

    log("done", f"all phases ran in {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, info in KERNEL_INFO.items():
        k_ms, p_ms, b_ms, b_by = times[name]
        kernels.append({"name": name, "route": "cuda", **info,
                        "launches": sum(counts[name] for counts in paths),
                        "max_abs_err": errors.max_abs[name], "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        if name in forms:
            kernels[-1]["forms"] = forms[name]
        if name in shapes:
            kernels[-1]["shapes"] = shapes[name]
    print_result(kernels, smi, kind)


if __name__ == "__main__":
    main()
    sys.stdout.flush()
