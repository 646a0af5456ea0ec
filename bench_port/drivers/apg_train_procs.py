"""apg_train across processes, one a card, as the README's multi-card
route runs it: each process joins with parallel.mesh.init_distributed()
(its card, NCCL; gloo and the CPU where the run's device is the CPU), the
mesh is make_mesh(traffic["mesh"]) over every process's device, and every
process runs the trainer on its block of the envs (drivers/apg_train.py).

The process the benchmark starts is rank 0. Ranks 1.. (the mix's
`processes`, one a card) are processes of the same command that
lib/ranks.start began (run.py does so before it imports torch, so that
their start overlaps rank 0's), with an env:// rendezvous on a free
localhost port. Rank 0 runs its own rank, waits for the others and fails
where one fails. Ranks join a gloo group beside the mesh's for the
window's host-side control, and gather to rank 0 their peak memory, their
traces and the forbidden modules each holds once the window has closed;
rank 0 prints the line.

Traffic keys (TRAFFIC_KEYS): apg_train's, mesh (axis sizes, make_mesh's)
and processes.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading

import torch

from bench_port.drivers import apg_train
from bench_port.lib import harness
from bench_port.lib.harness import Outcome

TRAFFIC_KEYS = apg_train.TRAFFIC_KEYS | {"mesh", "processes"}
# seconds the other ranks may take beyond rank 0's own run
JOIN_S = 120


def run(ctx) -> Outcome:
    return across(ctx, _rank)


def _rank(ctx, mesh, group) -> Outcome:
    import torch.distributed as dist

    out = apg_train.train(ctx, mesh, group)
    peaks = [None] * ctx.world
    dist.all_gather_object(peaks, out.peak_bytes, group=group)
    sums = [None] * ctx.world
    dist.all_gather_object(sums, out.summaries[0] if out.summaries else None, group=group)
    loaded = [None] * ctx.world
    dist.all_gather_object(loaded, harness.loaded_forbidden(), group=group)
    out.peak_bytes = max(peaks)
    out.e2e["peak_mem_gib"] = out.peak_bytes / 2 ** 30
    out.summaries = [s for s in sums if s is not None]
    out.loaded = [f"rank {r}: {m}" for r, mods in enumerate(loaded) for m in mods]
    return out


def across(ctx, body):
    """body(ctx, mesh, group) in this process's rank of the cell's process
    group; on rank 0, whose ranks 1.. lib/ranks.start began (ctx.ranks),
    those are watched and waited for."""
    if ctx.world > 1:  # a rank started by rank 0
        return joined(ctx, body)
    if ctx.ranks is None:
        raise RuntimeError("a cell across processes needs its ranks 1.. started by "
                           "bench_port/lib/ranks.start (ctx.ranks)")
    procs, port = ctx.ranks
    ctx = dataclasses.replace(ctx, world=len(procs) + 1, port=port)
    done = threading.Event()
    threading.Thread(target=_watch, args=(procs, done), daemon=True).start()
    try:
        out = joined(ctx, body)
        codes = [p.wait(timeout=JOIN_S) for p in procs]
    finally:
        done.set()
        _stop(procs)
    if any(codes):
        raise RuntimeError(f"ranks 1..{ctx.world - 1} exited {codes}")
    return out


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _watch(procs, done: threading.Event) -> None:
    """End the run where another rank fails: rank 0 would wait on it in a
    collective for as long as the process group's timeout."""
    while not done.wait(1.0):
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            print(f"bench_port: a rank exited {codes}; ending the run", file=sys.stderr,
                  flush=True)
            _stop(procs)
            os._exit(4)


def joined(ctx, body):
    """body(ctx, mesh, group) with this process in the cell's process group
    (ctx.rank of ctx.world), `group` a gloo group of every rank."""
    import torch.distributed as dist

    from nenbody_tpu_torch.parallel import mesh as mesh_lib

    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(ctx.port),
                       "RANK": str(ctx.rank), "WORLD_SIZE": str(ctx.world),
                       "LOCAL_RANK": str(ctx.rank)})
    cpu = not ctx.cuda
    ctx.mark("torch_imported")
    mesh_lib.init_distributed(local_device_ids=["cpu"] if cpu else None,
                              backend="gloo" if cpu else None)
    ctx.mark("process_group_joined")
    try:
        if ctx.cuda:
            ctx = dataclasses.replace(ctx, device=f"cuda:{torch.cuda.current_device()}")
        group = dist.new_group(backend="gloo")
        mesh = mesh_lib.make_mesh(dict(ctx.traffic["mesh"]))
        out = body(ctx, mesh, group)
        dist.barrier(group=group)
    finally:
        dist.destroy_process_group()
    return out
