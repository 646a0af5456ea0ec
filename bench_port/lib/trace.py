"""The traced stretch of a run: the benchmark's own host spans, and
torch.profiler's device trace of a bounded steady stretch of the window,
kept in memory and reduced to a summary the per-layer readers take.

A span is a torch.profiler.record_function named "bench.<name>" around a
call into the program; outside a traced stretch it costs nothing. Device
time is the trace's kernel, memcpy and memset intervals; each is
attributed to the host span that launched it (through its runtime call's
correlation id) and to a category (the categories of the port's
profile_train.py, first match wins):

    nccl         a kernel whose name holds "nccl"
    <kernel>     one of the port's hand-written kernels, by name (KERNELS)
    memcpy       a copy or a fill (Memcpy, Memset)
    gemm         a matrix product (a name holding gemm, cutlass, xmma or cublas)
    adam         the optimizer's kernels
    elementwise  any other kernel launched inside an ATen operator ("aten::"
                 on the host): elementwise work, casts and reductions
    custom       launched outside any ATen operator: a hand-written kernel
                 this table does not name

Busy time is the union of the device intervals inside the stretch; an
idle gap is named by the innermost host span open when it began.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

PREFIX = "bench."
# the port's hand-written kernels, by a part of their names (first match)
KERNELS = ("gravity_vjp_kernel", "gravity_kernel", "disc_eye_bwd_kernel", "disc_eye_kernel",
           "wireframe_eye_bwd_kernel", "wireframe_eye_kernel", "boids_partials_kernel",
           "boids_kernel", "rdma_gravity", "rdma_boids", "rdma_vision")
# shown in the breakdown: the device operations that took most time, the
# longest idle stretches by host span, and the length of a name there
SHOWN, NAME_CHARS = 10, 96


# ATen's kernels by a part of their names (profile_train.py's CATEGORIES)
ATEN = (("memcpy", ("Memcpy", "Memset", "memcpy", "memset")),
        ("gemm", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
        ("adam", ("adam", "Adam")))


def category(name: str, launcher: str) -> str:
    if "nccl" in name.lower():
        return "nccl"
    for k in KERNELS:
        if k in name:
            return k
    for cat, keys in ATEN:
        if any(k in name for k in keys):
            return cat
    if launcher.startswith("aten::"):
        return "elementwise"
    return "custom"


class Tracer:
    """Host spans of the benchmark and, once `start` is called, the
    profiler until `stop`."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        if self.prof is None:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            yield

    def start(self) -> None:
        """Start the profiler. Starting it waits for the device, which then
        idles until the host launches again: the driver runs one unit (the
        lead) before `begin` opens the stretch."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def begin(self) -> None:
        self._span = torch.profiler.record_function(PREFIX + "stretch")
        self._span.__enter__()

    def stop(self, units: int, unit: str) -> dict:
        """Close the stretch after `units` steps or iterations; return its
        summary, to which the driver adds the work it counted (`work`)."""
        if self.cuda:
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        t = time.perf_counter()
        summary = summarize(self.prof.profiler.kineto_results, units, unit)
        summary["reduce_s"] = time.perf_counter() - t
        self.prof = None
        return summary


def _segments(spans):
    """Non-overlapping (start, end, name) pieces of nested spans, each
    named by the innermost span open over it."""
    marks = []
    for s, e, name in spans:
        marks.append((s, 1, name))
        marks.append((e, 0, name))
    marks.sort(key=lambda m: (m[0], m[1]))
    stack, out, last = [], [], None
    for t, opening, name in marks:
        if stack and last is not None and t > last:
            out.append((last, t, stack[-1]))
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        last = t
    return out


def _lookup(segments, starts, t) -> str:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segments[i][0] <= t < segments[i][1]:
        return segments[i][2]
    return "none"


def summarize(results, units: int, unit: str) -> dict:
    events = results.events()
    spans, device, cpu_ops, runtime = [], [], {}, {}
    for e in events:
        name = e.name()
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        if e.is_user_annotation():
            if not dev and name.startswith(PREFIX):
                spans.append((e.start_ns(), e.end_ns(), name[len(PREFIX):]))
            continue
        if dev:
            device.append(e)
        elif name.startswith("aten::"):
            cpu_ops[e.correlation_id()] = name
        elif name.startswith("cu"):
            runtime[e.correlation_id()] = (e.start_ns(), e.linked_correlation_id())
    stretch = [s for s in spans if s[2] == "stretch"]
    if not stretch:
        raise RuntimeError("the trace holds no stretch span")
    t0, t1 = stretch[0][0], stretch[0][1]
    spans = [s for s in spans if s[2] != "stretch" and s[0] >= t0 and s[1] <= t1]
    segs = _segments(spans)
    seg_starts = [s[0] for s in segs]

    by_cat, by_name = defaultdict(float), defaultdict(float)
    by_span = defaultdict(lambda: defaultdict(float))
    intervals = []
    for e in device:
        s, end = e.start_ns(), e.end_ns()
        if end <= t0 or s >= t1:
            continue
        dur = (end - s) / 1e9
        launch, linked = runtime.get(e.correlation_id(), (s, 0))
        cat = category(e.name(), cpu_ops.get(linked, ""))
        by_cat[cat] += dur
        by_name[e.name()[:NAME_CHARS]] += dur
        by_span[_lookup(segs, seg_starts, launch)][cat] += dur
        intervals.append((max(s, t0), min(end, t1)))
    intervals.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, t0
    for s, e in intervals:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if cur_e < t1:
        gaps.append((cur_e, t1))
    idle = defaultdict(float)
    for s, e in gaps:
        idle[_lookup(segs, seg_starts, s)] += (e - s) / 1e9
    host = defaultdict(lambda: [0.0, 0])
    for s, e, name in spans:
        host[name][0] += (e - s) / 1e9
        host[name][1] += 1
    return {
        "window_s": (t1 - t0) / 1e9, "busy_s": busy / 1e9, "units": units, "unit": unit,
        "device_s": dict(by_cat),
        "device_s_by_span": {k: dict(v) for k, v in by_span.items()},
        "host_s_by_span": {k: {"s": v[0], "calls": v[1]} for k, v in host.items()},
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:SHOWN],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:SHOWN],
        "work": {},
    }
