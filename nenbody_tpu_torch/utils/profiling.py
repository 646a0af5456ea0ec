"""Profiling and metrics (counterpart of nenbody_tpu/utils/profiling.py):
step timers with throughput derivation (pair-evals/s, agent-frames/s), a
torch.profiler trace switched by NENBODY_TRACE, `scan_throughput`, and the
port's own spans and counters.

The JAX module's `enable_compilation_cache` has no counterpart: the port
compiles nothing per call, and its kernel library is already cached on disk
by a hash of its sources (ops/common.py). Its `slope_samples` and
`median_slope` work around a remote TPU's dispatch round trip; here CUDA
events time the device directly.

Spans and counters. The port's layers open a `span(name)` at their
boundaries (the trainers' phases, the env's step, observation and
dynamics, the policy's forward, the gradient all-reduce) and `count` their
work (the disc eye's pairs and covered pixels). Spans are on while a
torch.profiler records on this thread or inside `recording()`; counts only
inside `recording()`: counting changes the work (the disc eye runs its
counting kernel, ops/raycast.py), and a trace taken outside recording()
times the kernels an untraced run launches. Off, a span or a count costs
one check. On, a span opens a
torch.profiler.record_function "nenbody.<name>" (so it sits in the Chrome
trace on the device events' clock) and keeps its name, its parent on the
same thread, the thread, its host start and end (time.time_ns, the clock of
the profiler's events) and, where CUDA is initialized, CUDA events recorded
on the current stream at entry and exit, whose elapsed time is the span's
device time. `record()` resolves the events (it synchronizes: read it after
the measured work) and sums each span name's calls, host and device ms and
self time, and each counter. At most MAX_SPANS spans are kept; later ones
are counted as dropped. The kernels' launch counts (ops/common.py) are
counters of the same store, kept whether or not the recorder is on, and
cleared by their own reset alone."""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch


PREFIX = "nenbody."
LAUNCHES = "launches."  # the prefix of the kernels' launch counts
MAX_SPANS = 1 << 17  # spans kept in memory; later ones are only counted

_profiler_enabled = torch._C._autograd._profiler_enabled
_recording = 0  # depth of recording() blocks
_local = threading.local()  # .stack: this thread's open spans
_lock = threading.Lock()
_spans: list = []  # [name, parent, thread, start_ns, end_ns, start_event, end_event]
_dropped = 0
_generation = 0  # bumped by reset_record, so that no span names a cleared parent
_counters: Dict[str, int] = {}  # host counters, the launch counts among them
_device_counters: Dict[tuple, torch.Tensor] = {}  # (names, device) -> int64 [len(names)]


class Span(NamedTuple):
    """A finished span as record() keeps it (parent: the index in spans()
    of the span open on the same thread at entry, or None)."""
    name: str
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    device_ms: float


def counting() -> bool:
    """Whether counts record: a recording() block is open."""
    return bool(_recording)


@contextlib.contextmanager
def recording():
    """Record spans and counts inside the block, with or without a
    torch.profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


_OFF = contextlib.nullcontext()  # what span() gives when the recorder is off


class _On:
    __slots__ = ("name", "rf", "entry", "stack", "device")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        # the parent: the innermost span this thread opened since the last reset
        parent = stack[-1][1] if stack and stack[-1][0] == _generation else None
        self.entry, self.device, slot = None, None, None
        if len(_spans) < MAX_SPANS:
            self.entry = [self.name, parent, threading.get_ident(), time.time_ns(), None, None,
                          None]
            if torch.cuda.is_initialized():
                self.device = torch.cuda.current_device()
                self.entry[5] = torch.cuda.Event(enable_timing=True)
                self.entry[5].record(torch.cuda.current_stream(self.device))
            with _lock:
                slot = len(_spans)
                _spans.append(self.entry)
        else:
            with _lock:
                _dropped += 1
        stack.append((_generation, slot))
        return None

    def __exit__(self, *exc):
        entry = self.entry
        if entry is not None:
            if self.device is not None:
                entry[6] = torch.cuda.Event(enable_timing=True)
                entry[6].record(torch.cuda.current_stream(self.device))
            entry[4] = time.time_ns()
        self.stack.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one layer's work, recorded as
    "nenbody.<name>" while a torch.profiler records on this thread or a
    recording() block is open (module docstring); otherwise it does
    nothing."""
    if not (_recording or _profiler_enabled()):
        return _OFF
    return _On(name)


def count(name: str, value) -> None:
    """Add `value` to counter `name` while counting(): a host int, or a
    device tensor summed into a device accumulator without a synchronize."""
    if not _recording:
        return
    if isinstance(value, torch.Tensor):
        acc = counter_slots((name,), value.device)
        acc.add_(value.sum().to(torch.int64))
    else:
        tally(name, value)


def counter_slots(names: tuple, device) -> Optional[torch.Tensor]:
    """While counting(), the int64 accumulator [len(names)] on `device`
    that a kernel adds counters `names` into (one slot a name, zero at
    first); None otherwise."""
    if not _recording:
        return None
    key = (tuple(names), torch.device(device))
    acc = _device_counters.get(key)
    if acc is None:
        with _lock:
            acc = _device_counters.setdefault(
                key, torch.zeros(len(names), dtype=torch.int64, device=device))
    return acc


def tally(name: str, value: int = 1) -> None:
    """Add `value` to the host counter `name` whether or not the recorder is
    on (the kernels' launch counts)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def host_counters(prefix: str = "") -> Dict[str, int]:
    """The host counters whose names start with `prefix`, without it."""
    with _lock:
        return {k[len(prefix):]: v for k, v in _counters.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Drop the host counters whose names start with `prefix`."""
    with _lock:
        for k in [k for k in _counters if k.startswith(prefix)]:
            del _counters[k]


def spans() -> List[Span]:
    """The finished spans kept, in order of entry (a span still open has
    end_ns 0). Resolving the device times synchronizes."""
    out = []
    for name, parent, thread, start, end, ev0, ev1 in list(_spans):
        if end is None:
            out.append(Span(name, parent, thread, start, 0, 0.0))
            continue
        if ev0 is not None:
            ev1.synchronize()
            ms = ev0.elapsed_time(ev1)
        else:
            ms = (end - start) / 1e6
        out.append(Span(name, parent, thread, start, end, ms))
    return out


def record() -> dict:
    """The record: for each span name its calls, host and device ms, and
    self time (the span's minus its children's), the names of the spans
    it was opened in, each counter's value (device accumulators read back),
    and the spans kept and dropped. Synchronizes."""
    kept = spans()
    child_host, child_dev = [0.0] * len(kept), [0.0] * len(kept)
    for s in kept:
        if s.end_ns and s.parent is not None:
            child_host[s.parent] += (s.end_ns - s.start_ns) / 1e6
            child_dev[s.parent] += s.device_ms
    by_name: Dict[str, dict] = {}
    for i, s in enumerate(kept):
        if not s.end_ns:
            continue
        r = by_name.setdefault(s.name, {"calls": 0, "host_ms": 0.0, "device_ms": 0.0,
                                        "self_host_ms": 0.0, "self_device_ms": 0.0,
                                        "parents": []})
        host = (s.end_ns - s.start_ns) / 1e6
        r["calls"] += 1
        r["host_ms"] += host
        r["device_ms"] += s.device_ms
        r["self_host_ms"] += host - child_host[i]
        r["self_device_ms"] += s.device_ms - child_dev[i]
        parent = kept[s.parent].name if s.parent is not None else None
        if parent not in r["parents"]:
            r["parents"].append(parent)
    counters = host_counters()
    for (names, _), acc in list(_device_counters.items()):
        for name, v in zip(names, acc.tolist()):
            counters[name] = counters.get(name, 0) + v
    return {"spans": by_name, "counters": counters, "kept": len(kept), "dropped": _dropped}


def reset_record() -> None:
    """Clear the record: the spans, the dropped count and every counter but
    the launch counts (ops/common.py's reset_launch_counts clears those)."""
    global _dropped, _generation
    with _lock:
        _spans.clear()
        _dropped = 0
        _generation += 1
        for k in [k for k in _counters if not k.startswith(LAUNCHES)]:
            del _counters[k]
        _device_counters.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace (CPU, and CUDA when a card is
    visible) if NENBODY_TRACE (or log_dir) is set, written on exit as a
    Chrome trace `trace_<pid>_<ns>.json` in that directory, with the
    record of the port's spans over the block beside it as
    `record_<pid>_<ns>.json` (the record is cleared at entry; it holds
    counts too where the block runs inside recording())."""
    target = log_dir or os.environ.get("NENBODY_TRACE")
    if not target:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    reset_record()
    with profile(activities=activities) as prof:
        yield
    stamp = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(target, f"trace_{stamp}.json"))
    with open(os.path.join(target, f"record_{stamp}.json"), "w") as f:
        json.dump(record(), f, indent=1)


def scan_throughput(body_fn: Callable, carry, steps: int, reps: int = 3) -> float:
    """Seconds per step of `steps` chained calls carry = body_fn(carry), the
    median of `reps` timings after one warm-up chain. Each chain starts from
    the previous chain's output, so no call repeats an input. On a card the
    chain is timed with CUDA events on the current stream; otherwise with
    the host clock."""
    cuda = torch.cuda.is_available() and any(
        isinstance(x, torch.Tensor) and x.is_cuda for x in _leaves(carry))

    def chain(c):
        for _ in range(steps):
            c = body_fn(c)
        return c

    carry = chain(carry)
    samples = []
    for _ in range(max(1, reps)):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            carry = chain(carry)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            carry = chain(carry)
            samples.append(time.perf_counter() - t0)
    samples.sort()
    n = len(samples)
    mid = samples[n // 2] if n % 2 else 0.5 * (samples[n // 2 - 1] + samples[n // 2])
    return mid / steps


def _leaves(x):
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif hasattr(x, "__dataclass_fields__"):
        for name in x.__dataclass_fields__:
            yield from _leaves(getattr(x, name))
    else:
        yield x


class StepTimer:
    """Wall-clock step timing with EMA and derived throughput. Feed it
    synchronized step times (call mark() only after a host copy or a
    synchronize)."""

    def __init__(
        self, n_agents: int, ema_alpha: float = 0.1, skip_samples: int = 1
    ):
        """skip_samples: leading intervals excluded from the EMA (the first
        chunk includes the kernels' build and warm-up)."""
        self.n = n_agents
        self.alpha = ema_alpha
        self.skip = skip_samples
        self.ema_s: Optional[float] = None
        self.samples = 0
        self._intervals = 0
        self._last: Optional[float] = None

    def mark(self, steps: int = 1) -> float:
        now = time.perf_counter()
        dt = 0.0
        if self._last is not None:
            dt = (now - self._last) / max(steps, 1)
            self._intervals += 1
            if self._intervals > self.skip:
                self.ema_s = dt if self.ema_s is None else (
                    self.alpha * dt + (1 - self.alpha) * self.ema_s
                )
                self.samples += steps
        self._last = now
        return dt

    @property
    def steps_per_s(self) -> float:
        return 1.0 / self.ema_s if self.ema_s else 0.0

    @property
    def pair_evals_per_s(self) -> float:
        return self.n * self.n * self.steps_per_s

    def report(self, extra: Optional[dict] = None) -> str:
        d = {
            "step_ms": (self.ema_s or 0.0) * 1e3,
            "steps_per_s": self.steps_per_s,
            "pair_evals_per_s": self.pair_evals_per_s,
            "n": self.n,
        }
        if extra:
            d.update(extra)
        return json.dumps(d)
