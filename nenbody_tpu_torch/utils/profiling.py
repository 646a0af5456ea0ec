"""Profiling and metrics (counterpart of nenbody_tpu/utils/profiling.py):
step timers with throughput derivation (pair-evals/s, agent-frames/s), a
torch.profiler trace switched by NENBODY_TRACE, and `scan_throughput`.

The JAX module's `enable_compilation_cache` has no counterpart: the port
compiles nothing per call, and its kernel library is already cached on disk
by a hash of its sources (ops/common.py). Its `slope_samples` and
`median_slope` work around a remote TPU's dispatch round trip; here CUDA
events time the device directly.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace (CPU, and CUDA when a card is
    visible) if NENBODY_TRACE (or log_dir) is set, written on exit as a
    Chrome trace `trace_<pid>_<ns>.json` in that directory."""
    target = log_dir or os.environ.get("NENBODY_TRACE")
    if not target:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(target, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
