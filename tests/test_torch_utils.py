"""The port's host utilities (nenbody_tpu_torch.utils: profiling, debug,
native) against the JAX package's, and the `info` command.

Tolerance: none. StepTimer is the same arithmetic on the same clock
readings (the clock patched to a fixed sequence), so both packages print
the same report; assert_state_finite gives the JAX message word for word.
"""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import state as jstate
from nenbody_tpu.utils import debug as jdebug
from nenbody_tpu.utils import profiling as jprofiling

from nenbody_tpu_torch import SceneState, cli
from nenbody_tpu_torch.utils import debug, native, profiling

torch.set_num_threads(1)

NATIVE_LIB = os.path.join(os.path.dirname(__file__), "..", "native", "libnenhost.so")


def test_step_timer_reads_as_the_jax_one(monkeypatch):
    marks = [(0.0, 0), (0.5, 10), (0.9, 10), (1.2, 5), (2.0, 20), (2.1, 1)]
    clock = iter([t for t, _ in marks] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    reports = []
    for timer in (jprofiling.StepTimer(64, skip_samples=1), profiling.StepTimer(64, skip_samples=1)):
        reports.append([(timer.mark(k), timer.report({"t": i})) for i, (_, k) in enumerate(marks)])
    assert reports[0] == reports[1]
    last = json.loads(reports[1][-1][1])
    assert set(last) == {"step_ms", "steps_per_s", "pair_evals_per_s", "n", "t"}
    assert last["pair_evals_per_s"] == 64 * 64 * last["steps_per_s"] > 0


def test_device_trace_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("NENBODY_TRACE", str(tmp_path / "trace"))
    with profiling.device_trace():
        torch.ones(8).sum()
        with profiling.span("probe"):
            torch.ones(8).sum()
    files = sorted(os.listdir(tmp_path / "trace"))
    assert len(files) == 2 and all(f.endswith(".json") for f in files)
    record, trace = files
    assert record.startswith("record_") and trace.startswith("trace_")
    assert record[len("record_"):] == trace[len("trace_"):]  # one stamp for both
    with open(tmp_path / "trace" / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "nenbody.probe" for e in events)
    with open(tmp_path / "trace" / record) as f:
        assert json.load(f)["spans"]["probe"]["calls"] == 1
    monkeypatch.delenv("NENBODY_TRACE")
    with profiling.device_trace():  # off: nothing written
        torch.ones(8).sum()
    assert len(os.listdir(tmp_path / "trace")) == 2


def test_profile_train_keeps_the_traced_iterations_record():
    """profile_train's row of a trainer holds the port's record of its
    traced iteration under `spans`: one iteration, its three phases inside
    it, the env's and the policy's spans, and no eye counter (the profiler
    alone leaves them off, so the trace times the untraced kernels)."""
    import argparse

    from nenbody_tpu_torch import profile_train

    args = argparse.Namespace(envs=2, agents=12, vision_width=16, horizon=2,
                              sprite_mode="disc", warmup=1, runs=1, seed=0, device="cpu")
    row = profile_train.profile_trainer(args, "apg", "visibility", True, True)
    rec = row["spans"]
    assert rec["spans"]["apg.iteration"]["calls"] == 1 and rec["dropped"] == 0
    for phase in ("rollout", "backward", "update"):
        assert rec["spans"][f"apg.{phase}"]["parents"] == ["apg.iteration"]
    assert rec["spans"]["env.observe"]["calls"] == 2 + 1  # horizon + 1 renders
    assert rec["spans"]["policy.forward"]["calls"] == 2
    assert not any(k.startswith("eye.") for k in rec["counters"])
    json.dumps(rec)  # the JSON the command writes


def test_scan_throughput_times_chained_calls():
    calls = []

    def body(x):
        calls.append(1)
        return x + 1

    sec = profiling.scan_throughput(body, torch.zeros(4), steps=5, reps=3)
    assert sec > 0 and len(calls) == 5 * 4  # one warm-up chain, then 3 timed


def test_debug_mode_trips_on_nans_and_infs():
    x = torch.tensor([1.0, 0.0])
    with debug.debug_mode(nans=True):
        (x + 1).sum()  # finite: passes
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.log(x - 1)
    with debug.debug_mode(nans=False, infs=True):
        with pytest.raises(FloatingPointError, match="Inf"):
            1.0 / x
    torch.log(x - 1)  # outside the context nothing trips
    with pytest.raises(ValueError, match="interpreter"):
        with debug.debug_mode(interpret=True):
            pass


@pytest.mark.parametrize("leaf", ["pos", "vel"])
def test_assert_state_finite_says_what_the_jax_one_says(leaf):
    pos = np.zeros((4, 2), np.float32)
    vel = np.zeros((4, 2), np.float32)
    bad = {"pos": pos, "vel": vel}[leaf]
    bad[1, 0], bad[2, 1] = np.nan, np.inf
    jst = jstate.spawn(__import__("jax").random.key(0), JSimConfig(n=4)).replace(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel), t=jnp.int32(9))
    st = SceneState(pos=torch.tensor(pos), vel=torch.tensor(vel), t=torch.tensor(9))
    with pytest.raises(FloatingPointError) as want:
        jdebug.assert_state_finite(jst)
    with pytest.raises(FloatingPointError) as got:
        debug.assert_state_finite(st)
    assert str(got.value) == str(want.value) == f"SceneState.{leaf} has 2 non-finite values at t=9"
    debug.assert_state_finite(SceneState(pos=torch.zeros(3, 2), vel=torch.zeros(3, 2),
                                         t=torch.tensor(0)))


def test_info_keys(capsys):
    assert cli.main(["info"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"backend", "devices", "device_count", "torch", "cuda", "native_runtime",
                        "presets", "kernel_library"}
    assert "boids-4096" in out["presets"] and set(out["kernel_library"]) == {"path", "built"}
    assert out["device_count"] == len(out["devices"])
    if not torch.cuda.is_available():
        assert out["backend"] == "cpu" and out["devices"] == []


def test_native_library_builds_under_build_and_leaves_native_alone():
    """The port's libnenhost is built from native/nenhost.cpp into
    build/nenbody_tpu_torch/ under a hash of source and flags; the JAX
    package's native/libnenhost.so (whose presence decides some JAX-side
    skips) is neither created nor touched."""
    before = os.stat(NATIVE_LIB).st_mtime_ns if os.path.exists(NATIVE_LIB) else None
    assert native.build() and native.available()
    path = native.lib_path()
    assert path.parent.parts[-2:] == ("build", "nenbody_tpu_torch")
    assert path.name.startswith("libnenhost_") and path.exists()
    after = os.stat(NATIVE_LIB).st_mtime_ns if os.path.exists(NATIVE_LIB) else None
    assert after == before
    png = native.encode_png(np.zeros((4, 6, 3), np.uint8))
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
