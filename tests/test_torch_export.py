"""Serving artifacts of the port (nenbody_tpu_torch.utils.export): the
closed-loop step exported with torch.export as a `.pt2` program, the
kernels inside it as custom ops (ops/library.py), loadable and exact
without the checkpoint, net or env at the serving site. Mirrors
tests/test_export.py; its mesh case (the fleet step) is in
test_torch_fleet_export.py.

Tolerance: none. The program calls the same wrappers (here their plain
versions on the CPU) and the same ATen ops as the live step, so the
exported step equals the live one bit for bit: the live step is
VisionEnv.observe, the policy's mean and VisionEnv.dynamics through the
wrappers directly, and the sim step is Scene.step.
"""

import json
import os

import pytest
import torch

from nenbody_tpu_torch import Scene, SceneState, SimConfig, VisionConfig, cli
from nenbody_tpu_torch.ops import common
from nenbody_tpu_torch.parallel import make_mesh
from nenbody_tpu_torch.parallel import mesh as mesh_lib
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.rl.policy import ConvPolicy, flax_from_state_dict, init_mlp_policy, seeded
from nenbody_tpu_torch.state import spawn, spawn_batch
from nenbody_tpu_torch.utils import checkpoint as ck
from nenbody_tpu_torch.utils import export as export_lib

torch.set_num_threads(1)

N, W = 8, 16


def _env_and_policy(sprite_mode="disc", antialias=False, net="mlp"):
    env = VisionEnv(SimConfig(n=N, controller="gravity",
                              vision=VisionConfig(width=W, sprite_mode=sprite_mode,
                                                  antialias=antialias)))
    if net == "conv":
        return env, seeded(0, lambda: ConvPolicy(env.obs_width, W))
    return env, init_mlp_policy(env.obs_width, 0)


@torch.no_grad()
def _live(env, policy, pos, vel, steps=1):
    state = SceneState(pos=pos, vel=vel, t=torch.zeros(pos.shape[:-2], dtype=torch.int32))
    for _ in range(steps):
        action, _ = policy(env.observe(state))
        state = env.dynamics(state, action)
    return state.pos, state.vel, action


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("sprite_mode,antialias,net", [
    ("disc", False, "mlp"), ("disc", True, "mlp"), ("wireframe", False, "mlp"),
    ("disc", False, "conv")])
def test_export_roundtrip_equals_the_live_step(tmp_path, sprite_mode, antialias, net):
    env, policy = _env_and_policy(sprite_mode, antialias, net)
    path = str(tmp_path / "step.pt2")
    with open(path, "wb") as f:
        f.write(export_lib.export_policy_step(env, policy))
    step = export_lib.load_policy_step(path)  # from disk
    st = spawn(env.cfg, torch.Generator().manual_seed(1), "cpu")
    _equal(step(st.pos, st.vel), _live(env, policy, st.pos, st.vel))


def test_export_batched_and_multi_step(tmp_path):
    """A batched artifact steps a fleet of envs (its own outputs chained
    advance the sim); a steps=2 artifact equals two chained steps=1 calls
    and two live steps."""
    env, policy = _env_and_policy()
    step = export_lib.load_policy_step(export_lib.export_policy_step(env, policy, num_envs=2))
    st = spawn_batch(env.cfg, torch.Generator().manual_seed(2), 2, "cpu")
    pos, vel = st.pos, st.vel
    for _ in range(3):
        pos, vel, action = step(pos, vel)
    assert pos.shape == (2, N, 2) and action.shape == pos.shape
    assert torch.isfinite(pos).all() and (pos - st.pos).abs().max() > 0
    _equal((pos, vel, action), _live(env, policy, st.pos, st.vel, steps=3))
    two = export_lib.load_policy_step(export_lib.export_policy_step(env, policy, num_envs=2,
                                                                    steps=2))
    _equal(two(st.pos, st.vel), step(*step(st.pos, st.vel)[:2]))


@pytest.mark.parametrize("controller", ["gravity", "boids"])
def test_export_sim_step_equals_the_scene(controller):
    """Sim as a service: the policy-free artifact advances (pos, vel) as
    Scene.step does, `steps` baked into one call."""
    cfg = SimConfig(n=16, controller=controller)
    step = export_lib.load_policy_step(export_lib.export_sim_step(cfg, steps=3, device="cpu"))
    scene = Scene(cfg, device="cpu")
    st = scene.spawn(seed=5)
    want = st
    for _ in range(3):
        want = scene.step(want)
    _equal(step(st.pos, st.vel), (want.pos, want.vel))


def test_the_program_calls_the_kernels_custom_ops():
    """The exported graph holds the kernels as nenbody:: ops, and running it
    on CPU tensors launches no kernel (their plain versions run)."""
    env, policy = _env_and_policy()
    program = torch.export.export(export_lib.make_policy_step(env, policy).eval(),
                                  (torch.zeros(N, 2), torch.zeros(N, 2)), strict=False)
    targets = {str(node.target) for node in program.graph.nodes if node.op == "call_function"}
    assert {"nenbody.disc_rows.default", "nenbody.gravity_forces.default"} <= targets
    common.reset_launch_counts()
    program.module()(torch.ones(N, 2), torch.ones(N, 2))
    assert sum(common.launch_counts().values()) == 0


def test_export_refusals():
    env, policy = _env_and_policy()
    with pytest.raises(ValueError, match="random"):
        export_lib.export_sim_step(SimConfig(n=8, controller="random"), device="cpu")
    with pytest.raises(ValueError, match="steps"):
        export_lib.export_policy_step(env, policy, steps=0)
    with pytest.raises(ValueError, match="steps"):
        export_lib.export_sim_step(SimConfig(n=8, controller="gravity"), steps=-1, device="cpu")
    with pytest.raises(ValueError, match="num_envs"):  # a fleet step needs its env batch
        export_lib.export_policy_step(
            env, policy, mesh=make_mesh({"data": 2, "agents": 4}, devices=["cpu"] * 8))


def test_export_cli(tmp_path, capsys, monkeypatch):
    env, policy = _env_and_policy()
    pol = ck.save_pytree(str(tmp_path / "pol.npz"), flax_from_state_dict(policy))
    out = str(tmp_path / "step.pt2")
    base = ["export", "--device", "cpu", "--agents", str(N), "--vision-width", str(W)]
    assert cli.main(base + ["--policy", pol, "--out", out, "--check"]) == 0
    meta = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert meta["checked"] and meta["bytes"] == os.path.getsize(out) > 0
    assert meta["mode"] == "policy" and meta["device"] == "cpu" and meta["mesh"] is None
    # the artifact carries the saved weights: it equals the live step of the loaded policy
    st = spawn(env.cfg, torch.Generator().manual_seed(4), "cpu")
    _equal(export_lib.load_policy_step(out)(st.pos, st.vel), _live(env, policy, st.pos, st.vel))
    with pytest.raises(SystemExit):  # gru stays on the live playback path
        cli.main(base + ["--policy", pol, "--net", "gru", "--out", out])
    capsys.readouterr()
    monkeypatch.setattr(mesh_lib, "visible_devices", lambda: [torch.device("cpu")] * 8)
    for argv, message in ((["--policy", str(tmp_path / "nope.npz")], "not found"),
                          (["--mesh", "2x4", "--policy", pol], "num_envs"),
                          (["--steps", "0"], "steps must be >= 1")):
        assert cli.main(base + argv + ["--out", out]) == 2
        assert message in capsys.readouterr().err
    sim_out = str(tmp_path / "sim.pt2")
    assert cli.main(["export", "--device", "cpu", "--agents", "8", "--controller", "boids",
                     "--steps", "4", "--envs", "2", "--out", sim_out, "--check"]) == 0
    meta = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert meta["mode"] == "sim:boids" and meta["steps"] == 4 and meta["envs"] == 2
