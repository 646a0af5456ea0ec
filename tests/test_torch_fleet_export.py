"""The port's fleet step (utils/export.py make_fleet_step and
export_policy_step(..., mesh=), the CLI's `export --mesh`): the closed-loop
step of [B, N, 2] envs over a (data, agents) mesh, traced into one `.pt2`
program through the custom ops, against the live step and against the
JAX package's make_fleet_step on conftest's 8-device CPU mesh.

The port runs on a mesh that repeats the CPU device 8 times. Tolerances:
the loaded step equals the live one bit for bit (the same wrappers, here
their plain versions, in the same order). Against JAX with both packages'
nets in float32: positions, velocities and actions rtol 3e-5 / atol 1e-6
(tests/test_torch_ring_train.py's). With the nets' default bfloat16
layers, actions atol 5e-3 (the bf16 policy-head allowance of ROADMAP
queue 3: XLA and PyTorch round a bf16 product one ulp apart now and then),
and positions and velocities the same 5e-3, since the step moves them by
dt times the action (tests/test_torch_cli_run.py's playback allowance).
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import VisionConfig as JVisionConfig
from nenbody_tpu.parallel import mesh as jmesh
from nenbody_tpu.rl import policy as jpolicy
from nenbody_tpu.rl.env import VisionEnv as JVisionEnv
from nenbody_tpu.utils import export as jexport

from nenbody_tpu_torch import SimConfig, VisionConfig, cli
from nenbody_tpu_torch.ops import library
from nenbody_tpu_torch.parallel import make_mesh
from nenbody_tpu_torch.parallel import mesh as mesh_lib
from nenbody_tpu_torch.rl.env import VisionEnv
from nenbody_tpu_torch.rl.policy import MLPPolicy, flax_from_state_dict, init_mlp_policy
from nenbody_tpu_torch.rl.policy import state_dict_from_flax
from nenbody_tpu_torch.state import spawn_batch
from nenbody_tpu_torch.utils import checkpoint as ck
from nenbody_tpu_torch.utils import export as export_lib

torch.set_num_threads(1)

CPU = torch.device("cpu")
N, W, B = 8, 16, 2
POS_TOL = dict(rtol=3e-5, atol=1e-6)
BF16_ATOL = 5e-3


def _env(sprite="disc"):
    return VisionEnv(SimConfig(n=N, controller="gravity",
                               vision=VisionConfig(width=W, sprite_mode=sprite)))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({"data": 2, "agents": 4}, devices=[CPU] * 8)


def _spawn(env, seed=4):
    return spawn_batch(env.cfg, torch.Generator().manual_seed(seed), B, "cpu")


@pytest.mark.parametrize("sprite", ["disc", "wireframe"])
def test_loaded_fleet_step_equals_the_live_step(mesh, sprite):
    env = _env(sprite)
    policy = init_mlp_policy(env.obs_width, 0)
    blob = export_lib.export_policy_step(env, policy, num_envs=B, steps=2, mesh=mesh)
    step = export_lib.load_policy_step(blob)
    st = _spawn(env)
    got = step(st.pos, st.vel)
    with torch.no_grad():
        want = export_lib.make_fleet_step(env, policy, mesh, steps=2)(st.pos, st.vel)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    assert (got[0] - st.pos).abs().max() > 0
    extra = {export_lib.MESH_RECORD: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    assert json.loads(extra[export_lib.MESH_RECORD]) == {"shape": {"data": 2, "agents": 4},
                                                         "devices": ["cpu"] * 8}
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    eye = "nenbody.wireframe_eye.default" if sprite == "wireframe" else "nenbody.disc_eye.default"
    assert {eye, "nenbody.gravity_forces.default",
            "nenbody.gravity_forces_cross.default"} <= targets


@pytest.mark.parametrize("use_bf16", [False, True], ids=["fp32", "bf16"])
def test_live_fleet_step_matches_jax_make_fleet_step(mesh, use_bf16):
    """The same weights (state_dict_from_flax) and inputs through JAX
    make_fleet_step on a (2, 4) mesh of its virtual CPU devices."""
    env = _env()
    jenv = JVisionEnv(JSimConfig(n=N, controller="gravity", vision=JVisionConfig(width=W)))
    jpol = jpolicy.MLPPolicy(use_bf16=use_bf16)
    params = jpol.init(jax.random.key(1), jnp.zeros((1, env.obs_width), jnp.float32))
    params = jax.tree_util.tree_map(lambda x: np.asarray(x + 0.01), params)
    policy = MLPPolicy(env.obs_width, use_bf16=use_bf16)
    policy.load_state_dict(state_dict_from_flax(policy, params))
    rng = np.random.RandomState(7)
    pos = rng.uniform(-20, 20, (B, N, 2)).astype(np.float32)
    vel = rng.uniform(-0.5, 0.5, (B, N, 2)).astype(np.float32)
    jm = jmesh.make_mesh({"data": 2, "agents": 4}, devices=jax.devices()[:8])
    want = jax.jit(jexport.make_fleet_step(jenv, jpol.apply, params, jm, steps=2))(
        jnp.asarray(pos), jnp.asarray(vel))
    with torch.no_grad():
        got = export_lib.make_fleet_step(env, policy, mesh, steps=2)(torch.from_numpy(pos),
                                                                     torch.from_numpy(vel))
    tol = dict(rtol=0, atol=BF16_ATOL) if use_bf16 else POS_TOL
    for name, g, w in zip(("pos", "vel", "action"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **tol)


def test_fleet_refusals(mesh):
    env = _env()
    policy = init_mlp_policy(env.obs_width, 0)
    with pytest.raises(ValueError, match="num_envs"):
        export_lib.export_policy_step(env, policy, mesh=mesh)
    with pytest.raises(ValueError, match="must divide evenly"):
        export_lib.export_policy_step(env, policy, num_envs=3, mesh=mesh)
    with pytest.raises(ValueError, match="'agents' axis"):
        export_lib.make_fleet_step(env, policy, make_mesh({"data": 2}, devices=[CPU] * 2))
    with pytest.raises(ValueError, match="steps"):
        export_lib.make_fleet_step(env, policy, mesh, steps=0)


def test_load_refuses_missing_devices_unless_a_mesh_is_given(mesh, monkeypatch):
    """An artifact whose mesh names 4 cards on a machine with fewer: refused,
    unless mesh= (of the recorded shape, here repeating the CPU) binds its
    devices; a one-device artifact takes no mesh."""
    env = _env()
    policy = init_mlp_policy(env.obs_width, 0)
    mesh4 = make_mesh({"agents": 4}, devices=[CPU] * 4)
    blob = export_lib.export_policy_step(env, policy, num_envs=B, mesh=mesh4)
    program = torch.export.load(io.BytesIO(blob))
    cards = {"shape": {"agents": 4}, "devices": [f"cuda:{i}" for i in range(4)]}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="4 distinct devices"):
        export_lib._bind_mesh(program, cards, None)
    assert export_lib._bind_mesh(program, cards, mesh4) is program  # nothing on those cards
    with pytest.raises(ValueError, match="the artifact's mesh"):
        export_lib._bind_mesh(program, cards, mesh)
    with pytest.raises(ValueError, match="one device"):
        export_lib._bind_mesh(program, {"shape": {"agents": 4},
                                        "devices": ["cuda:0", "cuda:0", "cuda:1", "cuda:1"]},
                              make_mesh({"agents": 4}, devices=["cpu", "meta", "cpu", "meta"]))
    st = _spawn(env)
    _ = export_lib.load_policy_step(blob, mesh=mesh4)(st.pos, st.vel)
    with pytest.raises(ValueError, match="no mesh"):
        export_lib.load_policy_step(export_lib.export_policy_step(env, policy), mesh=mesh4)


def test_the_copy_op_traces_and_moves_with_its_program():
    """nenbody::to_device (the ring's peer copy between two devices) is in
    the traced graph with its device as a keyword, which
    move_to_device_pass rebinds (traced towards the meta device, run on the
    CPU after the move); on one device it is a copy."""
    class Move(torch.nn.Module):
        def forward(self, x):
            return library.to_device(x, torch.device("meta")) * 2

    program = torch.export.export(Move(), (torch.ones(3),), strict=False)
    nodes = [n for n in program.graph.nodes if str(n.target) == "nenbody.to_device.default"]
    assert len(nodes) == 1 and str(nodes[0].kwargs["device"]) == "meta"
    from torch.export.passes import move_to_device_pass

    moved = move_to_device_pass(program, {"meta": "cpu"})
    x = torch.arange(3.0)
    assert torch.equal(moved.module()(x), x * 2)
    y = torch.ops.nenbody.to_device(x, device=CPU)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


def test_export_mesh_cli(tmp_path, capsys, monkeypatch):
    """`export --mesh 2x4 --policy --envs` on the visible devices (the CPU
    8 times in place of 8 cards) writes the fleet artifact (rc 0, JSON
    mesh "2x4", --check runs it); --mesh without --policy exits 2 with the
    JAX message."""
    monkeypatch.setattr(mesh_lib, "visible_devices", lambda: [CPU] * 8)
    env = _env()
    pol = ck.save_pytree(str(tmp_path / "pol.npz"),
                         flax_from_state_dict(init_mlp_policy(env.obs_width, 0)))
    out = str(tmp_path / "fleet.pt2")
    base = ["export", "--device", "cpu", "--agents", str(N), "--vision-width", str(W),
            "--mesh", "2x4", "--out", out]
    assert cli.main(base + ["--policy", pol, "--envs", "2", "--steps", "2", "--check"]) == 0
    meta = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert meta["mesh"] == "2x4" and meta["envs"] == 2 and meta["checked"]
    st = _spawn(env)
    got = export_lib.load_policy_step(out)(st.pos, st.vel)
    assert got[0].shape == (B, N, 2) and torch.isfinite(got[0]).all()
    assert cli.main(base) == 2
    assert "--mesh export serializes the policy fleet step; pass --policy" in \
        capsys.readouterr().err
