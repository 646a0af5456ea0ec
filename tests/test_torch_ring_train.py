"""The port's mesh backends end to end: Scene(backend="ring"/"gspmd")
against the dense backend, REINFORCE and APG with mesh= against their
one-device steps, and the CLI's `train --mesh`.

The port runs on meshes that repeat the CPU device (4 for the agent axis,
2 x 4 for data x agents, 2 for a data-only mesh). Tolerances: positions
rtol 3e-5 / atol 1e-6 and observations tests/test_sharding.py's (shade
atol 1e-5, the wireframe's 2e-4); trainer losses, returns and grad norms
rtol 1e-4 (tests/test_rl.py:180), parameter gradients rtol 1e-4 and atol
1e-4 of their largest component (the same sums in another order).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from nenbody_tpu_torch import Scene, SimConfig, VisionConfig, cli
from nenbody_tpu_torch.parallel import make_mesh
from nenbody_tpu_torch.parallel import mesh as mesh_lib
from nenbody_tpu_torch.rl import apg, train
from nenbody_tpu_torch.rl.env import VisionEnv

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHADE_TOL = {"disc": dict(rtol=1e-5, atol=1e-5), "wireframe": dict(rtol=1e-5, atol=2e-4)}
FAR = 200.0  # the JAX wireframe suite's


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh({"agents": 4}, devices=[CPU] * 4)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("backend,controller,sprite", [
    ("ring", "boids", "disc"), ("ring", "gravity", "wireframe"), ("gspmd", "boids", "disc"),
])
def test_scene_mesh_backends_end_to_end(mesh4, backend, controller, sprite):
    """Scene(backend='ring'/'gspmd') steps and observes like the dense
    backend, unbatched and batched (the ring takes batched states whole)."""
    vcfg = VisionConfig(width=32, sprite_mode=sprite, far=FAR)
    cfg = SimConfig(n=37, controller=controller, backend=backend, vision=vcfg)
    ref = Scene(dataclasses.replace(cfg, backend="dense"), device="cpu")
    scene = Scene(cfg, device="cpu", mesh=mesh4)
    for s0 in (ref.spawn(0), ref.spawn_envs(3, seed=1)):
        out, want = scene.step(s0), ref.step(s0)
        _close(out.pos, want.pos, dict(rtol=3e-5, atol=1e-6))
        assert out.t.tolist() == want.t.tolist()
        _close(scene.observe(out), ref.observe(out), SHADE_TOL[sprite])


def test_ring_rollout_matches_dense(mesh4):
    cfg = SimConfig(n=64, controller="gravity", backend="ring", vision=VisionConfig(width=16))
    scene = Scene(cfg, device="cpu", mesh=mesh4)
    s0 = scene.spawn(3)
    final, traj = scene.rollout(s0, 5, record=("obs",))
    dscene = Scene(dataclasses.replace(cfg, backend="dense"), device="cpu")
    dfinal, dtraj = dscene.rollout(s0, 5, record=("obs",))
    _close(final.pos, dfinal.pos, dict(rtol=1e-4, atol=1e-4))
    assert traj["obs"].shape == (5, 64, 16)


def _env(n=16, w=16, sprite="disc", reward_mode="cohesion"):
    vcfg = VisionConfig(width=w, antialias=True, sprite_mode=sprite, far=FAR)
    return VisionEnv(SimConfig(n=n, controller="gravity", vision=vcfg), max_accel=1.0,
                     smooth_clip=True, reward_mode=reward_mode)


@pytest.mark.parametrize("mesh_axes", [{"data": 2, "agents": 4}, {"agents": 4}, {"data": 2}])
def test_reinforce_on_mesh_matches_one_device(mesh_axes):
    """REINFORCE with mesh= (ring observe and step; a data-only mesh splits
    the envs): the loss and every gradient equal the one-device step's
    (tests/test_rl.py:180's rtol 1e-4; same seed, so the same spawns and
    action noise)."""
    mesh = make_mesh(mesh_axes, devices=[CPU] * 8)
    env = _env(reward_mode="visibility")
    out = []
    for m in (mesh, None):
        ts = train.init_train_state(env, 4, seed=3, device="cpu", mesh=m)
        ts, metrics = train.make_train_step(env, horizon=2, mesh=m)(ts)
        out.append((metrics, [p.grad.clone() for p in ts.policy.parameters()], ts.env_states))
    (m_mesh, g_mesh, s_mesh), (m_one, g_one, s_one) = out
    for key in ("loss", "reward_mean", "return_mean"):
        np.testing.assert_allclose(float(m_mesh[key]), float(m_one[key]), rtol=1e-4, err_msg=key)
    for a, b in zip(g_mesh, g_one):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())
    _close(s_mesh.pos, s_one.pos, dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("sprite,diff_vision", [
    ("disc", False), ("disc", True), ("wireframe", True),
])
def test_apg_on_mesh_matches_one_device(sprite, diff_vision):
    """APG with mesh= on a (2, 4) mesh: the gradient flows through the ring
    (the gravity Functions of every hop and, with diff_vision,
    ring_render_rows_diff's per-hop eye Functions); loss and grad_norm equal
    the one-device step's (rtol 1e-4, tests/test_rl.py:180)."""
    mesh = make_mesh({"data": 2, "agents": 4}, devices=[CPU] * 8)
    env = _env(sprite=sprite, reward_mode="visibility" if diff_vision else "cohesion")
    out = []
    for m in (mesh, None):
        ts = apg.init_apg_state(env, seed=1, device="cpu")
        _, metrics = apg.make_apg_step(env, horizon=2, num_envs=4, mesh=m,
                                       diff_vision=diff_vision)(ts)
        out.append(metrics)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(out[0][key]), float(out[1][key]), rtol=1e-4,
                                   err_msg=key)
    assert float(out[0]["grad_norm"]) > 0


def test_apg_on_data_mesh_matches_one_device():
    """APG diff_vision on a data-only mesh (the env's own observe and
    dynamics on each data shard): loss and every gradient equal the
    one-device step's (rtol 1e-4)."""
    mesh = make_mesh({"data": 2}, devices=[CPU] * 2)
    env = _env(reward_mode="visibility")
    out = []
    for m in (mesh, None):
        ts = apg.init_apg_state(env, seed=1, device="cpu")
        _, metrics = apg.make_apg_step(env, horizon=2, num_envs=4, mesh=m, diff_vision=True)(ts)
        out.append((metrics, [p.grad.clone() for p in ts.policy.parameters()]))
    (m_mesh, g_mesh), (m_one, g_one) = out
    np.testing.assert_allclose(float(m_mesh["loss"]), float(m_one["loss"]), rtol=1e-4)
    assert float(m_mesh["grad_norm"]) > 0
    for a, b in zip(g_mesh, g_one):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())


def test_train_cli_mesh(monkeypatch, capsys):
    """`train --mesh`: the visible devices (here the CPU, 8 times, in place
    of 8 cards), DATAxAGENTS with -1, the env-divisibility error before any
    rollout, and a clean error where no card is visible."""
    if not torch.cuda.is_available():
        assert cli.main(["train", "--device", "cpu", "--mesh", "auto", "--iters", "1"]) == 2
        assert "no CUDA device" in capsys.readouterr().err
    monkeypatch.setattr(mesh_lib, "visible_devices", lambda: [CPU] * 8)
    base = ["train", "--device", "cpu", "--agents", "12", "--vision-width", "8", "--horizon",
            "2", "--iters", "1"]
    assert cli.main(base + ["--envs", "3", "--mesh", "2x-1"]) == 2
    assert "must divide evenly over mesh axis 'data'" in capsys.readouterr().err
    assert cli.main(base + ["--envs", "3", "--mesh", "2by4"]) == 2
    assert "DATAxAGENTS" in capsys.readouterr().err
    for algo in ("reinforce", "apg"):
        assert cli.main(base + ["--envs", "4", "--mesh", "2x4", "--algo", algo]) == 0
        row = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert np.isfinite(row["loss"])
