"""The port's multi-device dry run (nenbody_tpu_torch.entry.dryrun_multichip,
the twin of __graft_entry__.py's): all five trainers on CPU meshes, and
each mesh step against the same step on one device.

One device is mesh=None for REINFORCE, APG and the wireframe REINFORCE;
PPO and MAPPO draw their minibatches along the time axis with a mesh and
over flattened samples without one, so theirs is the same mesh-mode step
on a 1 x 1 mesh. Tolerances are tests/test_torch_ring_train.py's: metrics
rtol 1e-4 (tests/test_rl.py:180), parameter gradients rtol 1e-4 and atol
1e-4 of their largest component (the same sums in another order).
"""

import numpy as np
import pytest
import torch

from nenbody_tpu_torch.entry import dryrun_multichip, dryrun_steps
from nenbody_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
PHASES = ("reinforce", "apg", "ppo", "mappo", "dp_wireframe")
KEYS = ("loss", "reward_mean", "return_mean", "grad_norm", "value_mean")


@pytest.mark.parametrize("n_devices,mesh", [(4, "(data=2, agents=2)"), (3, "(data=1, agents=3)")])
def test_dryrun_multichip_runs_and_prints_the_summary(capsys, n_devices, mesh):
    out = dryrun_multichip(n_devices, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"dryrun_multichip ok: mesh={mesh}")
    for key in ("reinforce_loss=", "reward_mean=", "apg_grad_norm=", "ppo_loss=",
                "mappo_central_loss=", "dp_mesh_wireframe_loss="):
        assert key in line
    assert set(out) == set(PHASES)
    for metrics, grads in out.values():
        assert all(np.isfinite(v) for v in metrics.values())
        assert any(float(g.abs().max()) > 0 for g in grads)


@pytest.fixture(scope="module")
def runs():
    """dryrun_steps on the (2, 2) mesh with a 4-device data-only mesh, on
    one device, and on a 1 x 1 mesh."""
    mesh = make_mesh({"data": 2, "agents": 2}, devices=[CPU] * 4)
    one = make_mesh({"data": 1, "agents": 1}, devices=[CPU])
    kw = dict(device=CPU, n_agents=8, num_envs=4, wf_envs=4)
    return {"mesh": dryrun_steps(mesh, make_mesh({"data": 4}, devices=[CPU] * 4), **kw),
            "none": dryrun_steps(None, None, **kw),
            "1x1": dryrun_steps(one, one, **kw)}


@pytest.mark.parametrize("phase", PHASES)
def test_dryrun_mesh_step_matches_one_device(runs, phase):
    (m_mesh, g_mesh) = runs["mesh"][phase]
    (m_one, g_one) = runs["1x1" if phase in ("ppo", "mappo") else "none"][phase]
    for key in KEYS:
        if key in m_one:
            np.testing.assert_allclose(m_mesh[key], m_one[key], rtol=1e-4, err_msg=key)
    assert len(g_mesh) == len(g_one)
    for a, b in zip(g_mesh, g_one):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())
