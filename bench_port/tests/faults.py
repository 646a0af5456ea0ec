"""Faults planted in the program under a run, each of which the run's
check has to catch: `planted(name)` patches the port for the duration.

    state_unchanged   a step returns its state unchanged (the env's
                      integration; the trainer's optimizer step)
    half_batch        half of the batch left out, the rest standing for it:
                      the policy's mean action of the second half of the
                      envs is the first half's mean; the trainer's reward
                      is the mean over the first half of the envs
    altered_answer    an answer altered where it is produced: the policy's
                      action by 1%
    no_exchange       the exchange between processes left out: every block
                      a rank should receive is zeros, and every all-reduce
                      (the gradients', the trainer's global sums) returns
                      this process's own part
    grads_not_summed  the gradient all-reduce alone left out: each replica
                      steps on its own block's gradient
    eye_bwd_zeroed    the eye's pullback returns zeros, whichever eye the
                      run routes through: the disc's (render_rows_vjp_cross,
                      disc_eye_bwd) and the wireframe sprite's
                      (wireframe_eye_vjp, wireframe_eye_bwd, which
                      RenderRowsWireframeDiff.backward calls)
    gravity_vjp_zeroed  the gravity force's pullback (gravity_vjp) returns
                      zeros
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

FAULTS = ("state_unchanged", "half_batch", "altered_answer", "no_exchange", "grads_not_summed",
          "eye_bwd_zeroed", "gravity_vjp_zeroed")


def _patches(name: str) -> list:
    from nenbody_tpu_torch.ops import pairwise, raycast, wireframe
    from nenbody_tpu_torch.parallel import mesh
    from nenbody_tpu_torch.rl import apg, spmd
    from nenbody_tpu_torch.rl.env import VisionEnv
    from nenbody_tpu_torch.rl.policy import MLPPolicy

    forward, reward = MLPPolicy.forward, VisionEnv.reward_obs
    init = apg.init_apg_state
    if name == "state_unchanged":
        def still_init(*a, **kw):
            ts = init(*a, **kw)
            ts.optimizer.step = lambda *x, **y: None
            return ts

        return [mock.patch.object(VisionEnv, "integrate",
                                  lambda self, state, action, g: state.replace(t=state.t + 1)),
                mock.patch.object(apg, "init_apg_state", still_init)]
    if name == "half_batch":
        def half_forward(self, obs):
            mean, log_std = forward(self, obs)
            if mean.dim() > 2 and mean.shape[0] > 1:
                h = mean.shape[0] // 2
                mean = torch.cat([mean[:h], mean[:h].mean(0, keepdim=True).expand_as(mean[h:])])
            return mean, log_std

        def half_reward(self, obs):
            r = reward(self, obs)
            return r[: max(1, r.shape[0] // 2)]

        return [mock.patch.object(MLPPolicy, "forward", half_forward),
                mock.patch.object(VisionEnv, "reward_obs", half_reward)]
    if name == "altered_answer":
        return [mock.patch.object(MLPPolicy, "forward",
                                  lambda self, obs: (forward(self, obs)[0] * 1.01,
                                                     forward(self, obs)[1]))]
    if name == "no_exchange":
        return [mock.patch.object(mesh, "_exchange", lambda sends, recvs: [
            torch.zeros(shape, dtype=dtype, device=dev) for shape, dtype, dev, _, _ in recvs]),
                mock.patch.object(mesh, "_all_reduce", lambda x, group: x.clone())]
    if name == "grads_not_summed":
        return [mock.patch.object(spmd, "all_reduce_grads", lambda params, mesh: None)]
    if name == "eye_bwd_zeroed":
        def zeroed(vjp):
            return lambda *a, **kw: tuple(None if g is None else torch.zeros_like(g)
                                          for g in vjp(*a, **kw))

        return [mock.patch.object(raycast, "render_rows_vjp_cross",
                                  zeroed(raycast.render_rows_vjp_cross)),
                mock.patch.object(wireframe, "wireframe_eye_vjp",
                                  zeroed(wireframe.wireframe_eye_vjp))]
    if name == "gravity_vjp_zeroed":
        return [mock.patch.object(pairwise, "gravity_vjp_tiled",
                                  lambda pos, u, cfg: torch.zeros_like(pos))]
    if name == "none":
        return []
    raise ValueError(f"no fault {name!r}")


@contextlib.contextmanager
def planted(name: str):
    with contextlib.ExitStack() as stack:
        for p in _patches(name):
            stack.enter_context(p)
        yield
