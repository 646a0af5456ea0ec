"""RL-style control on top of the sim: the vision env and the MLP policy
(counterpart of nenbody_tpu/rl; the trainers are not ported yet)."""

from . import env, policy

__all__ = ["env", "policy"]
