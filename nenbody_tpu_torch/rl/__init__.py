"""RL-style control on top of the sim: the vision env, the MLP policy and
the REINFORCE and APG trainers (counterpart of nenbody_tpu/rl; the other
trainers wait, ROADMAP queue 1 item 13)."""

from . import apg, env, policy, train

__all__ = ["apg", "env", "policy", "train"]
