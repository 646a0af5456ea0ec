"""RL-style control on top of the sim (counterpart of nenbody_tpu/rl): the
vision env; the MLP, 1D-conv and GRU policies, the per-agent and pooled
value heads and the scripted controllers; and the six trainers: REINFORCE
(`train`, with its recurrent form), actor-critic (`ac`), PPO with GAE and
the MAPPO critic (`ppo`), antithetic evolution strategies (`es`) and
analytic policy gradients through the differentiable physics (`apg`);
batched rollout datasets (`datagen`) and behaviour cloning (`bc`)."""

from . import ac, apg, bc, datagen, env, es, policy, ppo, scripted, train

__all__ = ["ac", "apg", "bc", "datagen", "env", "es", "policy", "ppo", "scripted", "train"]
