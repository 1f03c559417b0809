"""NetES over LM agents (the port of ``repro.distributed``): the replica
train step and the serve steps, on one device. The reference's consensus
step, sharding, context and fleet modules come with slice 7b."""
from .netes_dist import (NoiseStream, StepDraws, agent_params,
                         agent_rewards, draw, init_population,
                         make_decode_step, make_prefill_step,
                         make_replica_train_step, perturb_params,
                         replica_update)

__all__ = ["NoiseStream", "StepDraws", "agent_params",
           "agent_rewards", "draw", "init_population",
           "make_decode_step", "make_prefill_step",
           "make_replica_train_step", "perturb_params", "replica_update"]
