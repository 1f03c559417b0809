"""NetES over LM agents and its placements (the port of
``repro.distributed``): the replica train step, the consensus train step
(one shared θ, the population time-multiplexed) and the serve steps, on
one device; the sharding rules (``sharding``) and the sharding context
(``context``: ``maybe_constrain``, which the models call); the sharded RL
fleet (``fleet_shard``, ``permute_mixing``)."""
from .context import maybe_constrain, sharding_context
from .netes_dist import (NoiseStream, StepDraws, agent_params,
                         agent_rewards, consensus_update, draw,
                         init_population, make_consensus_train_step,
                         make_decode_step, make_prefill_step,
                         make_replica_train_step, member_rewards,
                         perturb_params, replica_update)

__all__ = ["NoiseStream", "StepDraws", "agent_params",
           "agent_rewards", "consensus_update", "draw", "init_population",
           "make_consensus_train_step", "make_decode_step",
           "make_prefill_step", "make_replica_train_step",
           "maybe_constrain", "member_rewards", "perturb_params",
           "replica_update", "sharding_context"]
