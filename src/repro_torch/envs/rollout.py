"""Batched episode rollouts and the reward functions NetES consumes.

A reward function is an object with two methods:

* ``draw(generator, m)`` — the random inputs of evaluating m parameter
  vectors (for an environment: the episode reset states), and
* ``__call__(params (M, D), evals) -> (M,)`` — the returns, a pure function
  of its arguments.

Splitting the draw from the evaluation is the step's RNG seam: the tests
feed the JAX reference's reset states straight into ``__call__``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .policy import MLPPolicy


def episode_return(env, policy: MLPPolicy, thetas: torch.Tensor,
                   state0: torch.Tensor) -> torch.Tensor:
    """Total reward of one episode per row: parameters ``thetas (M, D)``
    from reset states ``state0 (M, S)``; a Python loop over the episode
    on the batched state."""
    params = policy.unflatten(thetas)
    state = state0
    total = torch.zeros(thetas.shape[0], dtype=torch.float32,
                        device=thetas.device)
    for _ in range(env.episode_len):
        action = policy.apply_unflat(params, env.observe(state))
        state, reward = env.step(state, action)
        total = total + reward
    return total


class EnvRewardFn:
    """Mean return over ``episodes_per_eval`` episodes per parameter vector
    (one in the paper's §5.2 protocol)."""

    def __init__(self, env, policy: MLPPolicy, episodes_per_eval: int = 1):
        self.env, self.policy = env, policy
        self.episodes_per_eval = episodes_per_eval

    def draw(self, generator: torch.Generator, m: int) -> torch.Tensor:
        """Reset states (m, episodes_per_eval, S)."""
        e = self.episodes_per_eval
        return self.env.reset(generator, m * e).reshape(m, e, -1)

    def __call__(self, params: torch.Tensor,
                 evals: torch.Tensor) -> torch.Tensor:
        m, e = evals.shape[0], evals.shape[1]
        thetas = params.repeat_interleave(e, dim=0) if e > 1 else params
        rets = episode_return(self.env, self.policy, thetas,
                              evals.reshape(m * e, -1))
        return rets.reshape(m, e).mean(dim=1)


def make_env_reward_fn(env, policy: MLPPolicy,
                       episodes_per_eval: int = 1) -> EnvRewardFn:
    return EnvRewardFn(env, policy, episodes_per_eval)


def evaluate_best(env, policy: MLPPolicy, theta: torch.Tensor,
                  resets: Optional[torch.Tensor] = None, *,
                  episodes: int = 32,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """The paper's evaluation metric: the mean return of ``theta (D,)``
    run without noise from ``resets (E, S)`` (drawn from ``generator``
    when absent; 1000 episodes in the paper, reduced here). Returns a 0-d
    device tensor."""
    if resets is None:
        resets = env.reset(generator, episodes)
    thetas = theta[None, :].expand(resets.shape[0], -1).contiguous()
    return episode_return(env, policy, thetas, resets).mean()
