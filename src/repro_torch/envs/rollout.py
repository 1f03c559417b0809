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

from ..kernels.pendulum_rollout import pendulum_rollout
from .pendulum import Pendulum
from .policy import MLPPolicy

# The policy ``kernels.pendulum_rollout`` holds on chip: the paper's MLP.
KERNEL_POLICY = MLPPolicy(obs_dim=3, act_dim=1, hidden=(64, 64),
                          discrete=False)


def uses_kernel(env, policy: MLPPolicy, dtype: torch.dtype,
                device: torch.device) -> bool:
    """True where ``episode_return`` launches ``kernels.pendulum_rollout``
    for parameters of ``dtype`` on ``device``: the pendulum, the paper's
    continuous 3 → 64 → 64 → 1 policy, and float32 on a CUDA device.
    Everything else runs the loop."""
    return (type(env) is Pendulum and policy == KERNEL_POLICY
            and dtype == torch.float32 and device.type == "cuda")


def episode_return(env, policy: MLPPolicy, thetas: torch.Tensor,
                   state0: torch.Tensor, per_theta: int = 1) -> torch.Tensor:
    """Total reward of one episode per row of ``state0 (M, S)``, row i run
    by the parameters ``thetas[i // per_theta]`` of ``thetas
    (M / per_theta, D)``: one kernel launch where ``uses_kernel`` holds,
    else ``loop_return``."""
    if uses_kernel(env, policy, thetas.dtype, thetas.device):
        return pendulum_rollout(env, thetas, state0, per_theta)
    if per_theta > 1:
        thetas = thetas.repeat_interleave(per_theta, dim=0)
    return loop_return(env, policy, thetas, state0)


def loop_return(env, policy: MLPPolicy, thetas: torch.Tensor,
                state0: torch.Tensor) -> torch.Tensor:
    """Total reward of one episode per row: parameters ``thetas (M, D)``
    from reset states ``state0 (M, S)``; a Python loop over the episode
    on the batched state. The rollout kernel's plain version."""
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
        rets = episode_return(self.env, self.policy, params,
                              evals.reshape(m * e, -1), e)
        return rets if e == 1 else rets.reshape(m, e).mean(dim=1)


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
    return episode_return(env, policy, theta[None, :], resets,
                          resets.shape[0]).mean()
