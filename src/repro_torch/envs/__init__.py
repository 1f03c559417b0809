"""Batched PyTorch environments for NetES evaluation: the pendulum,
cart-pole and acrobot control tasks and the synthetic landscapes."""
from __future__ import annotations

import torch

from .acrobot import Acrobot
from .cartpole import CartPoleSwingUp
from .landscapes import LANDSCAPES, make_landscape_reward_fn
from .pendulum import Pendulum
from .policy import MLPPolicy
from .rollout import make_env_reward_fn

ENVS = {
    "pendulum": Pendulum,
    "cartpole_swingup": CartPoleSwingUp,
    "acrobot": Acrobot,
}

# Parameter dimensionality of the synthetic landscape tasks (the reference's).
LANDSCAPE_DIM = 64


def _landscape_init(generator: torch.Generator, count: int) -> torch.Tensor:
    return torch.randn(count, LANDSCAPE_DIM, generator=generator,
                       device=generator.device)


def resolve_task(task: str):
    """``"landscape:<name>"`` or an ``ENVS`` key →
    ``(reward_fn, dim, init_fn, env, policy)``; ``env`` and ``policy`` are
    None for landscape tasks. ``init_fn(generator, count) -> (count, dim)``.
    """
    if task.startswith("landscape:"):
        name = task.split(":", 1)[1]
        return (make_landscape_reward_fn(name), LANDSCAPE_DIM,
                _landscape_init, None, None)
    env = ENVS[task]()
    policy = MLPPolicy(obs_dim=env.obs_dim, act_dim=env.act_dim)
    return (make_env_reward_fn(env, policy), policy.num_params, policy.init,
            env, policy)


__all__ = [
    "LANDSCAPES", "make_landscape_reward_fn", "Pendulum", "CartPoleSwingUp",
    "Acrobot", "MLPPolicy", "make_env_reward_fn", "ENVS", "LANDSCAPE_DIM",
    "resolve_task",
]
