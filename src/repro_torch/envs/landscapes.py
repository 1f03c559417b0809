"""Synthetic high-dimensional reward landscapes on (M, D) batches.

Rewards are negated costs (higher is better); optimum 0 at x* = 0 (the
standard optimum for rosenbrock).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch


def sphere(x: torch.Tensor) -> torch.Tensor:
    return -torch.sum(x ** 2, dim=-1)


def rastrigin(x: torch.Tensor) -> torch.Tensor:
    a = 10.0
    d = x.shape[-1]
    return -(a * d + torch.sum(x ** 2 - a * torch.cos(2 * math.pi * x),
                               dim=-1))


def rosenbrock(x: torch.Tensor) -> torch.Tensor:
    x0 = x[..., :-1]
    x1 = x[..., 1:]
    return -torch.sum(100.0 * (x1 - x0 ** 2) ** 2 + (1.0 - x0) ** 2, dim=-1)


def ackley(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    s1 = torch.sqrt(torch.sum(x ** 2, dim=-1) / d)
    s2 = torch.sum(torch.cos(2 * math.pi * x), dim=-1) / d
    return -(-20.0 * torch.exp(-0.2 * s1) - torch.exp(s2) + 20.0 + math.e)


def griewank(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    idx = torch.sqrt(torch.arange(1, d + 1, dtype=x.dtype, device=x.device))
    return -(torch.sum(x ** 2, dim=-1) / 4000.0
             - torch.prod(torch.cos(x / idx), dim=-1) + 1.0)


LANDSCAPES: Dict[str, Callable] = {
    "sphere": sphere,
    "rastrigin": rastrigin,
    "rosenbrock": rosenbrock,
    "ackley": ackley,
    "griewank": griewank,
}


class LandscapeRewardFn:
    """``name`` may carry a shift suffix ``<fn>@<shift>`` moving the
    optimum to x* = shift·1 (unshifted, the FC consensus pull points at the
    origin-optimum and biases the comparison toward FC). With
    ``noise_std > 0`` every reward gets additive N(0, noise_std²) noise,
    drawn by ``draw``."""

    def __init__(self, name: str, noise_std: float = 0.0):
        self.shift = 0.0
        if "@" in name:
            name, s = name.split("@", 1)
            self.shift = float(s)
        self.fn = LANDSCAPES[name]
        self.noise_std = noise_std

    def draw(self, generator: torch.Generator,
             m: int) -> Optional[torch.Tensor]:
        if self.noise_std <= 0.0:
            return None
        return torch.randn(m, generator=generator, device=generator.device)

    def __call__(self, params: torch.Tensor,
                 evals: Optional[torch.Tensor]) -> torch.Tensor:
        r = self.fn(params - self.shift)
        if self.noise_std > 0.0:
            r = r + self.noise_std * evals
        return r


def make_landscape_reward_fn(name: str,
                             noise_std: float = 0.0) -> LandscapeRewardFn:
    return LandscapeRewardFn(name, noise_std)
