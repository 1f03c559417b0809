"""Pendulum swing-up (classic gym Pendulum-v1 dynamics), batched over M."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Pendulum:
    max_speed: float = 8.0
    max_torque: float = 2.0
    dt: float = 0.05
    g: float = 10.0
    m: float = 1.0
    length: float = 1.0
    episode_len: int = 200

    obs_dim: int = 3
    act_dim: int = 1
    state_dim: int = 2

    def reset(self, generator: torch.Generator, count: int) -> torch.Tensor:
        """(count, 2): θ ~ U(−π, π), θ̇ ~ U(−1, 1). The bounds enter as
        host scalars: a tensor of them copied to the card would wait for
        it."""
        u = torch.rand(count, 2, generator=generator, device=generator.device)
        return torch.stack([-hi + (2 * hi) * u[:, c]
                            for c, hi in enumerate((math.pi, 1.0))], dim=1)

    def observe(self, state: torch.Tensor) -> torch.Tensor:
        th, thdot = state[:, 0], state[:, 1]
        return torch.stack([torch.cos(th), torch.sin(th),
                            thdot / self.max_speed], dim=1)

    def step(self, state: torch.Tensor, action: torch.Tensor):
        th, thdot = state[:, 0], state[:, 1]
        u = torch.clamp(action[:, 0], -1.0, 1.0) * self.max_torque
        # tensor % is floor-mod, as jnp's (torch.fmod would truncate)
        ang = ((th + math.pi) % (2 * math.pi)) - math.pi
        cost = ang ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        newthdot = thdot + (3 * self.g / (2 * self.length) * torch.sin(th)
                            + 3.0 / (self.m * self.length ** 2) * u) * self.dt
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt
        return torch.stack([newth, newthdot], dim=1), -cost
