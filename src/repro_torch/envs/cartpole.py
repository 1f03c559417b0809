"""Cart-pole swing-up, batched over M — a harder continuous task."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class CartPoleSwingUp:
    gravity: float = 9.8
    m_cart: float = 0.5
    m_pole: float = 0.5
    pole_len: float = 0.6
    force_mag: float = 10.0
    dt: float = 0.01
    x_limit: float = 2.4
    episode_len: int = 500

    obs_dim: int = 5
    act_dim: int = 1
    state_dim: int = 4

    def reset(self, generator: torch.Generator, count: int) -> torch.Tensor:
        """(count, 4): x, ẋ, θ (π = hanging down), θ̇, plus 0.05·N(0, 1)."""
        dev = generator.device
        noise = 0.05 * torch.randn(count, 4, generator=generator, device=dev)
        # π enters as a host scalar: a tensor copied to the card would wait
        return torch.stack([noise[:, 0], noise[:, 1], math.pi + noise[:, 2],
                            noise[:, 3]], dim=1)

    def observe(self, state: torch.Tensor) -> torch.Tensor:
        x, x_dot, th, th_dot = state.unbind(dim=1)
        return torch.stack([x / self.x_limit, x_dot, torch.cos(th),
                            torch.sin(th), th_dot], dim=1)

    def step(self, state: torch.Tensor, action: torch.Tensor):
        x, x_dot, th, th_dot = state.unbind(dim=1)
        force = torch.clamp(action[:, 0], -1.0, 1.0) * self.force_mag
        mt = self.m_cart + self.m_pole
        ml = self.m_pole * self.pole_len
        sin_t, cos_t = torch.sin(th), torch.cos(th)
        temp = (force + ml * th_dot ** 2 * sin_t) / mt
        th_acc = (self.gravity * sin_t - cos_t * temp) / (
            self.pole_len * (4.0 / 3.0 - self.m_pole * cos_t ** 2 / mt))
        x_acc = temp - ml * th_acc * cos_t / mt
        x = x + self.dt * x_dot
        x_dot = x_dot + self.dt * x_acc
        th = th + self.dt * th_dot
        th_dot = th_dot + self.dt * th_acc
        # reward: keep pole up (cos θ = 1) and cart centered
        upright = torch.cos(th)
        centered = torch.exp(-x ** 2)
        out_of_bounds = (torch.abs(x) > self.x_limit).to(torch.float32)
        reward = upright * centered - 5.0 * out_of_bounds
        return torch.stack([x, x_dot, th, th_dot], dim=1), reward
