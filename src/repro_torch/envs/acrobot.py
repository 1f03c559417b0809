"""Acrobot swing-up (continuous-torque variant), batched over M."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Acrobot:
    dt: float = 0.2
    l1: float = 1.0
    l2: float = 1.0
    m1: float = 1.0
    m2: float = 1.0
    lc1: float = 0.5
    lc2: float = 0.5
    i1: float = 1.0
    i2: float = 1.0
    g: float = 9.8
    max_vel1: float = 4 * math.pi
    max_vel2: float = 9 * math.pi
    torque_mag: float = 1.0
    episode_len: int = 200

    obs_dim: int = 6
    act_dim: int = 1
    state_dim: int = 4

    def reset(self, generator: torch.Generator, count: int) -> torch.Tensor:
        """(count, 4) of 0.1·N(0, 1)."""
        return 0.1 * torch.randn(count, 4, generator=generator,
                                 device=generator.device)

    def observe(self, s: torch.Tensor) -> torch.Tensor:
        t1, t2, d1, d2 = s.unbind(dim=1)
        return torch.stack([torch.cos(t1), torch.sin(t1), torch.cos(t2),
                            torch.sin(t2), d1 / self.max_vel1,
                            d2 / self.max_vel2], dim=1)

    def _dsdt(self, s: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
        t1, t2, d1, d2 = s.unbind(dim=1)
        m1, m2, l1, lc1, lc2, i1, i2, g = (self.m1, self.m2, self.l1,
                                           self.lc1, self.lc2, self.i1,
                                           self.i2, self.g)
        d_1 = (m1 * lc1 ** 2 + m2 * (l1 ** 2 + lc2 ** 2
               + 2 * l1 * lc2 * torch.cos(t2)) + i1 + i2)
        d_2 = m2 * (lc2 ** 2 + l1 * lc2 * torch.cos(t2)) + i2
        phi2 = m2 * lc2 * g * torch.cos(t1 + t2 - math.pi / 2.0)
        phi1 = (-m2 * l1 * lc2 * d2 ** 2 * torch.sin(t2)
                - 2 * m2 * l1 * lc2 * d2 * d1 * torch.sin(t2)
                + (m1 * lc1 + m2 * l1) * g * torch.cos(t1 - math.pi / 2.0)
                + phi2)
        dd2 = ((tau + d_2 / d_1 * phi1 - m2 * l1 * lc2 * d1 ** 2
                * torch.sin(t2) - phi2)
               / (m2 * lc2 ** 2 + i2 - d_2 ** 2 / d_1))
        dd1 = -(d_2 * dd2 + phi1) / d_1
        return torch.stack([d1, d2, dd1, dd2], dim=1)

    def step(self, state: torch.Tensor, action: torch.Tensor):
        tau = torch.clamp(action[:, 0], -1.0, 1.0) * self.torque_mag
        # RK4 integration
        s = state
        k1 = self._dsdt(s, tau)
        k2 = self._dsdt(s + 0.5 * self.dt * k1, tau)
        k3 = self._dsdt(s + 0.5 * self.dt * k2, tau)
        k4 = self._dsdt(s + self.dt * k3, tau)
        s = s + self.dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        t1 = ((s[:, 0] + math.pi) % (2 * math.pi)) - math.pi
        t2 = ((s[:, 1] + math.pi) % (2 * math.pi)) - math.pi
        d1 = torch.clamp(s[:, 2], -self.max_vel1, self.max_vel1)
        d2 = torch.clamp(s[:, 3], -self.max_vel2, self.max_vel2)
        s = torch.stack([t1, t2, d1, d2], dim=1)
        # height of tip: reward swing-up progress
        height = -torch.cos(t1) - torch.cos(t1 + t2)
        return s, height
