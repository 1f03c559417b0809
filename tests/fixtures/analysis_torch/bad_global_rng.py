"""Seeded violation: global-rng (a draw from the global generator)."""
import torch


def perturb(theta, sigma):
    return theta + sigma * torch.randn(theta.shape)   # BAD: no generator=
