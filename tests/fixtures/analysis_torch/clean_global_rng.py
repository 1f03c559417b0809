"""Clean counterpart: every draw names its generator (the seam)."""
import torch


def perturb(theta, sigma, generator):
    eps = torch.randn(theta.shape, generator=generator)
    noise = torch.empty_like(theta).normal_(generator=generator)
    return theta + sigma * eps + 0.0 * noise
