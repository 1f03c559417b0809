"""Seeded violation: tensor-branch-in-step (a branch on a tensor value)."""
import torch


def netes_step(thetas, rewards):
    if torch.any(rewards > 0):            # BAD: reads the tensor on the host
        thetas = thetas * 0.5
    return thetas
