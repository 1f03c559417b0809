"""Seeded violation: implicit-dtype (a state built in the default dtype)."""
import torch


def scheduled_step(state, topo):
    counter = torch.zeros(())                 # BAD: the default dtype
    return state, counter + 1
