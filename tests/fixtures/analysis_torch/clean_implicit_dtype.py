"""Clean counterpart: factories in step code name their dtype, or take it
from a tensor."""
import torch


def scheduled_step(state, topo):
    counter = torch.zeros((), dtype=torch.int32, device=state.device)
    acc = torch.zeros_like(state)
    return state + acc, counter + 1
