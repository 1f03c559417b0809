"""Adam with decoupled weight decay: the port of ``repro/optim/adam.py``.

The moments are float32 whatever the parameters' dtype, and the update is
computed in float32 and cast back, as in the reference. The step count is
a 0-d int32 tensor on the parameters' device, so an update makes no host
sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.tree import flatten, tree_map


@dataclasses.dataclass(frozen=True)
class AdamState:
    mu: Any
    nu: Any
    step: torch.Tensor


def adam_init(params: Any) -> AdamState:
    """Zero moments in float32, and step 0, on the parameters' device."""
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    device = flatten(params)[0].device
    return AdamState(mu=zeros, nu=tree_map(torch.clone, zeros),
                     step=torch.zeros((), dtype=torch.int32, device=device))


def adam_update(params: Any, grads: Any, state: AdamState, *,
                lr: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 0.0):
    """One Adam step. Returns (new params, new state); neither input is
    changed."""
    step = state.step + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                  state.mu, grads)
    nu = tree_map(
        lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
        state.nu, grads)
    t = step.to(torch.float32)
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        p32 = p.to(torch.float32)
        delta = lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32)
        return (p32 - delta).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, AdamState(mu=mu, nu=nu, step=step)
