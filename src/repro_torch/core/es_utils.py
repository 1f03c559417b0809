"""ES machinery shared by NetES (Salimans et al. 2017 tricks).

* fitness shaping — centered-rank transform of returns [Wierstra et al. 14]
* plain standardization, for ablations
* decoupled weight decay on parameters
"""
from __future__ import annotations

import torch


def centered_rank(returns: torch.Tensor) -> torch.Tensor:
    """Fitness shaping: map returns to centered uniform ranks in [−.5, .5].

    Double-argsort rank, scaled to [0, 1], minus 0.5 (OpenAI ES
    ``compute_centered_ranks``). Both sorts are stable, as ``jnp.argsort``
    is, so tied returns rank in index order exactly as in the reference.
    """
    flat = returns.reshape(-1)
    ranks = torch.argsort(torch.argsort(flat, stable=True), stable=True)
    shaped = ranks.to(torch.float32) / (flat.shape[0] - 1) - 0.5
    return shaped.reshape(returns.shape)


def normalize_returns(returns: torch.Tensor) -> torch.Tensor:
    """Plain standardization (population std, ddof 0 as ``jnp.std``)."""
    mu = returns.mean()
    sd = returns.std(correction=0) + 1e-8
    return (returns - mu) / sd


def apply_weight_decay(theta: torch.Tensor, update: torch.Tensor,
                       wd: float) -> torch.Tensor:
    """u ← u − wd·θ  (decoupled weight decay, as in the OpenAI ES impl)."""
    return update - wd * theta
