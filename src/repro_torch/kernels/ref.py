"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function has its kernel's signature and computes Eq. 3 through the
topology's own plain contractions, ``weighted_neighbor_sum`` and
``weighted_row_sum``:

    out_j = Σ_i a_ji R̃θ_i θ_i + σ Σ_i a_ji R̃ε_i ε_i − (Σ_i a_ji R̃θ_i) θ_j.

The kernel wrappers run them for CPU tensors; on the card, ``chip_smoke.py``
holds each kernel against them. They are no yardstick of speed.
"""
from __future__ import annotations

from ..core.topology_repr import (Topology, weighted_neighbor_sum,
                                  weighted_row_sum)


def _eq3(topo: Topology, w_theta, w_eps, theta, eps, sigma: float):
    return (weighted_neighbor_sum(topo, w_theta, theta)
            + sigma * weighted_neighbor_sum(topo, w_eps, eps)
            - weighted_row_sum(topo, w_theta)[:, None] * theta)


def netes_mixing_ref(adj, w_theta, w_eps, theta, eps, *, sigma: float):
    """Eq. 3 over a dense adjacency ``adj (N, N)``."""
    topo = Topology(kind="dense", n=adj.shape[0], deg=adj.sum(dim=1), adj=adj)
    return _eq3(topo, w_theta, w_eps, theta, eps, sigma)


def sparse_mixing_ref(neighbor_idx, neighbor_mask, w_theta, w_eps, theta,
                      eps, *, sigma: float):
    """Eq. 3 over a padded neighbor list ``neighbor_idx, neighbor_mask
    (N, K)``; padded slots carry weight 0."""
    topo = Topology(kind="sparse", n=neighbor_idx.shape[0],
                    deg=neighbor_mask.sum(dim=1), neighbor_idx=neighbor_idx,
                    neighbor_mask=neighbor_mask)
    return _eq3(topo, w_theta, w_eps, theta, eps, sigma)
