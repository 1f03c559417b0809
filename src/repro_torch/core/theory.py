"""Numerical implementation of the paper's theory section (§7, Appendix 1/2).

The port of ``repro.core.theory``. Implements both sides of Theorem 7.1 so
tests can check the inequality

    Var_i[u_i]  ≤  max²R/(Nσ⁴) · { (‖A²‖_F / min_l|A_l|²) · f(Θ, Ε)
                                   − (min_l|A_l| / max_l|A_l|)² · g(Ε) }

numerically on random instances, and exposes the reachability/homogeneity
statistics and their Erdős–Rényi closed-form approximations (Lemma 7.2)
that drive Figs. 3C and 4.

The analysis functions take numpy arrays (or anything ``np.asarray``
reads) and compute in float64 on the host. The ``prior_score`` family at
the bottom is different: the ``graph`` probe stage (``obs/probes.py``)
evaluates ``reachability_prior`` at a run's live density on the device,
and topology search ranks candidates by ``prior_score``, so those are
float32 torch scalar functions that make no host read.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from .topology import (degrees, homogeneity, homogeneity_approx, reachability,
                       reachability_approx)

Array = np.ndarray
Scalar = Union[int, float, torch.Tensor]


def update_vectors(adj: Array, thetas: Array, epsilons: Array, rewards: Array,
                   alpha: float, sigma: float) -> Array:
    """Per-agent update u_i per the sparsely-connected rule (paper Eq. 3).

    Args:
      adj: (N, N) adjacency. ``adj[i, j]=1`` ⇒ i receives from j.
      thetas: (N, D) per-agent parameters θ_i.
      epsilons: (N, D) per-agent perturbations ε_i.
      rewards: (N,) rewards R(θ_j + σ ε_j).
    Returns:
      (N, D) array of updates u_i.
    """
    adj = np.asarray(adj, dtype=np.float64)
    thetas = np.asarray(thetas, dtype=np.float64)
    epsilons = np.asarray(epsilons, dtype=np.float64)
    rewards = np.asarray(rewards, dtype=np.float64)
    n = adj.shape[0]
    perturbed = thetas + sigma * epsilons               # (N, D)
    # u_i = α/(Nσ²) Σ_j a_ij R_j (perturbed_j − θ_i)
    w = adj * rewards[None, :]                          # (N, N): w[i, j]
    u = w @ perturbed - w.sum(axis=1, keepdims=True) * thetas
    return (alpha / (n * sigma ** 2)) * u


def update_variance(adj, thetas, epsilons, rewards, alpha, sigma) -> float:
    """LHS of Theorem 7.1: Var over agents of the update vectors, with
    E[u_i u_i] the inner product across the D dimension (the variance of
    the update *positions*, as the proof's algebra treats u_i)."""
    u = update_vectors(adj, thetas, epsilons, rewards, alpha, sigma)
    mean_u = u.mean(axis=0)
    return float((u * u).sum(axis=1).mean() - (mean_u * mean_u).sum())


def f_theta_eps(thetas: Array, epsilons: Array, sigma: float) -> float:
    """f(Θ, Ε) = sqrt( Σ_{j,k,m} ((θ_j+σε_j−θ_m)·(θ_k+σε_k−θ_m))² )."""
    thetas = np.asarray(thetas, dtype=np.float64)
    epsilons = np.asarray(epsilons, dtype=np.float64)
    perturbed = thetas + sigma * epsilons               # (N, D)
    # G[m, j, k] = (perturbed_j − θ_m)·(perturbed_k − θ_m)
    diff = perturbed[None, :, :] - thetas[:, None, :]   # (M, J, D)
    gram = np.einsum("mjd,mkd->mjk", diff, diff)
    return float(np.sqrt((gram ** 2).sum()))


def g_eps(epsilons: Array, sigma: float) -> float:
    """g(Ε) = σ²/N Σ_{i,j} ε_i·ε_j."""
    epsilons = np.asarray(epsilons, dtype=np.float64)
    n = epsilons.shape[0]
    s = epsilons.sum(axis=0)
    return float(sigma ** 2 / n * (s * s).sum())


def variance_upper_bound(adj, thetas, epsilons, rewards, sigma) -> float:
    """RHS of Theorem 7.1 (with rewards normalized so min R = −max R)."""
    adj = np.asarray(adj, dtype=np.float64)
    n = adj.shape[0]
    rmax = float(np.abs(np.asarray(rewards)).max())
    d = degrees(adj)
    a2 = adj @ adj
    # √(Σ_jk (A²)_jk): the proof's Cauchy-Schwarz step uses binary a_ij, so
    # Σ (a_ij a_ik)² = Σ a_ij a_ik — the sum of A² ENTRIES (see
    # topology.reachability's paper-fidelity note).
    reach = float(np.sqrt(a2.sum())) / float(d.min()) ** 2
    homog = float(d.min() / d.max()) ** 2
    f = f_theta_eps(thetas, epsilons, sigma)
    g = g_eps(epsilons, sigma)
    return (rmax ** 2) / (n * sigma ** 4) * (reach * f - homog * g)


def graph_statistics(adj: Array) -> Dict[str, float]:
    return {
        "reachability": reachability(adj),
        "homogeneity": homogeneity(adj),
        "degree_min": float(degrees(adj).min()),
        "degree_max": float(degrees(adj).max()),
        "degree_mean": float(degrees(adj).mean()),
    }


def er_approximations(n: int, p: float) -> Dict[str, float]:
    """Lemma 7.2 closed forms (and the large-n simplification ρ≈1/(p√n))."""
    return {
        "reachability_approx": reachability_approx(n, p),
        "reachability_large_n": 1.0 / (p * np.sqrt(n)),
        "homogeneity_approx": homogeneity_approx(n, p),
    }


# ---------------------------------------------------------------------------
# torch theory priors — the graph probe and the topology-search seeding pass
# ---------------------------------------------------------------------------
#
# The same formulas as ``reachability_approx``/``homogeneity_approx`` above,
# in float32 torch so they run on the device and batch over tensors of
# densities. Inputs are clipped into the formulas' valid regime instead of
# emitting nan/inf: a search grid sweeps arbitrary (n, p) corners and a nan
# prior would silently poison the pool ranking.

_P_FLOOR = 1e-6


def _f32(*xs: Scalar, device=None):
    """Each of ``xs`` as a float32 tensor, on the device of the first
    tensor among them (else ``device``, else the CPU). A host number is
    filled in on the device (``torch.full``), never copied there: a copy
    to the card waits for it."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)),
               torch.device(device) if device is not None else None)
    return tuple(x.to(torch.float32) if isinstance(x, torch.Tensor)
                 else torch.full((), float(x), dtype=torch.float32,
                                 device=dev)
                 for x in xs)


def reachability_prior(n: Scalar, p: Scalar, *,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> torch.Tensor:
    """Lemma 7.2 ρ̂(n, p) as a float32 tensor (≡ ``reachability_approx``
    for p where k_min > 0; k_min is floored at 1 — the self-loop —
    outside). ``device`` places the result when neither input is a
    tensor."""
    n, p = _f32(n, p, device=device)
    p = torch.clamp(p, _P_FLOOR, 1.0)
    kmin = p * (n - 1.0) - 2.0 * torch.sqrt(
        torch.clamp_min(p * (n - 1.0) * (1.0 - p), 0.0))
    kmin = torch.clamp_min(kmin, 1.0)
    return torch.sqrt(p * p * (n * n * n)) / (kmin * kmin)


def homogeneity_prior(n: Scalar, p: Scalar, *,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> torch.Tensor:
    """Lemma 7.2 γ̂(n, p) as a float32 tensor (≡ ``homogeneity_approx`` on
    the clipped density)."""
    n, p = _f32(n, p, device=device)
    p = torch.clamp(p, _P_FLOOR, 1.0)
    return 1.0 - 8.0 * torch.sqrt((1.0 - p) / (n * p))


def prior_score(n: Scalar, p: Scalar, *,
                device: Optional[Union[str, torch.device]] = None
                ) -> torch.Tensor:
    """Exploration prior for a candidate topology: higher ⇒ more Theorem
    7.1 exploration headroom ⇒ rank earlier in the search pool.

    The Thm 7.1 bound scales like ρ·f(Θ,Ε) − γ·g(Ε) with f, g ≥ 0, so
    ρ̂ − γ̂ is a monotone proxy for the topology-dependent part: sparser
    graphs (higher reachability, lower homogeneity) score higher,
    matching the paper's empirical ordering (Fig. 5). A heuristic for
    seeding and pruning only; tournaments decide on measured scores.

    Uses the paper's large-n simplification ρ̂ = 1/(p√n) rather than the
    full ``reachability_prior``, whose k_min floor makes it non-monotone
    at small n (ρ̂(24, 0.2) > ρ̂(24, 0.1)). Density is clipped below at
    the ER connectivity threshold ln(n)/n: beneath it the Lemma 7.2 forms
    are invalid, and ρ̂ diverges as p → 0.
    """
    n, p = _f32(n, p, device=device)
    n2 = torch.clamp_min(n, 2.0)
    p_conn = torch.log(n2) / n2
    p = torch.minimum(torch.maximum(p, p_conn), torch.ones_like(p))
    rho = 1.0 / (p * torch.sqrt(n))
    return rho - homogeneity_prior(n, p)
