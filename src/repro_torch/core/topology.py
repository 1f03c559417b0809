"""Communication topologies between learning agents (paper §3.3).

The port's own copy of ``repro.core.topology``: pure numpy, line for line
the same generators, so that the same (family, n, p, seed) gives the same
adjacency in both packages (held equal in tests/test_torch_topology.py).

Generates adjacency matrices for the four graph families studied in the
paper (Erdos-Renyi, scale-free / Barabasi-Albert, small-world /
Watts-Strogatz, fully-connected) plus the control topologies used in the
ablation study (disconnected, star) and our beyond-paper *circulant-ER*
family (same density as ER but bandwidth-optimal on a TPU ring — see
DESIGN.md §2).

All generators are pure numpy (topology generation happens once at launch,
on host) and return dense ``float32`` adjacency matrices ``A`` with
``A[i, j] = 1`` iff agents i and j communicate. Conventions:

* symmetric (the paper assumes an undirected A — its proof uses a_ij=a_ji),
* self-loops ON (``A[i, i] = 1``): agent i always sees its own perturbation.
  This matches Eq. 1: with a fully-connected A the update must include every
  agent's own sample. (A zero diagonal would drop the agent's own
  contribution and no longer reduce to standard ES.)
* guaranteed single connected component (the paper: "we make sure that all
  our networks are in a single connected component for fair comparison") —
  enforced by rejection + repair (adding a random spanning chain over
  components).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

Array = np.ndarray

_FAMILIES: Dict[str, Callable[..., Array]] = {}


def register_family(name: str):
    def deco(fn):
        _FAMILIES[name] = fn
        return fn

    return deco


def available_families():
    return sorted(_FAMILIES)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _finalize(adj: Array, *, rng: np.random.Generator, connect: bool = True) -> Array:
    """Symmetrize, set self-loops, and (optionally) repair connectivity."""
    adj = np.asarray(adj, dtype=np.float32)
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 1.0)
    if connect:
        adj = _ensure_connected(adj, rng)
    return adj


def _components(adj: Array) -> Array:
    """Label connected components via BFS. Returns int label per node."""
    n = adj.shape[0]
    labels = -np.ones(n, dtype=np.int64)
    current = 0
    for start in range(n):
        if labels[start] >= 0:
            continue
        stack = [start]
        labels[start] = current
        while stack:
            v = stack.pop()
            nbrs = np.nonzero(adj[v] > 0)[0]
            for w in nbrs:
                if labels[w] < 0:
                    labels[w] = current
                    stack.append(int(w))
        current += 1
    return labels


def _ensure_connected(adj: Array, rng: np.random.Generator) -> Array:
    """Join components with random bridge edges until a single component."""
    labels = _components(adj)
    while labels.max() > 0:
        # bridge component 0 to each other component with one random edge
        comp0 = np.nonzero(labels == 0)[0]
        for c in range(1, int(labels.max()) + 1):
            compc = np.nonzero(labels == c)[0]
            i = int(rng.choice(comp0))
            j = int(rng.choice(compc))
            adj[i, j] = adj[j, i] = 1.0
        labels = _components(adj)
    return adj


# ---------------------------------------------------------------------------
# graph families (paper §3.3)
# ---------------------------------------------------------------------------

@register_family("erdos_renyi")
def erdos_renyi(n: int, *, p: float = 0.5, seed: int = 0, connect: bool = True) -> Array:
    """G(n, p): each undirected edge present independently with prob p [Erdos-Renyi 1959]."""
    rng = np.random.default_rng(seed)
    upper = rng.random((n, n)) < p
    adj = np.triu(upper, k=1).astype(np.float32)
    return _finalize(adj, rng=rng, connect=connect)


@register_family("scale_free")
def scale_free(n: int, *, m: Optional[int] = None, p: float = 0.5, seed: int = 0,
               connect: bool = True) -> Array:
    """Barabasi-Albert preferential attachment. ``m`` edges per new node.

    If ``m`` is None it is derived from the target density ``p`` so that the
    expected number of edges ≈ p·n(n−1)/2 (m ≈ p(n−1)/2), enabling fair
    same-density comparisons as in the paper.
    """
    rng = np.random.default_rng(seed)
    if m is None:
        m = max(1, int(round(p * (n - 1) / 2)))
    m = min(m, n - 1)
    adj = np.zeros((n, n), dtype=np.float32)
    # seed clique of m+1 nodes
    m0 = m + 1
    adj[:m0, :m0] = 1.0
    degrees = adj.sum(axis=1)
    for v in range(m0, n):
        probs = degrees[:v] / degrees[:v].sum()
        targets = rng.choice(v, size=m, replace=False, p=probs)
        for t in targets:
            adj[v, t] = adj[t, v] = 1.0
        degrees = adj.sum(axis=1)
    return _finalize(adj, rng=rng, connect=connect)


@register_family("small_world")
def small_world(n: int, *, k: Optional[int] = None, p: float = 0.5,
                rewire: float = 0.1, seed: int = 0, connect: bool = True) -> Array:
    """Watts-Strogatz: ring lattice of degree k, rewired with prob ``rewire``.

    ``k`` defaults to the even integer matching target density ``p``.
    """
    rng = np.random.default_rng(seed)
    if k is None:
        k = max(2, int(round(p * (n - 1) / 2)) * 2)
    k = min(k, n - 1 - ((n - 1) % 2))
    adj = np.zeros((n, n), dtype=np.float32)
    for offset in range(1, k // 2 + 1):
        idx = np.arange(n)
        adj[idx, (idx + offset) % n] = 1.0
        adj[(idx + offset) % n, idx] = 1.0
    # rewire
    for i in range(n):
        for offset in range(1, k // 2 + 1):
            j = (i + offset) % n
            if rng.random() < rewire and adj[i, j] > 0:
                candidates = np.nonzero(adj[i] == 0)[0]
                candidates = candidates[candidates != i]
                if candidates.size:
                    new_j = int(rng.choice(candidates))
                    adj[i, j] = adj[j, i] = 0.0
                    adj[i, new_j] = adj[new_j, i] = 1.0
    return _finalize(adj, rng=rng, connect=connect)


@register_family("fully_connected")
def fully_connected(n: int, *, seed: int = 0, **_kw) -> Array:
    """The de facto DRL topology: everyone talks to everyone."""
    return np.ones((n, n), dtype=np.float32)


@register_family("disconnected")
def disconnected(n: int, *, seed: int = 0, **_kw) -> Array:
    """Ablation control (paper Fig 3A): self-loops only; learning must rely
    on broadcast alone."""
    return np.eye(n, dtype=np.float32)


@register_family("star")
def star(n: int, *, seed: int = 0, connect: bool = True, **_kw) -> Array:
    """Hub-and-spoke — the centralized-controller topology made explicit."""
    adj = np.zeros((n, n), dtype=np.float32)
    adj[0, :] = adj[:, 0] = 1.0
    rng = np.random.default_rng(seed)
    return _finalize(adj, rng=rng, connect=connect)


@register_family("ring")
def ring(n: int, *, seed: int = 0, connect: bool = True, **_kw) -> Array:
    adj = np.zeros((n, n), dtype=np.float32)
    idx = np.arange(n)
    adj[idx, (idx + 1) % n] = 1.0
    rng = np.random.default_rng(seed)
    return _finalize(adj, rng=rng, connect=connect)


@register_family("circulant_erdos_renyi")
def circulant_erdos_renyi(n: int, *, p: float = 0.5, seed: int = 0,
                          connect: bool = True) -> Array:
    """Beyond-paper: random *circulant* graph with edge-offset density p.

    Each ring offset d ∈ {1..⌊n/2⌋} is included with probability p; if offset
    d is in, every edge (i, i+d mod n) is in. Same expected density as
    G(n, p) and vertex-transitive (every node has identical degree), but the
    edge set is a union of rings ⇒ maps onto a chain of
    ``collective_permute``s on TPU (p·N·D bytes instead of N·D all-gather).
    Offset 1 is always included so the graph is connected.
    """
    rng = np.random.default_rng(seed)
    offsets = [1]
    for d in range(2, n // 2 + 1):
        if rng.random() < p:
            offsets.append(d)
    return circulant_from_offsets(n, offsets)


def circulant_from_offsets(n: int, offsets) -> Array:
    adj = np.zeros((n, n), dtype=np.float32)
    idx = np.arange(n)
    for d in offsets:
        adj[idx, (idx + d) % n] = 1.0
        adj[(idx + d) % n, idx] = 1.0
    np.fill_diagonal(adj, 1.0)
    return adj


def circulant_offsets(adj: Array) -> Optional[list]:
    """If ``adj`` is circulant, return its generator offsets, else None.

    Degenerate inputs are circulant too: N = 0 and N = 1 both return the
    empty offset list (the search sweeps hit these corners — they must
    classify, not raise).
    """
    n = adj.shape[0]
    if n == 0:
        return []
    row0 = adj[0]
    idx = np.arange(n)
    for i in range(n):
        if not np.array_equal(adj[i], row0[(idx - i) % n]):
            return None
    offs = [d for d in range(1, n // 2 + 1) if row0[d] > 0]
    return offs


def make_topology(family: str, n: int, **kwargs) -> Array:
    if family not in _FAMILIES:
        raise ValueError(f"unknown topology family {family!r}; "
                         f"available: {available_families()}")
    return _FAMILIES[family](n, **kwargs)


# ---------------------------------------------------------------------------
# graph statistics used by the paper's theory (§7)
# ---------------------------------------------------------------------------

def degrees(adj: Array) -> Array:
    """|A_l| = Σ_j a_jl (column sums; == row sums for symmetric A)."""
    return np.asarray(adj).sum(axis=0)


def reachability(adj: Array) -> float:
    """ρ(G) = √(Σ_ij (A²)_ij) / (min_l |A_l|)² — paper §7 ("reachability").

    NOTE (paper-fidelity): the paper's TEXT writes ‖A²‖_F, but its own
    Appendix-2 derivation computes √(Σ_ij n_ij^(2)) — the square root of
    the SUM OF ENTRIES of A² (= number of length-2 paths), not the sum of
    squares. Only the sum-of-entries version is consistent with their
    closed form ρ ≈ 1/(p√n) (Lemma 7.2) and their Figs. 4/6. We implement
    the operational definition here; ``reachability_frobenius`` is the
    literal-text variant. Both decrease with density, so the qualitative
    claims are unaffected — recorded in DESIGN.md.

    A graph with a degree-0 node (no self-loop, no edges) has ρ = ∞
    rather than a ZeroDivisionError; N = 0 returns 0.0.
    """
    a = np.asarray(adj, dtype=np.float64)
    if a.shape[0] == 0:
        return 0.0
    a2 = a @ a
    paths2 = float(a2.sum())
    dmin = float(degrees(a).min())
    if dmin == 0.0:
        return float("inf")
    return float(np.sqrt(paths2)) / (dmin ** 2)


def reachability_frobenius(adj: Array) -> float:
    """Literal-text variant: ‖A²‖_F / (min_l |A_l|)²."""
    a = np.asarray(adj, dtype=np.float64)
    fro = float(np.linalg.norm(a @ a, ord="fro"))
    return fro / (float(degrees(a).min()) ** 2)


def homogeneity(adj: Array) -> float:
    """γ(G) = (min_l |A_l| / max_l |A_l|)² — paper §7 ("homogeneity").

    Edgeless graphs (max degree 0, incl. N = 0) return the vacuous 1.0
    instead of dividing by zero.
    """
    d = degrees(adj)
    if d.size == 0 or float(d.max()) == 0.0:
        return 1.0
    return float((d.min() / d.max()) ** 2)


def reachability_approx(n: int, p: float) -> float:
    """Paper Lemma 7.2 / Appendix 2, Eq. (28): ρ ≈ √(p²n³) / k_min²."""
    kmin = p * (n - 1) - 2.0 * np.sqrt(max(p * (n - 1) * (1 - p), 0.0))
    return float(np.sqrt(p * p * n ** 3) / (kmin ** 2))


def homogeneity_approx(n: int, p: float) -> float:
    """Paper Appendix 2, Eq. (29): γ ≈ 1 − 8·√((1−p)/(np)) (large p)."""
    return float(1.0 - 8.0 * np.sqrt((1.0 - p) / (n * p)))


def density(adj: Array) -> float:
    """Fraction of possible off-diagonal undirected edges present.

    N < 2 has no off-diagonal edge slots; density is 0.0, not 0/0."""
    a = np.asarray(adj)
    n = a.shape[0]
    if n < 2:
        return 0.0
    off = a.sum() - np.trace(a)
    return float(off / (n * (n - 1)))


def is_connected(adj: Array) -> bool:
    """Single connected component? N ≤ 1 is vacuously connected."""
    adj = np.asarray(adj)
    if adj.shape[0] <= 1:
        return True
    return int(_components(adj).max()) == 0


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Config-system handle for a topology (serializable)."""

    family: str = "erdos_renyi"
    n_agents: int = 16
    p: float = 0.5
    seed: int = 0
    extra: tuple = ()  # extra kwargs as sorted (key, value) pairs

    def build(self) -> Array:
        kw = dict(self.extra)
        if self.family not in ("fully_connected", "disconnected", "star", "ring"):
            kw.setdefault("p", self.p)
        return make_topology(self.family, self.n_agents, seed=self.seed, **kw)
