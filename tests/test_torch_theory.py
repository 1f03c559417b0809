"""``repro_torch.core.theory`` against ``repro.core.theory``.

The numpy analysis functions (Theorem 7.1's two sides, the graph
statistics, the Lemma 7.2 closed forms) run on seeded Erdős–Rényi and
fully connected graphs and random (Θ, Ε, R): within 1e-6 relative (both
compute in float64; only summation orders may differ).

The float32 priors (``reachability_prior``, ``homogeneity_prior``,
``prior_score``) run over a grid of (n, p) that includes the clipped
corners (p below ``_P_FLOOR``, p above 1, p below the connectivity
threshold ln(n)/n, n = 1 and 2): within 2 float32 ulps of the reference
(its XLA and torch's kernels may round a sqrt or log argument
differently by an ulp), and ``prior_score`` ranks the grid's densities in
the reference's order at each n. ``graph_signals`` of a live topology
equals the reference's on the same graph: density and degrees EXACT,
``reach_proxy`` within 2 ulps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import port_topology
from repro.core import theory as ref_theory
from repro.core import topology as ref_topology
from repro.core import topology_repr as ref_repr
from repro.core import topology_sched as ref_sched
from repro_torch.core import theory, topology_sched

GRAPHS = [("erdos_renyi", 0.2, 12, 0), ("erdos_renyi", 0.5, 24, 3),
          ("fully_connected", 1.0, 9, 0), ("erdos_renyi", 0.1, 40, 7)]


def _instance(family, p, n, seed, dim=5):
    adj = ref_topology.make_topology(family, n, p=p, seed=seed)
    rng = np.random.default_rng(seed + 100)
    thetas = rng.normal(size=(n, dim))
    eps = rng.normal(size=(n, dim))
    rewards = rng.normal(size=n)
    return adj, thetas, eps, rewards


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


@pytest.mark.parametrize("family,p,n,seed", GRAPHS)
def test_theorem_7_1_sides_match_reference(family, p, n, seed):
    adj, th, ep, r = _instance(family, p, n, seed)
    alpha, sigma = 0.05, 0.1
    _close(theory.update_vectors(adj, th, ep, r, alpha, sigma),
           ref_theory.update_vectors(adj, th, ep, r, alpha, sigma))
    _close(theory.update_variance(adj, th, ep, r, alpha, sigma),
           ref_theory.update_variance(adj, th, ep, r, alpha, sigma))
    _close(theory.f_theta_eps(th, ep, sigma),
           ref_theory.f_theta_eps(th, ep, sigma))
    _close(theory.g_eps(ep, sigma), ref_theory.g_eps(ep, sigma))
    _close(theory.variance_upper_bound(adj, th, ep, r, sigma),
           ref_theory.variance_upper_bound(adj, th, ep, r, sigma))


@pytest.mark.parametrize("family,p,n,seed", GRAPHS)
def test_graph_statistics_and_approximations_match_reference(family, p, n,
                                                             seed):
    adj = ref_topology.make_topology(family, n, p=p, seed=seed)
    got, want = theory.graph_statistics(adj), ref_theory.graph_statistics(adj)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])
    got = theory.er_approximations(n, p)
    want = ref_theory.er_approximations(n, p)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])


# n = 1 and 2 exercise the max(n, 2) guard and the k_min floor; p spans
# below the 1e-6 floor, below ln(n)/n, the paper's densities, and above 1
GRID_N = [1, 2, 5, 24, 50, 257, 1000, 3000]
GRID_P = [0.0, 1e-8, 1e-6, 0.003, 0.02, 0.05, 0.1, 0.109, 0.2, 0.3, 0.5,
          0.9, 1.0, 1.5]


def _assert_ulps(got, want, ulps, where):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, where
    both_inf = np.isinf(got) & np.isinf(want) & (np.sign(got)
                                                 == np.sign(want))
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
    room = ulps * np.spacing(np.maximum(np.abs(got), np.abs(want)))
    bad = ~both_inf & ~(gap <= room)
    assert not bad.any(), (where, got[bad], want[bad])


@pytest.mark.parametrize("name", ["reachability_prior", "homogeneity_prior",
                                  "prior_score"])
@pytest.mark.parametrize("n", GRID_N)
def test_priors_within_two_ulps_of_reference(name, n):
    """Each prior on a float32 tensor of densities (batched), and on host
    scalars, against the reference's jnp scalar functions."""
    fn, ref_fn = getattr(theory, name), getattr(ref_theory, name)
    p = np.asarray(GRID_P, np.float32)
    want = np.asarray(ref_fn(n, jnp.asarray(p)))
    got = fn(n, torch.from_numpy(p))
    assert got.dtype == torch.float32 and got.shape == p.shape
    _assert_ulps(got.numpy(), want, 2, (name, n))
    for pi in (0.0, 0.1, 1.5):
        got = fn(n, pi)
        assert got.dim() == 0 and got.dtype == torch.float32
        _assert_ulps(got.numpy(), np.asarray(ref_fn(n, pi)), 2,
                     (name, n, pi))


@pytest.mark.parametrize("n", GRID_N)
def test_prior_score_orders_densities_as_the_reference(n):
    p = np.asarray(GRID_P, np.float32)
    got = theory.prior_score(n, torch.from_numpy(p)).numpy()
    want = np.asarray(ref_theory.prior_score(n, jnp.asarray(p)))
    assert np.array_equal(np.argsort(-got, kind="stable"),
                          np.argsort(-want, kind="stable"))


def test_priors_take_tensor_n_and_place_on_device():
    n = torch.tensor([24.0, 1000.0])
    got = theory.reachability_prior(n, torch.tensor([0.1, 0.1]))
    want = np.asarray(ref_theory.reachability_prior(
        jnp.asarray([24.0, 1000.0]), jnp.asarray([0.1, 0.1])))
    _assert_ulps(got.numpy(), want, 2, "tensor n")
    assert theory.homogeneity_prior(50, 0.2, device="cpu").device.type == \
        "cpu"


@pytest.mark.parametrize("family,p,n,rep", [
    ("erdos_renyi", 0.3, 16, "dense"), ("erdos_renyi", 0.1, 40, "sparse"),
    ("fully_connected", 1.0, 12, "dense"),
    ("circulant_erdos_renyi", 0.3, 13, "circulant"),
    ("erdos_renyi", 0.5, 1, "dense")])
def test_graph_signals_match_reference(family, p, n, rep):
    ref_topo = ref_repr.from_spec(ref_topology.TopologySpec(
        family=family, n_agents=n, p=p, seed=2), rep)
    want = ref_sched.graph_signals(ref_topo)
    got = topology_sched.graph_signals(port_topology(ref_topo))
    assert got.keys() == want.keys()
    for k in ("density", "deg_min", "deg_max"):
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        assert float(got[k]) == float(want[k]), k
    _assert_ulps(got["reach_proxy"].numpy(), np.asarray(want["reach_proxy"]),
                 2, "reach_proxy")
