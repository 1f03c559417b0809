"""``repro_torch.core.topology_repr.widen_sparse``, ``stack`` and
``unstack`` against the JAX reference's (``repro.core.topology_repr``).

Tolerances: every stacked payload (``adj``, ``neighbor_idx``,
``neighbor_mask``, ``deg``) EQUAL to the reference's on the same adjacency,
the unstacked graphs EQUAL to the inputs. A widened neighbor list mixes
within 1e-6·S of the unwidened one on the CPU, S the sum over absolute
values of Eq. 3's terms: the plain contraction sums the zero-weight slots
too, and ``weighted_row_sum`` reduces K_max slots, whose blocking can move
with K_max by a rounding.
"""
import numpy as np
import pytest
import torch

import _torch_ref  # noqa: F401  (one intra-op thread)
from repro.core import topology as ref_topology
from repro.core import topology_repr as ref_repr
from repro_torch.core import netes, topology_repr
from repro_torch.core import topology as topo_gen
from repro_torch.core.netes import NetESConfig


def _port(adj, rep):
    return topology_repr.from_dense(adj, rep, device="cpu")


def _ers(n, cases):
    return [topo_gen.erdos_renyi(n, p=p, seed=s) for p, s in cases]


@pytest.mark.parametrize("rep", ["dense", "sparse"])
@pytest.mark.parametrize("k_max", [None, 12])
def test_stack_equals_reference(rep, k_max):
    """The same adjacencies stacked by both packages: payloads equal, the
    sparse ones at the shared K_max (or the explicit floor above it)."""
    adjs = _ers(16, [(0.1, 0), (0.3, 1), (0.2, 2)])
    ref = ref_repr.stack([ref_repr.from_dense(a, rep) for a in adjs],
                         k_max=k_max)
    got = topology_repr.stack([_port(a, rep) for a in adjs], k_max=k_max)
    np.testing.assert_array_equal(got.deg.numpy(), np.asarray(ref.deg))
    if rep == "dense":
        assert got.adj.shape == (3, 16, 16)
        np.testing.assert_array_equal(got.adj.numpy(), np.asarray(ref.adj))
    else:
        shared = max(_port(a, rep).k_max for a in adjs)
        assert got.neighbor_idx.shape == (3, 16, max(shared, k_max or 0))
        np.testing.assert_array_equal(got.neighbor_idx.numpy(),
                                      np.asarray(ref.neighbor_idx))
        np.testing.assert_array_equal(got.neighbor_mask.numpy(),
                                      np.asarray(ref.neighbor_mask))


@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_unstack_round_trips_to_contiguous_payloads(rep):
    adjs = _ers(12, [(0.15, 0), (0.4, 1), (0.25, 2)])
    topos = [_port(a, rep) for a in adjs]
    back = topology_repr.unstack(topology_repr.stack(topos))
    assert len(back) == 3
    for adj, orig, t in zip(adjs, topos, back, strict=True):
        assert t.kind == rep and t.n == 12
        np.testing.assert_array_equal(t.to_dense().numpy(), adj)
        assert torch.equal(t.deg, orig.deg)
        for name in ("adj", "neighbor_idx", "neighbor_mask"):
            v = getattr(t, name)
            assert v is None or v.is_contiguous(), name


def test_widen_sparse_equals_reference_and_keeps_the_graph():
    adj = topo_gen.erdos_renyi(16, p=0.2, seed=3)
    topo = _port(adj, "sparse")
    wide = topology_repr.widen_sparse(topo, topo.k_max + 5)
    ref = ref_repr.widen_sparse(ref_repr.from_dense(adj, "sparse"),
                                topo.k_max + 5)
    np.testing.assert_array_equal(wide.neighbor_idx.numpy(),
                                  np.asarray(ref.neighbor_idx))
    np.testing.assert_array_equal(wide.neighbor_mask.numpy(),
                                  np.asarray(ref.neighbor_mask))
    np.testing.assert_array_equal(wide.to_dense().numpy(), adj)
    assert topology_repr.widen_sparse(topo, topo.k_max) is topo


def test_widened_list_mixes_as_the_unwidened_one():
    """Eq. 3 through ``mixing_update`` (the sparse kernel's plain version
    on the CPU) on a list widened by 9 slots."""
    n, d = 16, 24
    gen = torch.Generator().manual_seed(0)
    theta = torch.randn(n, d, generator=gen)
    eps = torch.randn(n, d, generator=gen)
    shaped = torch.rand(n, generator=gen) - 0.5
    cfg = NetESConfig(alpha=0.05, sigma=0.1)
    topo = _port(topo_gen.erdos_renyi(n, p=0.2, seed=1), "sparse")
    wide = topology_repr.widen_sparse(topo, topo.k_max + 9)
    a = netes.mixing_update(topo, theta, eps, shaped, cfg)
    b = netes.mixing_update(wide, theta, eps, shaped, cfg)
    adj = torch.as_tensor(topo.to_dense(), dtype=torch.float64)
    w = shaped.double().abs()
    s = (adj @ (w[:, None] * (theta.double().abs()
                              + cfg.sigma * eps.double().abs()))
         + (adj @ w)[:, None] * theta.double().abs())
    scale = cfg.alpha / (n * cfg.sigma ** 2)
    assert (torch.abs(a - b).double() <= 1e-6 * scale * s).all()


STACK_ERRORS = {
    "empty": lambda: topology_repr.stack([]),
    "mixed kinds": lambda: topology_repr.stack(
        [_port(topo_gen.erdos_renyi(8, p=0.5), "dense"),
         _port(topo_gen.erdos_renyi(8, p=0.2), "sparse")]),
    "mixed sizes": lambda: topology_repr.stack(
        [_port(topo_gen.erdos_renyi(8, p=0.5), "dense"),
         _port(topo_gen.erdos_renyi(9, p=0.5), "dense")]),
    "narrowing": lambda: (lambda t: topology_repr.widen_sparse(
        t, t.k_max - 1))(_port(topo_gen.erdos_renyi(8, p=0.2), "sparse")),
    "widen dense": lambda: topology_repr.widen_sparse(
        _port(topo_gen.erdos_renyi(8, p=0.5), "dense"), 8),
    "circulant offsets differ": lambda: topology_repr.stack(
        [_port(topo_gen.circulant_from_offsets(12, offs), "circulant")
         for offs in ([1, 3], [1, 4])]),
    "static with shifted circulant": lambda: topology_repr.stack(
        [_port(topo_gen.circulant_from_offsets(12, [1, 3]), "circulant"),
         topology_repr.shift_circulant(_port(
             topo_gen.circulant_from_offsets(12, [1, 3]), "circulant"),
             [2, 4])]),
    "shift chains differ": lambda: topology_repr.stack(
        [topology_repr.shift_circulant(_port(
            topo_gen.circulant_from_offsets(12, [1, 3]), "circulant"), offs)
         for offs in ([2, 4], [2])]),
}


@pytest.mark.parametrize("case", sorted(STACK_ERRORS))
def test_stack_rejects_what_the_reference_rejects(case):
    with pytest.raises(ValueError):
        STACK_ERRORS[case]()


def test_stack_circulants():
    """Equal static offsets stack (and match the reference's); rotating
    circulants with shift chains of one length stack per candidate."""
    base = _port(topo_gen.circulant_from_offsets(12, [1, 3]), "circulant")
    stacked = topology_repr.stack([base, base])
    ref = ref_repr.stack([ref_repr.from_dense(
        ref_topology.circulant_from_offsets(12, [1, 3]), "circulant")] * 2)
    assert stacked.offsets == ref.offsets == (1, 3)
    np.testing.assert_array_equal(stacked.deg.numpy(), np.asarray(ref.deg))
    rot = [topology_repr.shift_circulant(base, offs)
           for offs in ([2, 4], [3, 5])]
    back = topology_repr.unstack(topology_repr.stack(rot))
    assert [t.shifts for t in back] == [t.shifts for t in rot]
    for a, b in zip(back, rot, strict=True):
        assert torch.equal(a.to_dense(), b.to_dense())
