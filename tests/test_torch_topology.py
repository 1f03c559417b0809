"""The port's topology generators and representations against the JAX
package's. Graph outputs are integer-valued, so every comparison is
EXACT: adjacency, neighbor lists slot for slot, degrees, offsets and the
representation chosen."""
import numpy as np
import pytest

from repro.core import topology as ref_topology
from repro.core import topology_repr as ref_repr
from repro_torch.core import topology, topology_repr

FAMILIES = ref_topology.available_families()
SIZES = [8, 64, 257]


def _spec_kw(family, n, seed):
    return dict(family=family, n_agents=n, p=0.2, seed=seed)


def test_same_families():
    assert topology.available_families() == FAMILIES


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", SIZES)
def test_adjacency_equal(family, n):
    for seed in (0, 1):
        ref = ref_topology.TopologySpec(**_spec_kw(family, n, seed)).build()
        out = topology.TopologySpec(**_spec_kw(family, n, seed)).build()
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", SIZES)
def test_representation_equal(family, n):
    """sparse_neighbors slot for slot, select_representation, and the
    leaves of from_spec(auto) on the port's CPU tensors."""
    spec_kw = _spec_kw(family, n, 2)
    adj = ref_topology.TopologySpec(**spec_kw).build()
    ref_idx, ref_mask = ref_repr.sparse_neighbors(adj)
    idx, mask = topology_repr.sparse_neighbors(adj)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(mask, ref_mask)
    assert idx.dtype == np.int32 and mask.dtype == np.float32

    kind = ref_repr.select_representation(adj)
    assert topology_repr.select_representation(adj) == kind
    ref_t = ref_repr.from_spec(ref_topology.TopologySpec(**spec_kw))
    t = topology_repr.from_spec(topology.TopologySpec(**spec_kw),
                                device="cpu")
    assert (t.kind, t.n, t.offsets, t.k_max) == (ref_t.kind, ref_t.n,
                                                 ref_t.offsets, ref_t.k_max)
    np.testing.assert_array_equal(t.deg.numpy(), np.asarray(ref_t.deg))
    for leaf in ("adj", "neighbor_idx", "neighbor_mask"):
        ref_leaf = getattr(ref_t, leaf)
        if ref_leaf is None:
            assert getattr(t, leaf) is None
        else:
            np.testing.assert_array_equal(getattr(t, leaf).numpy(),
                                          np.asarray(ref_leaf))
    np.testing.assert_array_equal(t.to_dense().numpy(), adj)


def test_circulant_requested_on_non_circulant_raises():
    adj = topology.TopologySpec(family="erdos_renyi", n_agents=16, p=0.3,
                                seed=0).build()
    with pytest.raises(ValueError, match="circulant"):
        topology_repr.from_dense(adj, "circulant", device="cpu")
