"""The port's mixing functions against the JAX package's.

On the CPU the kernel wrappers run their plain versions (``kernels/ref.py``);
the CUDA kernels themselves are held against those on the card by
``chip_smoke.py``. Here the plain versions meet the reference's Pallas
kernels in interpret mode (as tests/test_kernels.py runs them) and its jnp
oracles.

Tolerance of the Eq. 3 outputs: |port − reference| ≤ 3e-5·S elementwise,
with S the same sum over absolute values (chip_smoke.py's bound). Both
sides add the same ≤ 2N f32 terms in other orders; the rounding error
random-walks to ≈ √(2N)·u·S ≈ 1e-6·S at N = 257 (u = 6e-8), while a
dropped or doubled term is ≈ S/N ≥ 4e-3·S. The small weighted sums use
rtol = atol = 1e-5 (≤ 257 terms of magnitude ≲ 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as ref_topology
from repro.core import topology_repr as ref_repr
from repro.kernels import netes_mixing as ref_nm
from repro.kernels import netes_sparse_mixing as ref_nsm
from repro.kernels import ref as ref_oracles
from repro_torch.core import topology_repr
from repro_torch.kernels import _checks, ref
from repro_torch.kernels.netes_mixing import netes_mixing
from repro_torch.kernels.netes_sparse_mixing import netes_sparse_mixing

TOL = dict(rtol=1e-5, atol=1e-5)
SIZES = [8, 64, 257]
P = 700          # not a multiple of the Pallas kernels' 512-wide tile
SIGMA = 0.1


def _inputs(n, p, seed, density=0.3):
    rng = np.random.default_rng(seed)
    adj = ref_topology.TopologySpec(family="erdos_renyi", n_agents=n,
                                    p=density, seed=seed).build()
    wt = rng.normal(size=n).astype(np.float32)
    we = rng.normal(size=n).astype(np.float32)
    th = rng.normal(size=(n, p)).astype(np.float32)
    ep = rng.normal(size=(n, p)).astype(np.float32)
    return adj, wt, we, th, ep


def _assert_eq3_close(out, want, adj, wt, we, th, ep):
    a = np.abs(adj.astype(np.float64))
    scale = ((a * np.abs(wt)[None, :]) @ np.abs(th)
             + SIGMA * ((a * np.abs(we)[None, :]) @ np.abs(ep))
             + np.abs((adj * wt[None, :]).sum(1))[:, None] * np.abs(th))
    err = np.abs(np.asarray(out, np.float64) - np.asarray(want, np.float64))
    worst = float((err / scale).max())
    assert (err <= 3e-5 * scale).all(), f"|err|/S reaches {worst:.3g}"


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("n", SIZES)
def test_dense_mixing_matches_pallas_and_oracle(n):
    adj, wt, we, th, ep = _inputs(n, P, seed=n)
    out = netes_mixing(*_t(adj, wt, we, th, ep), sigma=SIGMA).numpy()
    pallas = ref_nm.netes_mixing(*_j(adj, wt, we, th, ep), sigma=SIGMA,
                                 interpret=True)
    oracle = ref_oracles.netes_mixing_ref(*_j(adj, wt, we, th, ep),
                                          sigma=SIGMA)
    _assert_eq3_close(out, pallas, adj, wt, we, th, ep)
    _assert_eq3_close(out, oracle, adj, wt, we, th, ep)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("density", [0.1, 0.3])
def test_sparse_mixing_matches_pallas_and_oracle(n, density):
    adj, wt, we, th, ep = _inputs(n, P, seed=n + 1, density=density)
    idx, mask = topology_repr.sparse_neighbors(adj)
    out = netes_sparse_mixing(*_t(idx, mask, wt, we, th, ep),
                              sigma=SIGMA).numpy()
    pallas = ref_nsm.netes_sparse_mixing(*_j(idx, mask, wt, we, th, ep),
                                         sigma=SIGMA, interpret=True)
    oracle = ref_oracles.sparse_mixing_ref(*_j(idx, mask, wt, we, th, ep),
                                           sigma=SIGMA)
    _assert_eq3_close(out, pallas, adj, wt, we, th, ep)
    _assert_eq3_close(out, oracle, adj, wt, we, th, ep)
    # the same function as the dense one on the scattered graph
    dense = ref.netes_mixing_ref(*_t(adj, wt, we, th, ep), sigma=SIGMA)
    _assert_eq3_close(out, dense, adj, wt, we, th, ep)


def test_weighted_adjacency_survives_sparse_form():
    """Non-binary edge weights ride in the mask (topology_repr.py:187)."""
    adj, wt, we, th, ep = _inputs(64, 33, seed=5)
    adj = adj * np.random.default_rng(5).uniform(0.5, 2.0, adj.shape
                                                 ).astype(np.float32)
    idx, mask = topology_repr.sparse_neighbors(adj)
    sparse = netes_sparse_mixing(*_t(idx, mask, wt, we, th, ep), sigma=SIGMA)
    dense = netes_mixing(*_t(adj, wt, we, th, ep), sigma=SIGMA)
    _assert_eq3_close(sparse, dense, adj, wt, we, th, ep)


def _topologies(n):
    """(reference Topology, port Topology) for every representation."""
    cases = [("erdos_renyi", "dense"), ("erdos_renyi", "sparse"),
             ("circulant_erdos_renyi", "circulant")]
    for family, rep in cases:
        spec = dict(family=family, n_agents=n, p=0.1, seed=n)
        yield (rep, ref_repr.from_spec(ref_topology.TopologySpec(**spec), rep),
               topology_repr.from_spec(
                   topology_repr.topo_gen.TopologySpec(**spec), rep,
                   device="cpu"))


@pytest.mark.parametrize("n", SIZES)
def test_weighted_sums_match_reference(n):
    rng = np.random.default_rng(n + 2)
    coeff = rng.normal(size=n).astype(np.float32)
    shapes = [(n, 7)] + ([(n, 3, 5)] if n == 8 else [])  # trailing dims
    for values_shape in shapes:
        values = rng.normal(size=values_shape).astype(np.float32)
        for rep, ref_t, t in _topologies(n):
            assert t.kind == rep
            got = topology_repr.weighted_neighbor_sum(
                t, torch.as_tensor(coeff), torch.as_tensor(values))
            want = jax.jit(ref_repr.weighted_neighbor_sum)(
                ref_t, jnp.asarray(coeff), jnp.asarray(values))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=rep, **TOL)
            got = topology_repr.weighted_row_sum(t, torch.as_tensor(coeff))
            want = jax.jit(ref_repr.weighted_row_sum)(ref_t,
                                                      jnp.asarray(coeff))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=rep, **TOL)


def test_wrappers_reject_what_the_kernels_do_not_take():
    """A wrapper never moves data and only runs the plain version for CPU
    tensors; operands on a device that is neither raise, but meta
    tensors, which take the shape-only path (an empty result, nothing
    launched). The operand checks of the CUDA path raise on dtype, shape
    and layout."""
    meta = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        _checks.on_cpu([meta])
    out = netes_mixing(meta, meta[0], meta[0], meta, meta, sigma=SIGMA)
    assert out.device.type == "meta" and out.shape == (4, 4)
    with pytest.raises(ValueError, match="several devices"):
        netes_mixing(meta, meta[0], meta[0], torch.empty(4, 4), meta,
                     sigma=SIGMA)
    with pytest.raises(ValueError, match="several devices"):
        _checks.on_cpu([torch.empty(2), meta])
    x = torch.zeros(4, 6)
    _checks.check_operand("x", x, torch.float32, (4, 6))
    with pytest.raises(TypeError, match="dtype"):
        _checks.check_operand("x", x.double(), torch.float32, (4, 6))
    with pytest.raises(ValueError, match="shape"):
        _checks.check_operand("x", x, torch.float32, (4, 5))
    with pytest.raises(ValueError, match="contiguous"):
        _checks.check_operand("x", x.t(), torch.float32, (6, 4))
