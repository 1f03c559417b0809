"""The band instance of the sparse Eq. 3 kernel (``sparse_mixing_slab_l2``
in ``csrc/netes_sparse_mixing.cu``) on the card, and the wrapper's choice
between it and the slab instance (``kernels/netes_sparse_mixing.uses_band``).

Every test here needs a CUDA card (marker ``card``; it skips without one).
Its plan, its choice by shape and a float32 replay of its arithmetic run on
the CPU in ``test_torch_launch_plans.py``. This file imports no JAX, so on
a machine with the card it runs without this directory's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m card \\
        tests/test_torch_sparse_band.py

Tolerance, as ``chip_smoke.py``'s for Eq. 3: |kernel − float64| ≤ 3e-5·S
elementwise, S the same sum over absolute values; float32 rounding leaves
≈ 1e-6·S, and a dropped or doubled slot moves an output by ≈ S/K_max.
"""
import pytest
import torch

from repro_torch.core.topology import TopologySpec
from repro_torch.core.topology_repr import sparse_neighbors
from repro_torch.kernels import netes_sparse_mixing as nsm
from repro_torch.kernels import ref

TOL_REL = 3e-5
SIGMA = 0.1


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible; decided when the
    test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _er_operands(n: int, p_edge: float, cols: int, device):
    """The port's G(N, p) from topology seed 0 with self-loops, its padded
    list, and θ, ε and the weights."""
    adj = TopologySpec(family="erdos_renyi", n_agents=n, p=p_edge,
                       seed=0).build()
    idx_np, mask_np = sparse_neighbors(adj)
    del adj
    g = torch.Generator(device=device).manual_seed(n + cols)
    theta = 0.3 * torch.randn(n, cols, device=device, generator=g)
    eps = torch.randn(n, cols, device=device, generator=g)
    w = torch.randn(n, device=device, generator=g)
    return (torch.as_tensor(idx_np, device=device),
            torch.as_tensor(mask_np, device=device), w, w, theta, eps)


def _excess_over_tolerance(out, idx, mask, wt, we, theta, eps):
    """max(|out − exact| − TOL_REL·S) against the plain version in
    float64 (≤ 0 within the tolerance)."""
    m64, wt64, we64 = mask.double(), wt.double(), we.double()
    th64, ep64 = theta.double(), eps.double()
    exact = ref.sparse_mixing_ref(idx, m64, wt64, we64, th64, ep64,
                                  sigma=SIGMA)
    i = idx.long()
    scale = torch.zeros_like(th64)
    for k in range(i.shape[1]):
        a, src = m64[:, k, None].abs(), i[:, k]
        scale += a * (wt64.abs()[src, None] * th64.abs()[src]
                      + SIGMA * we64.abs()[src, None] * ep64.abs()[src])
    scale += (m64 * wt64[i]).sum(1).abs()[:, None] * th64.abs()
    return ((out.double() - exact).abs() - TOL_REL * scale).max().item()


@pytest.mark.card
@pytest.mark.parametrize("n,p_edge,k_lo,k_hi", [
    # the ER cell's shape: 11 chunks, K_max ≈ 22
    pytest.param(16_384, 0.0005, 16, 32, id="er-cell-16384"),
    pytest.param(1600, 0.005, 12, 32, id="n1600"),      # 2 chunks, K_max ≈ 18
])
def test_band_instance_matches_float64_and_repeats_its_bits(card, n, p_edge,
                                                            k_lo, k_hi):
    args = _er_operands(n, p_edge, 4481, card)
    k_max = args[0].shape[1]
    assert k_lo <= k_max <= k_hi
    assert isinstance(nsm.launch_plan(n, 4481, k_max, card), nsm.BandPlan)
    before = (nsm.KERNEL_BAND.launches, nsm.KERNEL.launches)
    out = nsm.netes_sparse_mixing(*args, sigma=SIGMA)
    again = nsm.netes_sparse_mixing(*args, sigma=SIGMA)
    torch.cuda.synchronize()
    # one launch of the band instance a call, none of the slab instance's
    assert (nsm.KERNEL_BAND.launches - before[0],
            nsm.KERNEL.launches - before[1]) == (2, 0)
    assert torch.equal(out, again)
    assert _excess_over_tolerance(out, *args) <= 0.0


@pytest.mark.card
@pytest.mark.parametrize("n,p_edge,band", [
    pytest.param(16_384, 0.0005, True, id="er-cell-16384"),
    pytest.param(1000, 0.1, False, id="n1000"),
])
def test_launch_plan_picks_the_instance_by_shape(card, n, p_edge, band):
    idx, mask, *rest = _er_operands(n, p_edge, 4481, card)
    pl = nsm.launch_plan(n, 4481, idx.shape[1], card)
    assert isinstance(pl, nsm.BandPlan) is band
    before = (nsm.KERNEL_BAND.launches, nsm.KERNEL.launches)
    nsm.netes_sparse_mixing(idx, mask, *rest, sigma=SIGMA)
    torch.cuda.synchronize()
    assert (nsm.KERNEL_BAND.launches - before[0],
            nsm.KERNEL.launches - before[1]) == ((1, 0) if band else (0, 1))
