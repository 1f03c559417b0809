"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference's ``repro.models.moe``.

``repro.models`` does not import in this process (ROADMAP queue 3, item
a), so a session fixture runs the ``moe`` part of ``tests/_torch_lm_ref.py``
once in a subprocess and loads the npz it writes: ``_dispatch_indices`` of
three groups of 12 tokens × 2 choices over 4 experts of 3 slots (choices
overflow), and ``moe_block``, ``moe_ref`` and ``load_balance_loss`` of two
layers with the reference's own weights: capacity factor 0.5 (4 slots per
expert for 16 tokens × 2 choices: choices are dropped) and 8 (none are).

Tolerances: dispatch ``idx`` and ``dst`` EQUAL. Layer outputs within
2e-6 · max|output|: each output is a gate-weighted sum over k experts of
d_ff-term products, which both sides round in other orders (≈ 3e-7 of the
scale here); dropping one choice or routing it to another expert moves an
output by ≥ 1e-2 of the scale. Routing is exact only away from near-ties
of the router's probabilities, so each test asserts that the smallest gap
between the k-th and (k+1)-th probability of any token is far above the
two packages' rounding of them (≈ 1e-7). The load-balance loss within
rtol 1e-6.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_lm_ref import DISPATCH, MOE_SPECS as SPECS
from repro_torch.models import moe

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
TOL_SCALE = 2e-6
MIN_MARGIN = 1e-4       # ≥ 1000× the rounding of a float32 probability


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, str(TESTS / "_torch_lm_ref.py"),
                          str(path), "moe"], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def layer(ref, name):
    spec = moe.MoESpec(**SPECS[name])
    params = {k: torch.as_tensor(ref[f"{name}/params/{k}"])
              for k in ("router", "w_gate", "w_up", "w_down")}
    return spec, params, torch.as_tensor(ref[f"{name}/x"])


def selection_margin(params, spec, x) -> float:
    """The smallest gap between the k-th and (k+1)-th router probability
    over the tokens of x."""
    logits = moe._router_logits(params, x.reshape(-1, x.shape[-1]))
    p = torch.sort(torch.softmax(logits.double(), dim=-1), dim=-1,
                   descending=True).values
    k = spec.experts_per_token
    return (p[:, k - 1] - p[:, k]).min().item()


def close_to_scale(got, want):
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= TOL_SCALE * np.abs(want).max(), err


def test_dispatch_indices_equal_reference(ref):
    e, k, cap = DISPATCH
    ids = torch.as_tensor(ref["dispatch/ids"])
    assert (ref["dispatch/dst"] == e * cap).any()       # choices overflow
    idx, dst = moe._dispatch_indices(ids, k, e, cap)    # all groups at once
    np.testing.assert_array_equal(idx.numpy(), ref["dispatch/idx"])
    np.testing.assert_array_equal(dst.numpy(), ref["dispatch/dst"])
    for g in range(ids.shape[0]):                       # one group
        idx, dst = moe._dispatch_indices(ids[g:g + 1], k, e, cap)
        np.testing.assert_array_equal(idx[0].numpy(), ref["dispatch/idx"][g])
        np.testing.assert_array_equal(dst[0].numpy(), ref["dispatch/dst"][g])


@pytest.mark.parametrize("name", sorted(SPECS))
def test_moe_block_matches_reference(ref, name):
    spec, params, x = layer(ref, name)
    assert selection_margin(params, spec, x) > MIN_MARGIN
    seen = []

    def recording_topk(logits, k):
        seen.append(k)
        return moe.moe_topk(logits, k)

    close_to_scale(moe.moe_block(params, spec, x, topk=recording_topk),
                   ref[f"{name}/moe_block"])
    assert seen == [spec.experts_per_token]     # one router call per block
    # the reference's own block and dense oracle part where choices drop
    want, dense = ref[f"{name}/moe_block"], ref[f"{name}/moe_ref"]
    dropped = np.abs(want - dense).max() > 1e-2 * np.abs(dense).max()
    assert dropped == (name == "drops")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_moe_ref_matches_reference(ref, name):
    spec, params, x = layer(ref, name)
    close_to_scale(moe.moe_ref(params, spec, x), ref[f"{name}/moe_ref"])


def test_moe_block_equals_dense_oracle_without_drops(ref):
    spec, params, x = layer(ref, "nodrops")
    close_to_scale(moe.moe_block(params, spec, x),
                   moe.moe_ref(params, spec, x).numpy())


@pytest.mark.parametrize("name", sorted(SPECS))
def test_load_balance_loss_matches_reference(ref, name):
    spec, params, x = layer(ref, name)
    np.testing.assert_allclose(moe.load_balance_loss(params, spec, x).item(),
                               ref[f"{name}/load_balance_loss"], rtol=1e-6)


def test_load_balance_loss_of_a_uniform_router_is_one():
    spec = moe.MoESpec(num_experts=8, experts_per_token=2, d_model=16,
                       d_ff=32)
    params = {"router": torch.zeros(16, 8)}
    x = torch.randn(1, 256, 16, generator=torch.Generator().manual_seed(0))
    # every token's top choice is expert 0 (ties to the lower index), and
    # every probability 1/E: E · (1 · 1/E) = 1
    assert moe.load_balance_loss(params, spec, x).item() == pytest.approx(1.0)


@pytest.mark.parametrize("group,cf,k,e,want", [
    (512, 1.25, 6, 64, 60),     # moonshot's prefill groups
    (1, 1.25, 6, 64, 6),        # decode: one token a group, k slots
    (10, 1.25, 2, 4, 6),        # int() of 6.25
    (16, 0.5, 2, 4, 4)])
def test_group_capacity(group, cf, k, e, want):
    spec = moe.MoESpec(num_experts=e, experts_per_token=k, d_model=8,
                       d_ff=8, capacity_factor=cf)
    assert moe.group_capacity(spec, group) == want


def test_moe_block_refuses_a_sequence_the_groups_do_not_divide():
    spec = moe.MoESpec(**SPECS["drops"])                 # groups of 16
    params = moe.moe_init(torch.Generator().manual_seed(0), spec,
                          torch.float32)
    with pytest.raises(ValueError, match="divisible"):
        moe.moe_block(params, spec, torch.zeros(1, 24, 32))
    assert moe.moe_block(params, spec, torch.zeros(1, 12, 32)).shape == (
        1, 12, 32)                                       # one group of 12


def test_moe_init_statistics():
    spec = moe.MoESpec(num_experts=64, experts_per_token=6, d_model=256,
                       d_ff=128)
    p = moe.moe_init(torch.Generator().manual_seed(0), spec, torch.float64)
    assert p["router"].dtype == torch.float32            # whatever the dtype
    assert p["router"].shape == (256, 64)
    assert p["w_gate"].dtype == p["w_down"].dtype == torch.float64
    assert p["w_down"].shape == (64, 128, 256)
    # fan_in = shape[0]: d for the router, E (not d) for the experts; a
    # standard normal cut to ±2 has sd 0.8796
    assert abs(p["router"].std().item() * 256 ** 0.5 - 0.8796) < 0.02
    for w in ("w_gate", "w_up", "w_down"):
        assert p[w].abs().max() <= 2 / 8
        assert abs(p[w].std().item() * 8 - 0.8796) < 0.005
