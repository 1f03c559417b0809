"""The port's first-order optimizers (``repro_torch.optim``) against the
reference's ``repro.optim``, which imports here, called in this process on
the same numpy inputs.

Tolerance: float32 parameters are held EQUAL after each of 5 steps where
both packages compute the same float32 operations in the same order
(SGD), and within rtol = atol = 1e-6 for Adam, whose bias corrections
take b ** step through each library's own float32 ``pow`` (a few ulps
apart); a wrong moment, correction or decay term moves a parameter by
≥ 1e-4. bfloat16 parameters (the update computed in float32 and cast
back) are held within one bfloat16 ulp (2⁻⁷ relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam_init as ref_adam_init
from repro.optim import adam_update as ref_adam_update
from repro.optim import sgd_update as ref_sgd_update
from repro_torch.core.tree import flatten, tree_map
from repro_torch.optim import AdamState, adam_init, adam_update, sgd_update

STEPS = 5
DTYPES = {"float32": (torch.float32, jnp.float32, dict(rtol=1e-6,
                                                        atol=1e-6)),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, dict(rtol=2 ** -7,
                                                          atol=2 ** -7))}


def tree(rng):
    """A nested tree like an LM's: a dict with a list of dicts."""
    return {"embed": rng.standard_normal((6, 4)).astype(np.float32),
            "layers": [{"w": rng.standard_normal((4, 3)).astype(np.float32),
                        "b": rng.standard_normal(3).astype(np.float32)}
                       for _ in range(2)]}


def to_torch(t, dtype):
    return tree_map(lambda a: torch.as_tensor(a).to(dtype), t)


def to_jax(t, dtype):
    return tree_map(lambda a: jnp.asarray(a, dtype=dtype), t)


def assert_trees_close(got, want, tol):
    for g, w in zip(flatten(got), flatten(want), strict=True):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_adam_update_matches_reference(dtype, weight_decay):
    tdt, jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    p0 = tree(rng)
    params, ref_params = to_torch(p0, tdt), to_jax(p0, jdt)
    state, ref_state = adam_init(params), ref_adam_init(ref_params)
    for _ in range(STEPS):
        g = tree(rng)
        params, state = adam_update(params, to_torch(g, tdt), state, lr=1e-2,
                                    weight_decay=weight_decay)
        ref_params, ref_state = ref_adam_update(
            ref_params, to_jax(g, jdt), ref_state, lr=1e-2,
            weight_decay=weight_decay)
        assert_trees_close(params, ref_params, tol)
        assert_trees_close(state.mu, ref_state.mu, DTYPES["float32"][2])
        assert_trees_close(state.nu, ref_state.nu, DTYPES["float32"][2])
    assert int(state.step) == int(ref_state.step) == STEPS
    assert all(leaf.dtype == tdt for leaf in flatten(params))


@pytest.mark.parametrize("with_momentum", [False, True],
                         ids=["fresh", "momentum"])
def test_sgd_update_matches_reference(with_momentum):
    rng = np.random.default_rng(1)
    p0 = tree(rng)
    m0 = tree(rng) if with_momentum else None
    params, ref_params = to_torch(p0, torch.float32), to_jax(p0, jnp.float32)
    m = None if m0 is None else to_torch(m0, torch.float32)
    ref_m = None if m0 is None else to_jax(m0, jnp.float32)
    for _ in range(STEPS):
        g = tree(rng)
        params, m = sgd_update(params, to_torch(g, torch.float32), m,
                               lr=0.05, beta=0.8)
        ref_params, ref_m = ref_sgd_update(
            ref_params, to_jax(g, jnp.float32), ref_m, lr=0.05, beta=0.8)
        for got, want in ((params, ref_params), (m, ref_m)):
            for a, b in zip(flatten(got), flatten(want), strict=True):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_adam_init_and_update_leave_their_inputs():
    """float32 zero moments and a 0-d int32 step on the parameters'
    device; an update returns new trees and changes none it was given."""
    params = to_torch(tree(np.random.default_rng(2)), torch.bfloat16)
    state = adam_init(params)
    assert isinstance(state, AdamState)
    assert all(m.dtype == torch.float32 and not m.any()
               for m in flatten(state.mu) + flatten(state.nu))
    assert state.step.dtype == torch.int32 and state.step.shape == ()
    assert state.mu is not state.nu
    before = tree_map(torch.clone, params)
    grads = tree_map(torch.ones_like, params)
    new, new_state = adam_update(params, grads, state, lr=0.1)
    for a, b in zip(flatten(params), flatten(before), strict=True):
        assert torch.equal(a, b)
    assert int(state.step) == 0 and int(new_state.step) == 1
    assert not any(torch.equal(a, b) for a, b in zip(flatten(new),
                                                     flatten(params)))
