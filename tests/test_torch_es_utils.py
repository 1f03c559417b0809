"""The port's ES utilities against ``repro.core.es_utils``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import es_utils as ref
from repro_torch.core import es_utils
from repro_torch.core.netes import shape_fitness


def _returns_with_ties(m, seed):
    rng = np.random.default_rng(seed)
    # few distinct values: most returns tie with several others
    return rng.integers(-5, 5, size=m).astype(np.float32)


@pytest.mark.parametrize("m", [2, 7, 32, 257])
def test_centered_rank_with_ties_exact(m):
    """Stable double argsort on both sides: ties rank in index order, so
    the shaped values must be EQUAL, not close."""
    for seed in range(3):
        r = _returns_with_ties(m, seed)
        np.testing.assert_array_equal(
            es_utils.centered_rank(torch.as_tensor(r)).numpy(),
            np.asarray(ref.centered_rank(jnp.asarray(r))))


@pytest.mark.parametrize("m", [2, 32, 257])
def test_normalize_returns(m):
    """Population std (ddof 0) on both sides; 1e-6 covers f32 reductions
    summed in another order."""
    r = np.random.default_rng(m).normal(-300, 50, size=m).astype(np.float32)
    np.testing.assert_allclose(
        es_utils.normalize_returns(torch.as_tensor(r)).numpy(),
        np.asarray(ref.normalize_returns(jnp.asarray(r))),
        rtol=1e-6, atol=1e-6)


def test_weight_decay_and_shaping_dispatch():
    th = torch.arange(6, dtype=torch.float32)
    u = torch.ones(6)
    np.testing.assert_array_equal(
        es_utils.apply_weight_decay(th, u, 0.1).numpy(),
        np.asarray(ref.apply_weight_decay(jnp.asarray(th.numpy()),
                                          jnp.asarray(u.numpy()), 0.1)))
    r = torch.tensor([3.0, 1.0, 2.0])
    assert torch.equal(shape_fitness(r, "none"), r)
    with pytest.raises(ValueError, match="fitness shaping"):
        shape_fitness(r, "bogus")


def test_antithetic_pair():
    eps = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        es_utils.antithetic_pair(torch.as_tensor(eps)).numpy(),
        np.asarray(ref.antithetic_pair(jnp.asarray(eps))))


def test_noise_seeds_and_samples():
    """The port's stream seeds (its own, not threefry's): 63-bit, a
    function of their parts in order, distinct for distinct agents and
    steps; ``sample_noise`` gives a generator's normal draws again from
    the same seed, into ``out`` as well."""
    seeds = {es_utils.agent_noise_seed(7, a, t) for a in range(50)
             for t in range(50)}
    assert len(seeds) == 2500
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert es_utils.stream_seed(1, 2) != es_utils.stream_seed(2, 1)
    assert es_utils.stream_seed(1, 2) == es_utils.stream_seed(1, 2)
    with pytest.raises(ValueError):
        es_utils.stream_seed(-1)
    gen = torch.Generator().manual_seed(es_utils.agent_noise_seed(0, 1, 2))
    a = es_utils.sample_noise(gen, (3, 5))
    gen.manual_seed(es_utils.agent_noise_seed(0, 1, 2))
    out = torch.empty(3, 5)
    es_utils.sample_noise(gen, (3, 5), out=out)
    assert torch.equal(a, out) and a.dtype == torch.float32
