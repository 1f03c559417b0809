import jax
import numpy as np
import pytest

# NOTE: do NOT set XLA_FLAGS device-count here — smoke tests and benches
# must see the single real CPU device (the 512-device override belongs to
# repro.launch.dryrun ONLY).


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """1-core/35 GB box: a single pytest process accumulates jit'd
    executables across 135 tests and exhausts RAM (LLVM 'Cannot allocate
    memory') — drop compiled programs between modules."""
    yield
    jax.clear_caches()
