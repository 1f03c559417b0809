"""llama4-maverick-400b-a17b-smoke's consensus step (top-1 MoE of 128
experts on every other layer) against the JAX reference's, on the runtime
adjacency.

The reference's dumps, the helpers and the tolerances are in
``tests/_torch_consensus_common.py``.
"""
import pytest

from _torch_consensus_common import (cases_of, check_consensus_step,
                                     ref)  # noqa: F401

ARCH = "llama4-maverick-400b-a17b-smoke"


@pytest.mark.parametrize("arch, variant", cases_of(ARCH))
def test_consensus_step_matches_reference(ref, arch, variant):
    check_consensus_step(ref, arch, variant)
