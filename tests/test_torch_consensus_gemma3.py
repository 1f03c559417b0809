"""gemma3-4b-smoke's consensus step (dense) against the JAX reference's, in
its four variants (the runtime adjacency, the sparse ``Topology``, the
schedule, channel (a)).

The reference's dumps, the helpers and the tolerances are in
``tests/_torch_consensus_common.py``.
"""
import pytest

from _torch_consensus_common import (cases_of, check_consensus_step,
                                     ref)  # noqa: F401

ARCH = "gemma3-4b-smoke"


@pytest.mark.parametrize("arch, variant", cases_of(ARCH))
def test_consensus_step_matches_reference(ref, arch, variant):
    check_consensus_step(ref, arch, variant)
