"""The port's consensus step (``distributed.netes_dist.
make_consensus_train_step``) against the JAX reference's:
llama4-scout-17b-a16e-smoke's four variants (the runtime adjacency, the
sparse ``Topology``, the schedule, channel (a)), then the checks over every
arch's dump. jamba-v0.1-52b-smoke's, gemma3-4b-smoke's and
llama4-maverick-400b-a17b-smoke's cases are in
``tests/test_torch_consensus_jamba.py``, ``..._gemma3.py`` and
``..._maverick.py``; the port's own checks of the step in
``tests/test_torch_consensus_steps.py``.

The reference's dumps, the helpers and the tolerances are in
``tests/_torch_consensus_common.py``.
"""
import numpy as np
import pytest

from _torch_consensus_common import (NCFG, cases_of, check_consensus_step,
                                     ref, reference_eps,  # noqa: F401
                                     sub)
from _torch_lm_ref import (CONS_ARCHS, CONS_N, CONS_SEQ, CONS_STEPS,
                           NETES_BCAST)
from repro_torch.configs import get_config
from repro_torch.core.topology import TopologySpec

ARCH = "llama4-scout-17b-a16e-smoke"


@pytest.mark.parametrize("arch, variant", cases_of(ARCH))
def test_consensus_step_matches_reference(ref, arch, variant):
    check_consensus_step(ref, arch, variant)


# ---------------------------------------------------------------------------
# every arch's dump (made by the other archs' files, or here)
# ---------------------------------------------------------------------------

def test_regenerated_eps_is_the_references(ref):
    """The ε this file regenerates by the reference's contract equals the
    reference's own ``perturb_params`` (member 0 of step 0)."""
    for arch in CONS_ARCHS:
        want = sub(ref, f"{arch}/eps0/0")
        got = reference_eps(ref, arch, 0)[0]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_reference_draws_are_what_the_steps_used(ref):
    spec = TopologySpec(family="erdos_renyi", n_agents=CONS_N, p=0.5, seed=0)
    np.testing.assert_array_equal(spec.build(), ref["adj"])
    for arch in CONS_ARCHS:
        for t in range(CONS_STEPS):
            assert (float(ref[f"{arch}/beta{t}"]) < NCFG.p_broadcast) == \
                NETES_BCAST[t]
            tokens = ref[f"{arch}/tokens{t}"]
            assert tokens.shape == (CONS_N, 1, CONS_SEQ)
            assert 0 <= tokens.min() and tokens.max() < get_config(
                arch).vocab_size
