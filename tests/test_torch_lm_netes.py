"""The port's NetES over LM agents (``distributed.netes_dist``,
``models.transformer.loss_fn``) against the JAX reference's replica step:
gemma3-4b-smoke's ``loss_fn`` and its 3 steps on fully connected, on
Erdős–Rényi p = 0.5 and through channel (a), then the checks over every
arch's dump. moonshot-v1-16b-a3b-smoke's and whisper-tiny-smoke's cases
are in ``tests/test_torch_lm_netes_moonshot.py`` and
``tests/test_torch_lm_netes_whisper.py``, the slab-width check in
``tests/test_torch_lm_netes_slab.py``, and the tests that need no dump
(the port alone, and the reference's in-process pieces) in
``tests/test_torch_lm_netes_steps.py``.

The reference's dumps, the helpers and the tolerances are in
``tests/_torch_lm_netes_common.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_lm_netes_common import (NCFG, cases_of, check_loss_fn,
                                    check_replica_step, ref,  # noqa: F401
                                    sub)
from _torch_lm_ref import (NETES_ARCHS, NETES_BCAST, NETES_N, NETES_SEQ,
                           NETES_STEPS)
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.tree import flatten
from repro_torch.distributed import netes_dist
from repro_torch.models import transformer

ARCH = "gemma3-4b-smoke"


@pytest.mark.parametrize("arch", [ARCH])
@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_loss_fn_matches_reference(ref, arch, chunked):
    check_loss_fn(ref, arch, chunked)


@pytest.mark.parametrize("arch, mode", cases_of(ARCH))
def test_replica_step_matches_reference(ref, arch, mode):
    check_replica_step(ref, arch, mode)


# ---------------------------------------------------------------------------
# every arch's dump (made by the other archs' files, or here)
# ---------------------------------------------------------------------------

def test_reference_draws_are_what_the_steps_used(ref):
    """The dump's own checks: the broadcast pattern, the batch shapes and
    the chain's statistics of the reference's tokens."""
    for arch in NETES_ARCHS:
        for t in range(NETES_STEPS):
            assert (float(ref[f"{arch}/beta{t}"]) < NCFG.p_broadcast) == \
                NETES_BCAST[t]
            tokens = ref[f"{arch}/tokens{t}"]
            assert tokens.shape == (NETES_N, 1, NETES_SEQ)
            assert tokens.dtype == np.int32
            assert 0 <= tokens.min() and tokens.max() < get_config(
                arch).vocab_size


def test_population_round_trip(ref):
    """The reference's population → the port's → the reference's, bit for
    bit, on the dumped parameters and on stacked layer plans."""
    for arch in NETES_ARCHS:
        flat = sub(ref, f"{arch}/fc/after1")
        back = convert.lm_population_to_reference(
            convert.lm_population_from_reference(flat, get_config(arch),
                                                 device="cpu"),
            get_config(arch))
        assert sorted(back) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    for arch, layers, plan in (("gemma3-4b-smoke", 8, (0, 2, 4, 0)),
                               ("moonshot-v1-16b-a3b-smoke", 6, (1, 1, 5, 0)),
                               ("jamba-v0.1-52b-smoke", 8, (0, 2, 4, 0))):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        assert transformer.stack_plan(cfg) == plan
        pop = netes_dist.init_population(cfg, 3, seed=1, same_init=False,
                                         device="cpu")
        flat = convert.lm_population_to_reference(pop, cfg)
        assert flat["layers_scan/0/norm1/scale"].shape[:2] == (3, plan[2])
        back = convert.lm_population_from_reference(flat, cfg, device="cpu")
        for a, b in zip(flatten(pop), flatten(back),
                        strict=True):
            assert torch.equal(a, b)
