"""whisper-tiny-smoke's NetES over LM agents (the encoder-decoder, each
agent's sequence beside its 64 frames) against the JAX reference's replica
step: its ``loss_fn`` and its 3 steps on fully connected, on Erdős–Rényi
p = 0.5 and through channel (a).

The reference's dumps, the helpers and the tolerances are in
``tests/_torch_lm_netes_common.py``.
"""
import pytest

from _torch_lm_netes_common import (cases_of, check_loss_fn,
                                    check_replica_step, ref)  # noqa: F401

ARCH = "whisper-tiny-smoke"


@pytest.mark.parametrize("arch", [ARCH])
@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_loss_fn_matches_reference(ref, arch, chunked):
    check_loss_fn(ref, arch, chunked)


@pytest.mark.parametrize("arch, mode", cases_of(ARCH))
def test_replica_step_matches_reference(ref, arch, mode):
    check_replica_step(ref, arch, mode)
