"""The replica step's slab width against the reference's noise: the same
update whatever the slab (gemma3-4b-smoke, from the ``netes`` dump's
draws). The dump, helpers and tolerances are in
``tests/_torch_lm_netes_common.py``.
"""
import numpy as np

from _torch_lm_netes_common import (NCFG, NETES_ARCHS, NETES_N, PARAM_ATOL,
                                    batch_of, draws_of, initial_population,
                                    ref, topology_of)  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.core.tree import flatten
from repro_torch.distributed import netes_dist


def test_slab_width_leaves_the_update_unchanged_for_the_same_noise(
        ref, monkeypatch):
    """The slab width cuts the same computation differently: with the
    reference's ε (one fixed stream per leaf), one column at a time of a
    slab of 7 or a whole leaf give the same parameters within rounding."""
    arch, mode = NETES_ARCHS[0], "er"
    cfg = get_config(arch)
    outs = []
    for cols in (7, 1 << 24):
        monkeypatch.setattr(netes_dist, "SLAB_COLUMNS", cols)
        step = netes_dist.make_replica_train_step(
            cfg, NCFG, NETES_N, microbatch=1,
            topology=topology_of(ref, arch, mode))
        params = initial_population(ref, arch)
        outs.append(step(params, None, batch_of(ref, arch, 0),
                         draws_of(ref, arch, mode, 0))[0])
    for x, y in zip(*map(flatten, outs), strict=True):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-5,
                                   atol=PARAM_ATOL)
