"""What the ``tests/test_torch_lm_netes*.py`` files share: the reference's
replica-step dumps, the helpers that hand them to the port, the checks of
a dumped case, and the tolerances.

``repro.distributed.netes_dist`` imports ``repro.models``, which does not
import in this process (ROADMAP queue 3, item a), so the session fixture
``ref`` runs the ``netes`` part of ``tests/_torch_lm_ref.py`` in a
subprocess, one arch at a time as a test first reads it
(``tests/_torch_ref_dumps.py``: the files of the archs make their dumps
side by side): for gemma3-4b-smoke, moonshot-v1-16b-a3b-smoke (a dense
layer, then an MoE layer of 4 experts, top-2) and whisper-tiny-smoke (the
encoder-decoder, each agent's sequence beside its 64 frames) at N = 4
agents, one 64-token sequence each, the reference's own draws of 3 steps
(the batches, ε of every agent and leaf, per stacked slice as its noise
contract folds it, β and the channel's dropout masks), its ``loss_fn``,
and its parameters after 1 and 3 steps on fully connected (dense), on
Erdős–Rényi p = 0.5 (sparse) and through channel (a)
(``quantize(bits=8)|dropout(p=0.1,seed=0)``, sparse: the wire form). The
broadcast draws are fixed to (no, yes, no), so that step 1 holds the
mixing alone and step 2 the broadcast. The port starts from the same
parameters (``convert.lm_population_from_reference``) and is handed the
same draws through ``StepDraws`` (its ε seam fills each slab from the
reference's ε, converted to the port's layout); on the CPU every kernel
wrapper runs its plain version.

Tolerances. ``loss_fn``: rtol = atol = 2e-5, as ``tests/test_torch_lm.py``
(float32 on both sides, other summation orders, ≈ 1e-6). Rewards decide
the update through their ranks only, so every step asserts that the
smallest gap between two of its 2N rewards is above ``MIN_MARGIN`` = 2e-5,
40× the two packages' difference in a loss here (≤ 4.8e-7, one float32
ulp at 6.3), before the ranks are trusted to agree. Parameters: atol = ``PARAM_ATOL`` = 2e-5 with rtol
= 2e-5: Eq. 3 scales the neighbor sum by α/(Nσ²) = 6.25, so a float32
rounding of ≈ 1e-7 in a sum of terms of ≈ 0.1 becomes ≈ 1e-6 in θ, and
three free-running steps carry it on; a wrong weight, sign or
normalization moves θ by ≥ 1e-3. Through the channel each step starts
from the reference's parameters before it (after 0, 1 and 2 steps): q8
rounds θ/scale to integers, so a 1e-7 difference in θ flips a code on the
rare element near a half-integer and moves that element by scale·6.25 ≈
1e-3, a difference of inputs and not of the step; from equal inputs the
codes are equal. The broadcast's message, θ_b ± σε_b, is rounded once by
the reference's compiled FMA and twice by the port, so there too a code
may differ by one: only at an element whose θ_b ± σε_b, in units of the
message's scale, lies within ``TIE`` = 1e-4 of a half-integer (one
rounding of it moves it ≤ 1.5e-5 there), and then every agent's element
differs by exactly that one code. Every other element is held to the
tolerance above.
"""
import math

import numpy as np
import pytest
import torch

from _torch_ref_dumps import ArchDumps, shared_dir
from _torch_lm_ref import (NETES_ARCHS, NETES_BCAST, NETES_CFG, NETES_MODES,
                           NETES_N, NETES_STEPS, XENT_CHUNK)
from repro_torch import convert
from repro_torch.comm.channel import compile_channel
from repro_torch.configs import get_config
from repro_torch.core.netes import NetESConfig
from repro_torch.core.tree import flatten, leaf_paths
from repro_torch.distributed import netes_dist
from repro_torch.models import transformer


TOL = dict(rtol=2e-5, atol=2e-5)
PARAM_ATOL = 2e-5
MIN_MARGIN = 2e-5
TIE = 1e-4
NCFG = NetESConfig(**NETES_CFG)
CASES = [pytest.param(arch, mode, id=f"{arch.split('-')[0]}-{mode}")
         for arch in NETES_ARCHS for mode in NETES_MODES]
METRICS = ("reward_mean", "reward_max", "reward_std", "loss_mean",
           "broadcast")


def cases_of(arch):
    """``CASES`` of one arch."""
    return [c for c in CASES if c.values[0] == arch]


@pytest.fixture(scope="module")
def ref(request, tmp_path_factory):
    """The ``netes`` dumps, the test file's own arch (its ``ARCH``) first."""
    dumps = ArchDumps("netes", NETES_ARCHS, shared_dir(tmp_path_factory),
                      home=getattr(request.module, "ARCH", None))
    yield dumps         # read on demand: the dumps are ≈ 400 MB
    dumps.close()


def sub(ref, prefix):
    """The leaves under ``prefix``, keyed below it."""
    return ref.under(prefix)


def population(ref, arch, prefix):
    """A dumped population (agent axis leading) in the port's layout."""
    return convert.lm_population_from_reference(sub(ref, f"{arch}/{prefix}"),
                                                get_config(arch),
                                                device="cpu")


def initial_population(ref, arch):
    """Every agent starts from the dumped θ⁽⁰⁾ (the reference's
    ``same_init``)."""
    flat = {k: np.broadcast_to(a, (NETES_N,) + a.shape)
            for k, a in sub(ref, f"{arch}/params").items()}
    return convert.lm_population_from_reference(flat, get_config(arch),
                                                device="cpu")


class RefNoise:
    """The ε seam filled from the reference's ε of one step: each agent's
    tree, converted to the port's layout and flattened in the step's leaf
    order."""

    def __init__(self, ref, arch, t):
        cfg = get_config(arch)
        self.eps = [[leaf.reshape(-1) for leaf in flatten(
            convert.lm_params_from_reference(sub(ref, f"{arch}/eps{t}/{i}"),
                                             cfg, device="cpu"))]
                    for i in range(NETES_N)]

    def __call__(self, out, agent, leaf, slab, start):
        out.copy_(self.eps[agent][leaf][start:start + out.numel()])


def batch_of(ref, arch, t):
    """Step t's batch: tokens, and for whisper the reference's frames."""
    tokens = torch.as_tensor(ref[f"{arch}/tokens{t}"])
    batch = {"tokens": tokens, "labels": tokens}
    if ref.has(f"{arch}/frames{t}"):
        batch["frames"] = torch.as_tensor(ref[f"{arch}/frames{t}"])
    return batch


def topology_of(ref, arch, mode):
    adj = ref[f"{arch}/{mode}/adj"]
    kind = NETES_MODES[mode][1]
    if kind == "dense":
        return convert.topology_from_reference("dense", NETES_N,
                                               adj.sum(1), adj=adj,
                                               device="cpu")
    return convert.topology_from_reference(
        "sparse", NETES_N, adj.sum(1),
        neighbor_idx=ref[f"{arch}/{mode}/neighbor_idx"],
        neighbor_mask=ref[f"{arch}/{mode}/neighbor_mask"], device="cpu")


def draws_of(ref, arch, mode, t):
    mask = (torch.as_tensor(ref[f"{arch}/{mode}/edge_mask{t}"])
            if NETES_MODES[mode][2] else None)
    return netes_dist.StepDraws(noise=RefNoise(ref, arch, t),
                                beta=torch.as_tensor(ref[f"{arch}/beta{t}"]),
                                edge_mask=mask)


def assert_population_close(got, ref, arch, prefix, ties=None):
    """``got`` within the tolerance of the dumped population; with
    ``ties`` (``broadcast_ties``), a leaf's column may instead differ by
    one broadcast code in every agent where that code is a near tie."""
    want = population(ref, arch, prefix)
    for i, (path, g, w) in enumerate(zip(
            leaf_paths(got), flatten(got),
            flatten(want), strict=True)):
        g, w = g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1)
        off = (g - w).abs() > PARAM_ATOL + 2e-5 * w.abs()
        if ties is not None and off.any():
            near, scale = ties[i]
            cols = off.any(dim=0)
            assert bool(near[cols].all()), (path, "off a near tie")
            np.testing.assert_allclose((g - w)[:, cols].abs().numpy(),
                                       float(scale), rtol=1e-3,
                                       err_msg=str(path))
            g, w = g[:, ~cols], w[:, ~cols]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-5,
                                   atol=PARAM_ATOL, err_msg=str(path))


def broadcast_ties(cfg, params, batch, draws):
    """Per leaf, the columns where the broadcast message's q8 code is a
    near tie (θ_b ± σε_b over its scale within ``TIE`` of a half-integer),
    and the scale; from the parameters before the step."""
    r_pos, r_neg = netes_dist.agent_rewards(cfg, params, batch, draws.noise,
                                            NCFG.sigma)
    best = int(torch.argmax(torch.cat([r_pos, r_neg])))
    sign = 1.0 if best < NETES_N else -1.0
    out = []
    for i, leaf in enumerate(flatten(params)):
        theta = leaf[best % NETES_N].reshape(-1)
        eps = torch.empty_like(theta)
        draws.noise(eps, best % NETES_N, i, 0, 0)
        bp = theta + (sign * NCFG.sigma) * eps
        scale = bp.abs().max() / 127
        x = bp / scale
        out.append((((x - torch.floor(x)) - 0.5).abs() < TIE, scale))
    return out


def reward_margin(cfg, params, batch, noise):
    """The smallest gap between two of the step's 2N rewards."""
    r_pos, r_neg = netes_dist.agent_rewards(cfg, params, batch, noise,
                                            NCFG.sigma)
    raw = torch.sort(torch.cat([r_pos, r_neg])).values
    return float((raw[1:] - raw[:-1]).min())


def check_loss_fn(ref, arch, chunked):
    cfg = get_config(arch)
    params = convert.lm_params_from_reference(sub(ref, f"{arch}/params"), cfg,
                                              device="cpu")
    batch = {k: v[0] for k, v in batch_of(ref, arch, 0).items()}
    got = transformer.loss_fn(params, cfg, batch,
                              **({"xent_chunk": XENT_CHUNK} if chunked
                                 else {}))
    want = ref[f"{arch}/loss_chunked" if chunked else f"{arch}/loss"]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert got.shape == () and math.isfinite(float(got))


def check_replica_step(ref, arch, mode):
    """3 steps from the reference's θ⁽⁰⁾ and draws: the metrics of each
    step and the parameters after steps 1 and 3 (through the channel,
    after each step, each from the reference's parameters before it)."""
    cfg = get_config(arch)
    chan = (compile_channel(NETES_MODES[mode][2], NETES_N)
            if NETES_MODES[mode][2] else None)
    topo = topology_of(ref, arch, mode)
    step = netes_dist.make_replica_train_step(cfg, NCFG, NETES_N,
                                              microbatch=1, topology=topo,
                                              channel=chan)
    params = initial_population(ref, arch)
    cstate = chan.init(params) if chan is not None else None
    for t in range(NETES_STEPS):
        if chan is not None and t:
            params = population(ref, arch, f"{mode}/after{t}")
        draws, batch = draws_of(ref, arch, mode, t), batch_of(ref, arch, t)
        assert reward_margin(cfg, params, batch, draws.noise) > MIN_MARGIN
        ties = (broadcast_ties(cfg, params, batch, draws)
                if chan is not None and NETES_BCAST[t] else None)
        out = step(params, None, batch, draws,
                   *([cstate] if chan is not None else []))
        params, metrics = out[0], out[1]
        want = sub(ref, f"{arch}/{mode}/metrics{t}")
        names = METRICS + (("msgs", "trigger_frac", "drop_frac")
                           if chan is not None else ())
        assert sorted(want) == sorted(names)
        for name in names:
            np.testing.assert_allclose(metrics[name].numpy(), want[name],
                                       **TOL, err_msg=name)
        assert bool(metrics["broadcast"]) == NETES_BCAST[t]
        if chan is not None:
            cstate = out[2]
        if t + 1 in ((1, 2, 3) if chan is not None else (1, 3)):
            assert_population_close(params, ref, arch, f"{mode}/after{t + 1}",
                                    ties)
