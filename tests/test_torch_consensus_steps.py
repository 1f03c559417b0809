"""The port's consensus step on its own, with no reference dump: a
refused event-triggered channel, the checks of its state arguments, the
update against Eq. 3 in float64, the memory it holds, and the degree
weights acting. Tolerances as in ``tests/_torch_consensus_common.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_consensus_common import NCFG
from _torch_lm_ref import CONS_N, NETES_CHANNEL
from repro_torch.comm.channel import compile_channel
from repro_torch.configs import get_config
from repro_torch.core.topology import TopologySpec
from repro_torch.core.tree import flatten, tree_map
from repro_torch.distributed import netes_dist
from repro_torch.models import transformer


# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------

SMOKE = "gemma3-4b-smoke"


def _small_step_inputs(cfg, n=CONS_N, seq=32, seed=0):
    params = transformer.init_params(cfg, seed=seed, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (n, 1, seq),
                           generator=torch.Generator().manual_seed(seed))
    return params, {"tokens": tokens, "labels": tokens}


def test_event_triggered_channel_is_refused():
    cfg = get_config(SMOKE)
    chan = compile_channel("event_triggered(threshold=0.1)|quantize(bits=8)",
                           CONS_N)
    with pytest.raises(ValueError, match="event_triggered"):
        netes_dist.make_consensus_train_step(cfg, NCFG, CONS_N, channel=chan)


def test_step_checks_its_state_arguments():
    cfg = get_config(SMOKE)
    params, batch = _small_step_inputs(cfg)
    step = netes_dist.make_consensus_train_step(
        cfg, NCFG, CONS_N, channel=compile_channel("dropout(p=0.1)", CONS_N))
    with pytest.raises(TypeError, match="chan_state"):
        step(params, torch.ones(CONS_N, CONS_N), batch,
             netes_dist.draw(0, 0, device="cpu"))


@pytest.mark.parametrize("beta", [1.0, 0.0], ids=["mix", "broadcast"])
def test_update_equals_eq3_in_float64(monkeypatch, beta):
    """One update from given rewards against the reference's formula in
    float64 (θ + α/(Pσ)·Σ_i c_i·ε_i − wd·θ, c_i = w_ε,i·deg_i/P; with the
    broadcast, the best of the 2P's θ ± σε), with leaves cut into many
    slabs."""
    monkeypatch.setattr(netes_dist, "SLAB_COLUMNS", 1000)
    cfg = get_config(SMOKE)
    params, _ = _small_step_inputs(cfg)
    theta0 = [leaf.clone().double() for leaf in flatten(params)]
    noise = netes_dist.NoiseStream(seed=3, step=1, device="cpu")
    gen = torch.Generator().manual_seed(5)
    r_pos = torch.randn(CONS_N, generator=gen)
    r_neg = torch.randn(CONS_N, generator=gen)
    degree = torch.tensor([4.0, 2.0, 3.0, 1.0]) / CONS_N
    replica = tree_map(torch.empty_like, params)
    draws = netes_dist.StepDraws(noise=noise, beta=torch.tensor(beta))
    metrics = netes_dist.consensus_update(params, replica, r_pos, r_neg,
                                          draws, degree, NCFG)
    assert float(metrics["broadcast"]) == (beta < NCFG.p_broadcast)
    raw = torch.cat([r_pos, r_neg]).double()
    ranks = torch.argsort(torch.argsort(raw)).double()
    shaped = ranks / (2 * CONS_N - 1) - 0.5
    coeff = (shaped[:CONS_N] - shaped[CONS_N:]) * degree.double()
    best = int(torch.argmax(raw))
    sign = 1.0 if best < CONS_N else -1.0
    scale = NCFG.alpha / (CONS_N * NCFG.sigma)
    for i, (leaf, t0) in enumerate(zip(flatten(params), theta0,
                                       strict=True)):
        flat = t0.reshape(-1)
        eps = []
        for m in range(CONS_N):
            e = torch.empty(flat.numel())
            for s, c0 in enumerate(range(0, flat.numel(), 1000)):
                noise(e[c0:c0 + 1000], m, i, s, c0)
            eps.append(e.double())
        if beta < NCFG.p_broadcast:
            want = flat + sign * NCFG.sigma * eps[best % CONS_N]
        else:
            want = (flat + scale * sum(c * e for c, e in zip(coeff, eps))
                    - NCFG.weight_decay * flat)
        np.testing.assert_allclose(leaf.reshape(-1).double().numpy(),
                                   want.numpy(), rtol=1e-6, atol=1e-7)


def _peak_cpu_bytes(fn):
    """The peak of the CPU allocator's live bytes while ``fn`` runs, above
    what was live before (from the profiler's memory events)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU], profile_memory=True) as p:
        fn()
    live = peak = 0
    for ev in sorted((e for e in p.events() if e.name == "[memory]"),
                     key=lambda e: e.time_range.start):
        live += ev.cpu_memory_usage
        peak = max(peak, live)
    return peak


@pytest.mark.parametrize("chan_text", [None, NETES_CHANNEL],
                         ids=["plain", "channel"])
def test_step_holds_theta_one_replica_and_slabs(monkeypatch, chan_text):
    """The step's peak above θ is one replica, a loss's activations and a
    few slabs (and through a quantizing channel one leaf's message): no
    second tree of θ's size, no ε of a whole leaf. Slabs of 4096 columns
    keep the slabs far below θ."""
    cols = 4096
    monkeypatch.setattr(netes_dist, "SLAB_COLUMNS", cols)
    cfg = get_config(SMOKE)
    params, batch = _small_step_inputs(cfg)
    theta_bytes = sum(leaf.numel() * 4 for leaf in flatten(params))
    leaf_bytes = max(leaf.numel() * 4 for leaf in flatten(params))
    loss_peak = _peak_cpu_bytes(lambda: transformer.loss_fn(
        params, cfg, {k: v[0] for k, v in batch.items()}))
    chan = compile_channel(chan_text, CONS_N) if chan_text else None
    topo = sparse_topology_of_spec()
    step = netes_dist.make_consensus_train_step(cfg, NCFG, CONS_N,
                                                topology=topo, channel=chan)
    states = [chan.init(params)] if chan else []
    draws = dataclasses.replace(netes_dist.draw(0, 0, device="cpu"),
                                beta=torch.tensor(0.0))
    peak = _peak_cpu_bytes(lambda: step(params, None, batch, draws,
                                        *states))
    bound = (theta_bytes + loss_peak + 8 * cols * 4
             + (2 * leaf_bytes if chan else 0))
    assert peak <= bound, (peak, theta_bytes, loss_peak)
    assert peak < 2 * theta_bytes + loss_peak


def sparse_topology_of_spec():
    from repro_torch.core import topology_repr
    return topology_repr.from_spec(
        TopologySpec(family="erdos_renyi", n_agents=CONS_N, p=0.5, seed=0),
        representation="sparse", device="cpu")


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e-smoke",
                                  "jamba-v0.1-52b-smoke"])
def test_degree_weights_act(arch):
    """Without a broadcast, θ after one step differs between a fully
    connected graph (equal degrees) and ER p = 0.5 (unequal ones), from
    the same θ⁽⁰⁾ and draws; and equals the step on the runtime
    adjacency of the same ER graph."""
    from repro_torch.core import topology_repr
    cfg = get_config(arch)
    out = {}
    for family in ("fully_connected", "erdos_renyi"):
        spec = TopologySpec(family=family, n_agents=CONS_N, p=0.5, seed=0)
        for runtime in (False, True):
            params, batch = _small_step_inputs(cfg)
            topo = topology_repr.from_spec(spec, device="cpu")
            step = netes_dist.make_consensus_train_step(
                cfg, NCFG, CONS_N, topology=None if runtime else topo)
            draws = dataclasses.replace(netes_dist.draw(7, 0, device="cpu"),
                                        beta=torch.tensor(1.0))
            step(params, topo.to_dense() if runtime else None, batch, draws)
            out[family, runtime] = flatten(params)
    for a, b in zip(out["erdos_renyi", False], out["erdos_renyi", True],
                    strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert any(not torch.equal(a, b) for a, b in zip(
        out["fully_connected", False], out["erdos_renyi", False],
        strict=True))
