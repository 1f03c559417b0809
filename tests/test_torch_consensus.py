"""The port's consensus step (``distributed.netes_dist.
make_consensus_train_step``: one shared θ, the population
time-multiplexed, the topology entering through degree weights) against
the JAX reference's ``make_consensus_train_step``.

``repro.distributed.netes_dist`` imports ``repro.models``, which does not
import in this process (ROADMAP queue 3, item a), so a session fixture
runs the ``consensus`` part of ``tests/_torch_lm_ref.py`` once in a
subprocess: llama4-scout-17b-a16e-smoke (chunked attention, top-1 MoE of
16 experts), jamba-v0.1-52b-smoke (mamba + MoE, sliding attention) and
gemma3-4b-smoke (dense), P = 4 members, one 64-token sequence each, 3
steps of the reference's own draws, in four variants: the runtime
adjacency (ER p = 0.5, dense), the same graph as a sparse ``Topology``, a
``resample_er`` schedule redrawn at every step (its uniforms injected),
and the Topology through channel (a) ``quantize(bits=8)|dropout(p=0.1)``
(its dropout masks injected); llama4-maverick-400b-a17b-smoke on the
runtime adjacency. The broadcast draws are (no, yes, no). The port starts
from the reference's θ⁽⁰⁾ (``convert.lm_params_from_reference``) and is
handed the same draws through ``StepDraws``: β as dumped, ε through the
seam. The dump holds each step's member key; member i's ε is regenerated
here by the reference's noise contract (``fold_in(k_agents, i)``, then
per leaf in its flatten order, and per leading slice of a leaf of rank ≥
3, a standard normal), checked against the dumped ε of member 0, and
converted to the port's layout. On the CPU every kernel wrapper runs its
plain version.

Tolerances (7a's, ``tests/test_torch_lm_netes.py``). Metrics: rtol =
atol = 2e-5; the packages' losses differ by ≤ 4.8e-7 at these sizes, and
every step asserts that the smallest gap between two of its 2P rewards
is above ``MIN_MARGIN`` = 2e-5, so that both rank them alike. Parameters:
atol = rtol = 2e-5; a step moves θ by α/(Pσ)·Σ c_i·ε_i, ≈ 0.1 here, so a
float32 rounding in a term is ≈ 1e-8 in θ, and a wrong weight, sign or
degree moves it by ≥ 1e-3. Through the channel each step starts from the
reference's parameters before it, and in the broadcast step a q8 code of
the message may differ by one only at an element whose θ ± σε_b, over
the leaf's scale, lies within ``TIE`` = 1e-4 of a half-integer (the
reference rounds θ + σε once in a fused multiply-add, the port twice).
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_ref import (CONS_ADJ_ONLY, CONS_AFTER, CONS_ARCHS, CONS_N,
                           CONS_SCHEDULE, CONS_SEQ, CONS_STEPS, NETES_BCAST,
                           NETES_CFG, NETES_CHANNEL)
from repro_torch import convert
from repro_torch.comm.channel import compile_channel
from repro_torch.configs import get_config
from repro_torch.core.netes import NetESConfig
from repro_torch.core.topology import TopologySpec
from repro_torch.core.topology_sched import ScheduleSpec, compile_schedule
from repro_torch.core.tree import flatten, leaf_paths, tree_map
from repro_torch.distributed import netes_dist
from repro_torch.models import transformer

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
TOL = dict(rtol=2e-5, atol=2e-5)
MIN_MARGIN = 2e-5
TIE = 1e-4
NCFG = NetESConfig(**NETES_CFG)
METRICS = ("reward_mean", "reward_max", "loss_mean", "broadcast")
SHORT = {"llama4-scout-17b-a16e-smoke": "scout",
         "jamba-v0.1-52b-smoke": "jamba", "gemma3-4b-smoke": "gemma3",
         "llama4-maverick-400b-a17b-smoke": "maverick"}
CASES = [pytest.param(arch, variant, id=f"{SHORT[arch]}-{variant}")
         for arch in CONS_ARCHS
         for variant in (("adj",) if arch in CONS_ADJ_ONLY else CONS_AFTER)]


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("consensus_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, str(TESTS / "_torch_lm_ref.py"),
                          str(path), "consensus"], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        yield z


def sub(ref, prefix):
    """The leaves under ``prefix``, keyed below it."""
    return {k[len(prefix) + 1:]: ref[k] for k in ref.files
            if k.startswith(prefix + "/")}


def params_of(ref, arch, prefix):
    return convert.lm_params_from_reference(sub(ref, f"{arch}/{prefix}"),
                                            get_config(arch), device="cpu")


@functools.lru_cache(maxsize=None)
def _member_eps_fn(shapes):
    """The reference's ε of one member, jitted once per tree of shapes."""

    @jax.jit
    def member(k_agents, i):
        akey = jax.random.fold_in(k_agents, i)
        out = []
        for leaf, shape in enumerate(shapes):
            key = jax.random.fold_in(akey, leaf)
            if len(shape) >= 3:
                ks = jax.vmap(lambda j, key=key: jax.random.fold_in(key, j))(
                    jnp.arange(shape[0]))
                out.append(jax.lax.map(
                    lambda k, shape=shape: jax.random.normal(
                        k, shape[1:], jnp.float32), ks))
            else:
                out.append(jax.random.normal(key, shape, jnp.float32))
        return out

    return member


def reference_eps(ref, arch, t):
    """Each member's ε of step t by the reference's noise contract
    (``repro.distributed.netes_dist.perturb_params`` at σ = 1 from zeros),
    as flat dicts in the reference's layout."""
    keys = [str(k) for k in ref[f"{arch}/leaf_keys"]]
    member = _member_eps_fn(tuple(ref[f"{arch}/params/{k}"].shape
                                  for k in keys))
    k_agents = jnp.asarray(ref[f"{arch}/k_agents{t}"])
    return [dict(zip(keys, map(np.asarray, member(k_agents, i)),
                     strict=True)) for i in range(CONS_N)]


_EPS = {}


def port_eps(ref, arch, t):
    """``reference_eps`` in the port's layout: per member, its leaves
    flattened in the port's order (the last arch's steps kept)."""
    if (arch, t) not in _EPS:
        if any(a != arch for a, _ in _EPS):
            _EPS.clear()
        cfg = get_config(arch)
        _EPS[arch, t] = [[leaf.reshape(-1) for leaf in flatten(
            convert.lm_params_from_reference(flat, cfg, device="cpu"))]
                         for flat in reference_eps(ref, arch, t)]
    return _EPS[arch, t]


class RefNoise:
    """The ε seam filled from the reference's ε of one step, each
    member's tree converted to the port's layout."""

    def __init__(self, ref, arch, t):
        self.eps = port_eps(ref, arch, t)

    def __call__(self, out, agent, leaf, slab, start):
        out.copy_(self.eps[agent][leaf][start:start + out.numel()])


def batch_of(ref, arch, t):
    tokens = torch.as_tensor(ref[f"{arch}/tokens{t}"])
    return {"tokens": tokens, "labels": tokens}


def sparse_topology(ref):
    adj = ref["adj"]
    return convert.topology_from_reference(
        "sparse", CONS_N, adj.sum(1), neighbor_idx=ref["neighbor_idx"],
        neighbor_mask=ref["neighbor_mask"], device="cpu")


def reward_margin(cfg, params, batch, noise):
    replica = tree_map(torch.empty_like, params)
    raw = torch.sort(torch.cat(netes_dist.member_rewards(
        cfg, params, batch, noise, NCFG.sigma, replica))).values
    return float((raw[1:] - raw[:-1]).min())


def broadcast_ties(cfg, params, batch, noise):
    """Per leaf, the elements where the broadcast message's q8 code is a
    near tie, and the leaf's scale; from the parameters before the
    step."""
    replica = tree_map(torch.empty_like, params)
    r_pos, r_neg = netes_dist.member_rewards(cfg, params, batch, noise,
                                             NCFG.sigma, replica)
    best = int(torch.argmax(torch.cat([r_pos, r_neg])))
    sign = 1.0 if best < CONS_N else -1.0
    out = []
    for i, leaf in enumerate(flatten(params)):
        theta = leaf.reshape(-1)
        eps = torch.empty_like(theta)
        noise(eps, best % CONS_N, i, 0, 0)
        bp = theta + (sign * NCFG.sigma) * eps
        scale = bp.abs().max() / 127
        x = bp / scale
        out.append((((x - torch.floor(x)) - 0.5).abs() < TIE, scale))
    return out


def assert_params_close(got, want, ties=None):
    """``got`` within the tolerance of ``want``; with ``ties``, an element
    may instead differ by one broadcast code where that code is a near
    tie."""
    for i, (path, g, w) in enumerate(zip(leaf_paths(got), flatten(got),
                                         flatten(want), strict=True)):
        g, w = g.reshape(-1), w.reshape(-1)
        off = (g - w).abs() > TOL["atol"] + TOL["rtol"] * w.abs()
        if ties is not None and off.any():
            near, scale = ties[i]
            assert bool(near[off].all()), (path, "off a near tie")
            np.testing.assert_allclose((g - w)[off].abs().numpy(),
                                       float(scale), rtol=1e-3,
                                       err_msg=str(path))
            g, w = g[~off], w[~off]
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL,
                                   err_msg=str(path))


# ---------------------------------------------------------------------------
# against the reference
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


@pytest.mark.parametrize("arch, variant", CASES)
def test_consensus_step_matches_reference(ref, arch, variant):
    """3 steps from the reference's θ⁽⁰⁾ and draws: each step's metrics
    (and the channel's message count) and the parameters after the steps
    of ``CONS_AFTER`` (through the channel, after each step, each from
    the reference's parameters before it)."""
    cfg = get_config(arch)
    topology = schedule = chan = None
    adj = None
    if variant == "adj":
        adj = torch.as_tensor(ref["adj"])
    elif variant in ("topo", "chan"):
        topology = sparse_topology(ref)
    if variant == "sched":
        schedule = compile_schedule(
            ScheduleSpec.parse(CONS_SCHEDULE),
            TopologySpec(family="erdos_renyi", n_agents=CONS_N, p=0.5,
                         seed=0))
        states = [schedule.init(device="cpu")]
    elif variant == "chan":
        chan = compile_channel(NETES_CHANNEL, CONS_N)
    step = netes_dist.make_consensus_train_step(
        cfg, NCFG, CONS_N, topology=topology, schedule=schedule,
        channel=chan)
    params = params_of(ref, arch, "params")
    if chan is not None:
        states = [chan.init(params)]
    elif schedule is None:
        states = []
    pre = f"{arch}/{variant}"
    for t in range(CONS_STEPS):
        if chan is not None and t:
            params = params_of(ref, arch, f"{variant}/after{t}")
        noise, batch = RefNoise(ref, arch, t), batch_of(ref, arch, t)
        assert reward_margin(cfg, params, batch, noise) > MIN_MARGIN
        ties = (broadcast_ties(cfg, params, batch, noise)
                if chan is not None and NETES_BCAST[t] else None)
        draws = netes_dist.StepDraws(
            noise=noise, beta=torch.as_tensor(ref[f"{arch}/beta{t}"]),
            edge_mask=(torch.as_tensor(ref[f"{pre}/edge_mask{t}"])
                       if chan is not None else None),
            schedule_u=(torch.as_tensor(ref[f"{pre}/u{t}"])
                        if schedule is not None else None))
        out = step(params, adj, batch, draws, *states)
        assert out[0] is params
        metrics, states = out[1], list(out[2:])
        want = sub(ref, f"{pre}/metrics{t}")
        names = METRICS + (("msgs", "trigger_frac") if chan else ())
        assert sorted(want) == sorted(names)
        for name in names:
            np.testing.assert_allclose(metrics[name].numpy(), want[name],
                                       **TOL, err_msg=name)
        assert bool(metrics["broadcast"]) == NETES_BCAST[t]
        if chan is not None:
            assert float(states[0].msgs) == float(ref[f"{pre}/chan_msgs{t}"])
        if t + 1 in CONS_AFTER[variant]:
            assert_params_close(params, params_of(ref, arch,
                                                  f"{variant}/after{t + 1}"),
                                ties)


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
