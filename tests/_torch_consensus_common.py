"""What the ``tests/test_torch_consensus*.py`` files share: the reference's
consensus-step dumps, the helpers that hand them to the port, the check of
a dumped case, and the tolerances. The step is the port's
``distributed.netes_dist.make_consensus_train_step`` (one shared θ, the
population time-multiplexed, the topology entering through degree
weights) against the JAX reference's ``make_consensus_train_step``.

``repro.distributed.netes_dist`` imports ``repro.models``, which does not
import in this process (ROADMAP queue 3, item a), so the fixture ``ref``
runs the ``consensus`` part of ``tests/_torch_lm_ref.py`` in a
subprocess, one arch at a time as a test first reads it
(``tests/_torch_ref_dumps.py``: the files of the archs make their dumps
side by side): llama4-scout-17b-a16e-smoke (chunked attention, top-1 MoE of
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
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref_dumps import ArchDumps, shared_dir
from _torch_lm_ref import (CONS_ADJ_ONLY, CONS_AFTER, CONS_ARCHS, CONS_N,
                           CONS_SCHEDULE, CONS_STEPS, NETES_BCAST, NETES_CFG,
                           NETES_CHANNEL)
from repro_torch import convert
from repro_torch.comm.channel import compile_channel
from repro_torch.configs import get_config
from repro_torch.core.netes import NetESConfig
from repro_torch.core.topology import TopologySpec
from repro_torch.core.topology_sched import ScheduleSpec, compile_schedule
from repro_torch.core.tree import flatten, leaf_paths, tree_map
from repro_torch.distributed import netes_dist


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


def cases_of(arch):
    """``CASES`` of one arch."""
    return [c for c in CASES if c.values[0] == arch]


@pytest.fixture(scope="module")
def ref(request, tmp_path_factory):
    """The ``consensus`` dumps, the test file's own arch (its ``ARCH``)
    first."""
    dumps = ArchDumps("consensus", CONS_ARCHS, shared_dir(tmp_path_factory),
                      home=getattr(request.module, "ARCH", None))
    yield dumps
    dumps.close()


def sub(ref, prefix):
    """The leaves under ``prefix``, keyed below it."""
    return ref.under(prefix)


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


def check_consensus_step(ref, arch, variant):
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
