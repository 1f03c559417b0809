"""``repro_torch.core.topology_sched`` and the scheduled NetES step against
the JAX reference (``repro.core.topology_sched``, ``repro.core.netes``).

The reference's uniform draws (``anneal_density``'s fixed draw from
``PRNGKey(spec.seed)``, ``resample_er``'s redraw from ``split(key)[1]``)
are injected through the port's seam (``init(u=)``, ``advance(state,
u=)``, ``Draws.schedule_u``).

Tolerances: ``ScheduleSpec`` fields, ``compile_schedule``'s
``representation``, ``k_max`` and ``base_offsets``, and every graph
(``to_dense``, ``neighbor_idx``, ``neighbor_mask``, ``deg``, a rotating
circulant's shifts) EQUAL. Scheduled steps on ``landscape:rastrigin`` (D =
64, N = 15): the best agent, the broadcast flag and ``msgs`` EQUAL; θ
within atol 2e-5 + rtol 2e-5 as in tests/test_torch_netes.py (Eq. 3 adds
≤ 2N f32 terms in another order), plus, with a q8 channel, one
quantization level where a payload element lies at a rounding boundary
(``_torch_ref.one_level_slack``); rewards within rtol 1e-5 (the landscape
has no unstable rollout).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as ref_envs
from _torch_ref import (one_level_slack, port_topology, reference_edge_mask,
                        step_draws)
from repro.comm import channel as ref_cc
from repro.core import netes as ref_netes
from repro.core import topology as ref_topology
from repro.core import topology_sched as ref_sched
from repro_torch import convert, envs
from repro_torch.comm import channel as port_cc
from repro_torch.core import netes
from repro_torch.core import topology as topo_gen
from repro_torch.core import topology_sched as sched
from repro_torch.core.netes import Draws, NetESConfig
from repro_torch.core.topology import TopologySpec

T = 6


def _specs(family, n, p, seed=0):
    kw = dict(family=family, n_agents=n, p=p, seed=seed)
    return ref_topology.TopologySpec(**kw), TopologySpec(**kw)


def _compile(text, family, n, p, rep, seed=0, k_max=None):
    """The schedule compiled by both packages (``k_max`` forces the pad)."""
    ref_base, base = _specs(family, n, p, seed)
    ref = ref_sched.compile_schedule(ref_sched.ScheduleSpec.parse(text),
                                     ref_base, rep)
    port = sched.compile_schedule(sched.ScheduleSpec.parse(text), base, rep)
    if k_max is not None:
        ref = dataclasses.replace(ref, k_max=k_max)
        port = dataclasses.replace(port, k_max=k_max)
    return ref, port


def _anneal_u(ref_schedule):
    """The reference's fixed anneal draw, or None for other kinds."""
    if ref_schedule.spec.kind != "anneal_density":
        return None
    n = ref_schedule.n
    return torch.as_tensor(np.array(jax.random.uniform(
        jax.random.PRNGKey(ref_schedule.spec.seed), (n, n))))


def _redraw_u(port_schedule, ref_state):
    """The uniform the reference's advance from ``ref_state`` redraws
    from, or None if that advance does not redraw."""
    if not port_schedule.redraws(int(ref_state.t) + 1):
        return None
    n = port_schedule.n
    sub = jax.random.split(ref_state.key)[1]
    return torch.as_tensor(np.array(jax.random.uniform(sub, (n, n))))


def _assert_same_graph(topo, ref_topo, where):
    assert topo.kind == ref_topo.kind, where
    np.testing.assert_array_equal(topo.to_dense().numpy(),
                                  np.asarray(ref_topo.to_dense()),
                                  err_msg=where)
    np.testing.assert_array_equal(topo.deg.numpy(), np.asarray(ref_topo.deg),
                                  err_msg=where)
    if topo.kind == "sparse":
        np.testing.assert_array_equal(topo.neighbor_idx.numpy(),
                                      np.asarray(ref_topo.neighbor_idx),
                                      err_msg=where)
        np.testing.assert_array_equal(topo.neighbor_mask.numpy(),
                                      np.asarray(ref_topo.neighbor_mask),
                                      err_msg=where)
    if topo.kind == "circulant" and ref_topo.shifts is not None:
        assert topo.shifts == tuple(np.asarray(ref_topo.shifts).tolist()), \
            where


# ---------------------------------------------------------------------------
# spec parsing and compilation
# ---------------------------------------------------------------------------

PARSE_CASES = [
    "static", "static()", "resample_er(period=8)",
    " resample_er ( period = 2 , seed = 7 ) ", "rotate_circulant(stride=3)",
    "anneal_density(p_end=0.05, horizon=100)",
    "anneal_density(p_end=1e-2,horizon=3,seed=4)",
    "resample_er(8)", "warp_drive(period=2)", "resample_er(period=0)",
    "anneal_density(p_end=0.1)", "anneal_density(horizon=3)",
    "resample_er(period=x)", "", "a b", "resample_er(period=2",
]


def _outcome(parse, text):
    try:
        return dataclasses.asdict(parse(text))
    except (ValueError, TypeError) as err:
        return type(err)


@pytest.mark.parametrize("text", PARSE_CASES)
def test_schedule_spec_parse_matches_reference(text):
    assert (_outcome(sched.ScheduleSpec.parse, text)
            == _outcome(ref_sched.ScheduleSpec.parse, text))


BASES = {"er": ("erdos_renyi", 0.2), "circ": ("circulant_erdos_renyi", 0.3),
         "fc": ("fully_connected", 1.0)}
KIND_TEXT = {"static": "static", "anneal_density":
             "anneal_density(p_end=0.45,horizon=5)",
             "resample_er": "resample_er(period=3)",
             "rotate_circulant": "rotate_circulant(stride=2)"}


@pytest.mark.parametrize("n", [8, 64, 257])
@pytest.mark.parametrize("kind", sched.KINDS)
@pytest.mark.parametrize("base", sorted(BASES))
def test_compile_schedule_matches_reference(n, kind, base):
    """The same representation, pad and offsets, or the same rejection,
    for each representation asked for."""
    family, p = BASES[base]
    ref_base, port_base = _specs(family, n, p, seed=1)
    for rep in ("auto", "dense", "sparse", "circulant"):
        got = want = None
        try:
            want = ref_sched.compile_schedule(
                ref_sched.ScheduleSpec.parse(KIND_TEXT[kind]), ref_base, rep)
        except ValueError:
            with pytest.raises(ValueError):
                sched.compile_schedule(
                    sched.ScheduleSpec.parse(KIND_TEXT[kind]), port_base,
                    rep)
            continue
        got = sched.compile_schedule(
            sched.ScheduleSpec.parse(KIND_TEXT[kind]), port_base, rep)
        assert (got.representation, got.k_max, got.base_offsets, got.n) == (
            want.representation, want.k_max, want.base_offsets, want.n), rep


def test_pad_k_max_at_the_main_path():
    """N = 1000, ER p = 0.1 under a resample: the pad the sparse kernels
    are launched with on the scheduled main path."""
    ref, port = _compile("resample_er(period=2)", "erdos_renyi", 1000, 0.1,
                         "auto")
    assert port.representation == ref.representation == "sparse"
    assert port.k_max == ref.k_max == 140
    assert sched.pad_k_max(1000, 0.1, 130) == ref_sched.pad_k_max(
        1000, 0.1, 130)


# ---------------------------------------------------------------------------
# graphs step by step, the reference's uniforms injected
# ---------------------------------------------------------------------------

TRAJECTORY_CASES = [
    # (schedule, family, n, p, representation, forced k_max)
    ("static", "erdos_renyi", 16, 0.3, "dense", None),
    ("static", "erdos_renyi", 16, 0.3, "sparse", None),
    ("static", "circulant_erdos_renyi", 16, 0.3, "auto", None),
    ("anneal_density(p_end=0.1,horizon=4,seed=2)", "erdos_renyi", 24, 0.5,
     "dense", None),
    ("anneal_density(p_end=0.1,horizon=4,seed=2)", "erdos_renyi", 24, 0.5,
     "sparse", None),
    ("anneal_density(p_end=0.6,horizon=5,seed=1)", "erdos_renyi", 24, 0.2,
     "sparse", None),
    ("anneal_density(p_end=0.1,horizon=4,seed=2)", "erdos_renyi", 24, 0.5,
     "sparse", 6),                          # rows truncated to K_max = 6
    ("resample_er(period=2,seed=5)", "erdos_renyi", 20, 0.3, "dense", None),
    ("resample_er(period=2,seed=5)", "erdos_renyi", 20, 0.3, "sparse", None),
    ("resample_er(period=1,seed=9)", "erdos_renyi", 20, 0.3, "auto", None),
    ("resample_er(period=3,seed=5)", "circulant_erdos_renyi", 20, 0.3,
     "auto", None),
] + [(f"rotate_circulant(stride={s})", "ring", n, 0.0, "auto", None)
     for n in (12, 13, 16) for s in (1, 2, 5)] + [
    ("rotate_circulant(stride=2)", "circulant_erdos_renyi", 13, 0.5,
     "circulant", None)]


@pytest.mark.parametrize("text,family,n,p,rep,k_max", TRAJECTORY_CASES)
def test_graphs_equal_reference_every_step(text, family, n, p, rep, k_max):
    ref, port = _compile(text, family, n, p, rep, k_max=k_max)
    ref_state = ref.init()
    if k_max is not None:
        # the forced pad must bite: a graph of the schedule has a row
        # longer than it
        u = np.asarray(_anneal_u(ref))
        assert max((np.triu(u < ref.base.p, 1) + np.triu(u < ref.base.p, 1).T)
                   .sum(axis=1)) + 1 > k_max
    state = port.init(u=_anneal_u(ref), device="cpu")
    advance = jax.jit(ref.advance)
    for t in range(T + 1):
        where = f"{text} {rep} n={n}, t={t}"
        assert state.t == int(ref_state.t) == t
        _assert_same_graph(state.topo, ref_state.topo, where)
        if port.representation == "sparse" or state.topo.kind == "sparse":
            assert state.topo.k_max == ref_state.topo.k_max, where
        u = _redraw_u(port, ref_state)
        ref_state = advance(ref_state)
        state = port.advance(state, u=u)


@pytest.mark.parametrize("text,family,p,rep", [
    ("resample_er(period=2,seed=5)", "erdos_renyi", 0.3, "sparse"),
    ("anneal_density(p_end=0.1,horizon=5,seed=2)", "erdos_renyi", 0.5,
     "dense"),
    ("rotate_circulant(stride=2)", "ring", 0.0, "auto")])
def test_state_carried_from_reference_mid_schedule(text, family, p, rep):
    """``convert.schedule_state_from_reference`` at t = 3: the port goes
    on from the reference's state (its topology, t and anneal's uniform)
    to the same graphs."""
    ref, port = _compile(text, family, 20, p, rep)
    ref_state = ref.init()
    advance = jax.jit(ref.advance)
    for _ in range(3):
        ref_state = advance(ref_state)
    state = convert.schedule_state_from_reference(
        port, port_topology(ref_state.topo), int(ref_state.t),
        _anneal_u(ref))
    assert state.t == 3
    for t in range(3, T + 1):
        _assert_same_graph(state.topo, ref_state.topo, f"{text}, t={t}")
        u = _redraw_u(port, ref_state)
        ref_state = advance(ref_state)
        state = port.advance(state, u=u)
    with pytest.raises(ValueError, match="uniform"):
        convert.schedule_state_from_reference(
            port, state.topo, 0, None if ref.spec.kind == "anneal_density"
            else torch.rand(20, 20))


@pytest.mark.parametrize("horizon", [1, 3, 7, 13, 100])
def test_anneal_threshold_matches_reference(horizon, monkeypatch):
    """``density_at`` against the threshold the reference's compiled
    advance compares with, read out by handing its ``er_adjacency`` a
    stand-in that returns p. The plain float32 order of the expression
    misses some of them by an ulp; a uniform in that gap would flip an
    edge."""
    monkeypatch.setattr(ref_sched, "er_adjacency",
                        lambda key, n, p: jnp.zeros((n, n), jnp.float32) + p)
    plain_misses = 0
    for p, p_end in [(0.1, 0.02), (0.3, 0.9), (0.5, 0.1), (0.05, 0.33),
                     (0.123, 0.0), (0.9, 0.1)]:
        ref, port = _compile(
            f"anneal_density(p_end={p_end},horizon={horizon})",
            "erdos_renyi", 8, p, "dense")
        state = ref.init()
        advance = jax.jit(ref._advance_impl)
        for t in range(1, horizon + 3):
            state = advance(state)
            want = np.float32(state.topo.adj[0, 0])
            assert np.float32(port.density_at(t)) == want, (p, p_end, t)
            frac = min(np.float32(t) / np.float32(horizon), np.float32(1))
            plain_misses += (np.float32(p) + np.float32(p_end - p) * frac
                             != want)
    if horizon in (3, 7, 13):
        assert plain_misses > 0


def test_rotation_keeps_degree_and_matches_offsets():
    """Every rotated circulant is the host rebuild of its offsets, with
    the base degree (2K + 1) at every step."""
    _, port = _compile("rotate_circulant(stride=3)", "circulant_erdos_renyi",
                       31, 0.3, "auto")
    state = port.init(device="cpu")
    deg0 = state.topo.deg.clone()
    for t in range(2 * T):
        dense = topo_gen.circulant_from_offsets(
            31, port.offsets_at(t))
        np.testing.assert_array_equal(state.topo.to_dense().numpy(), dense)
        np.testing.assert_array_equal(dense.sum(axis=1), deg0.numpy())
        assert torch.equal(state.topo.deg, deg0)
        state = port.advance(state)


@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_anneal_is_nested_and_reaches_p_end(rep):
    n, horizon = 48, 6
    _, port = _compile("anneal_density(p_end=0.02,horizon=6,seed=3)",
                       "erdos_renyi", n, 0.4, rep)
    state = port.init(device="cpu")
    prev = state.topo.to_dense()
    for t in range(1, horizon + 2):
        state = port.advance(state)
        cur = state.topo.to_dense()
        assert bool((cur <= prev).all()), f"an edge appeared at t={t}"
        prev = cur
    again = port.advance(state)
    assert torch.equal(again.topo.to_dense(), prev)   # frozen past horizon
    density = (float(prev.sum()) - n) / (n * (n - 1))
    assert density < 0.1


@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_resample_redraws_exactly_on_period(rep):
    n, period = 32, 3
    _, port = _compile("resample_er(period=3,seed=9)", "erdos_renyi", n, 0.2,
                       rep, seed=4)
    state = port.init(device="cpu")
    prev = state.topo.to_dense()
    np.testing.assert_array_equal(
        prev.numpy(), TopologySpec(family="erdos_renyi", n_agents=n, p=0.2,
                                   seed=4).build())
    for t in range(1, 2 * period + 2):
        draws_before = state.generator.get_state()
        state = port.advance(state)
        cur = state.topo.to_dense()
        if t % period == 0:
            assert not torch.equal(cur, prev), f"no redraw at t={t}"
        else:
            assert torch.equal(cur, prev), f"changed off-period at t={t}"
            # off-period steps draw nothing
            assert torch.equal(state.generator.get_state(), draws_before)
        assert torch.equal(cur, cur.T)
        assert torch.equal(torch.diagonal(cur), torch.ones(n))
        assert torch.equal(state.topo.deg, cur.sum(dim=1))
        prev = cur


def test_uniform_seam_rejects_misuse():
    _, resample = _compile("resample_er(period=2)", "erdos_renyi", 8, 0.3,
                           "dense")
    state = resample.init(device="cpu")
    with pytest.raises(ValueError, match="draws no uniform"):
        resample.advance(state, u=torch.rand(8, 8))     # t = 1: no redraw
    state = resample.advance(state)
    with pytest.raises(ValueError, match="injected uniform"):
        resample.advance(state, u=torch.rand(7, 8))
    with pytest.raises(ValueError, match="draws no uniform at init"):
        resample.init(u=torch.rand(8, 8), device="cpu")


# ---------------------------------------------------------------------------
# the scheduled NetES step against the reference's
# ---------------------------------------------------------------------------

N, STEPS = 15, 4
TASK = "landscape:rastrigin"
STEP_CASES = [
    ("resample_er(period=2,seed=3)", "erdos_renyi", 0.3, "dense"),
    ("resample_er(period=2,seed=3)", "erdos_renyi", 0.3, "sparse"),
    ("anneal_density(p_end=0.1,horizon=3,seed=1)", "erdos_renyi", 0.5,
     "dense"),
    ("anneal_density(p_end=0.1,horizon=3,seed=1)", "erdos_renyi", 0.5,
     "sparse"),
    ("rotate_circulant(stride=2)", "circulant_erdos_renyi", 0.4, "auto"),
]
CHANNELS = [None, "quantize(bits=8)|dropout(p=0.1,seed=0)"]
CFG = dict(alpha=0.05, sigma=0.1, p_broadcast=0.5)


def _reference_trajectory(text, family, p, rep, channel):
    """The reference stepped with its own ``scheduled_step``: before each
    step, everything the port needs to make the same step (the states,
    the draws, the dropout mask, the schedule's redraw, the raw rewards
    of both halves)."""
    ref_fn, dim, init_fn, _, _ = ref_envs.resolve_task(TASK)
    ref, port = _compile(text, family, N, p, rep)
    cfg = ref_netes.NetESConfig(**CFG)
    ch = None if channel is None else ref_cc.compile_channel(channel, N)
    state = ref_netes.init_state(jax.random.PRNGKey(0), N, dim,
                                 init_fn=init_fn)
    sstate, cstate = ref.init(), None if ch is None else ch.init(
        state.thetas)
    steps = []
    for _ in range(STEPS):
        eps, beta, _ = step_draws(state.key, N, dim)
        k_eval = jax.random.split(state.key, 4)[2]
        th = np.asarray(state.thetas)
        cands = np.concatenate([th + CFG["sigma"] * eps,
                                th - CFG["sigma"] * eps]).astype(np.float32)
        steps.append(dict(
            state=state, sstate=sstate, cstate=cstate, eps=eps, beta=beta,
            edge_mask=(None if ch is None else
                       reference_edge_mask(ch, cstate, sstate.topo)),
            u=_redraw_u(port, sstate), cands=cands,
            rewards=np.asarray(jax.jit(ref_fn)(jnp.asarray(cands), k_eval))))
        if ch is None:
            state, sstate, m = ref_netes.scheduled_step(
                state, sstate, ref_fn, cfg, ref)
        else:
            state, sstate, cstate, m = ref_netes.scheduled_step(
                state, sstate, ref_fn, cfg, ref, ch, cstate)
        steps[-1]["metrics"] = m
    return ref, port, ch, steps, (state, sstate, cstate)


def _port_draws(step):
    return Draws(eps=torch.as_tensor(step["eps"]),
                 beta=torch.as_tensor(step["beta"]), evals=None,
                 edge_mask=(None if step["edge_mask"] is None
                            else torch.tensor(step["edge_mask"])),
                 schedule_u=step["u"])


def _port_state(ref_state):
    return convert.state_from_reference(
        np.asarray(ref_state.thetas), np.asarray(ref_state.best_theta),
        np.asarray(ref_state.best_reward), np.asarray(ref_state.step),
        device="cpu")


def _slack(ch, step, topo, best_idx, broadcast):
    if ch is None:
        return 0.0
    cands = step["cands"]
    return one_level_slack(ch, topo.to_dense().numpy(), cands[:N],
                           cands[best_idx], broadcast,
                           CFG["alpha"] / (N * CFG["sigma"] ** 2))


def _assert_theta(got, want, slack, where):
    want = np.asarray(want, np.float64)
    err = np.abs(got.numpy() - want)
    bad = err > 2e-5 + 2e-5 * np.abs(want) + slack
    assert not bad.any(), (f"{where}: thetas differ at "
                           f"{np.argwhere(bad)[:5].tolist()} by {err[bad][:5]}")


@pytest.mark.parametrize("channel", CHANNELS)
@pytest.mark.parametrize("text,family,p,rep", STEP_CASES)
def test_scheduled_step_matches_reference(text, family, p, rep, channel):
    """Each step starts from the reference's NetES and channel states (a
    q8 code may differ by one level at a rounding boundary, see
    tests/test_torch_netes.py); the port's schedule state is its own from
    ``init`` on, and must equal the reference's at every step."""
    ref, port, ref_ch, steps, _ = _reference_trajectory(text, family, p, rep,
                                                        channel)
    reward_fn = envs.resolve_task(TASK)[0]
    cfg = NetESConfig(**CFG)
    ch = None if channel is None else port_cc.compile_channel(channel, N)
    sstate = port.init(u=_anneal_u(ref), device="cpu")
    for t, step in enumerate(steps):
        where = f"{text} {rep} {channel}, step {t}"
        _assert_same_graph(sstate.topo, step["sstate"].topo, where)
        cstate = None if ch is None else convert.channel_state_from_reference(
            None, np.asarray(step["cstate"].msgs), device="cpu")
        state, sstate, cstate, m = netes.scheduled_step(
            _port_state(step["state"]), sstate, reward_fn, cfg, port,
            _port_draws(step), channel=ch, chan_state=cstate)
        ref_m = step["metrics"]
        nxt = steps[t + 1]["state"] if t + 1 < len(steps) else None
        best = int(m["best_idx"])
        assert best == int(np.argmax(step["rewards"])), where
        assert float(m["broadcast"]) == float(ref_m["broadcast"]), where
        for k in ("reward_mean", "reward_max"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=1e-5, err_msg=where)
        if ch is not None:
            assert float(m["msgs"]) == float(ref_m["msgs"]), where
            assert float(m["drop_frac"]) == float(ref_m["drop_frac"]), where
        if nxt is not None:
            slack = _slack(ch, step, port_topology(step["sstate"].topo),
                           best, float(m["broadcast"]) > 0)
            _assert_theta(state.thetas, nxt.thetas, slack, where)
            np.testing.assert_allclose(state.best_theta.numpy(),
                                       np.asarray(nxt.best_theta),
                                       rtol=2e-5, atol=2e-5, err_msg=where)



@pytest.mark.parametrize("channel", CHANNELS)
@pytest.mark.parametrize("text,family,p,rep", STEP_CASES)
def test_run_scheduled_matches_reference(text, family, p, rep, channel):
    """``run_scheduled`` with the reference's draws against the reference's
    ``run_scheduled`` (one compiled scan) from the same start: the final
    state and graph, and per step the best agent, the broadcast and
    ``msgs``. It is the port's ``scheduled_step`` loop bit for bit. A q8
    code one level off at a boundary (slack, as in the step test) moves
    θ_j by at most that level, and each later step can scale a difference
    in θ by at most 1 + α/(Nσ²)·N (Eq. 3's self term)."""
    ref, port, ref_ch, steps, _ = _reference_trajectory(text, family, p, rep,
                                                        channel)
    ref_fn = ref_envs.resolve_task(TASK)[0]
    first = steps[0]
    out = ref_netes.run_scheduled(first["state"], first["sstate"], ref_fn,
                                  ref_netes.NetESConfig(**CFG), ref, STEPS,
                                  ref_ch, first["cstate"])
    ref_state, ref_sstate, ref_m = out[0], out[1], out[-1]

    reward_fn = envs.resolve_task(TASK)[0]
    cfg = NetESConfig(**CFG)
    ch = None if channel is None else port_cc.compile_channel(channel, N)
    draws = [_port_draws(s) for s in steps]
    runs = []
    for stepwise in (False, True):
        state = _port_state(first["state"])
        sstate = port.init(u=_anneal_u(ref), device="cpu")
        cstate = None if ch is None else ch.init(state.thetas)
        if stepwise:
            ms = []
            for d in draws:
                state, sstate, cstate, m = netes.scheduled_step(
                    state, sstate, reward_fn, cfg, port, d, channel=ch,
                    chan_state=cstate)
                ms.append(m)
            ms = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        else:
            state, sstate, cstate, ms = netes.run_scheduled(
                state, sstate, reward_fn, cfg, port, STEPS, channel=ch,
                chan_state=cstate, draws=draws)
        runs.append((state, sstate, cstate, ms))
    (state, sstate, cstate, ms), (state2, sstate2, _, ms2) = runs
    assert torch.equal(state.thetas, state2.thetas)
    assert sstate.t == sstate2.t == STEPS
    assert all(torch.equal(ms[k], ms2[k]) for k in ms)

    where = f"{text} {rep} {channel}"
    _assert_same_graph(sstate.topo, ref_sstate.topo, where)
    assert sstate.t == int(ref_sstate.t)
    np.testing.assert_array_equal(ms["broadcast"].numpy(),
                                  np.asarray(ref_m["broadcast"]))
    np.testing.assert_array_equal(
        ms["best_idx"].numpy(), [np.argmax(s["rewards"]) for s in steps])
    growth = 1.0 + CFG["alpha"] / (N * CFG["sigma"] ** 2) * N
    slack = 0.0
    for t, s in enumerate(steps):
        slack = slack * growth + _slack(
            ch, s, port_topology(s["sstate"].topo), int(ms["best_idx"][t]),
            float(ms["broadcast"][t]) > 0)
    if ch is not None:
        np.testing.assert_array_equal(ms["msgs"].numpy(),
                                      np.asarray(ref_m["msgs"]))
        assert float(cstate.msgs) == float(out[2].msgs)
    _assert_theta(state.thetas, ref_state.thetas, slack, where)
