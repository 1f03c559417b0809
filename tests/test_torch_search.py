"""``repro_torch.search`` (the topology search, DESIGN.md §10) against the
JAX reference (``repro.search``) and against the port's own independent
runs.

``repro.train.loop`` does not import on this jax (ROADMAP queue 3, item
a), so the reference is reached through ``repro.search.candidates`` and
``repro.search.tournament`` only.

Tolerances:

* the grid, the priors' order, the pool, the cohorts, the halving history,
  the survivors, the winner and the control scores EQUAL the reference's;
  the prior scores within 2 float32 ulps of each (the reference's
  ``prior_score`` in jnp, the port's in torch);
* a cohort round EQUALS S independent ``netes.run``/``run_scheduled``
  calls bit for bit (states, generators, schedule and channel states,
  scores), the candidates on the same widened topologies; against the
  unwidened ones θ within atol 1e-6 + rtol 1e-6 (a widened list sums
  zero-weight slots on the CPU, see tests/test_torch_topology_repr_stack.py);
* a round with the reference's draws injected (ε, β and the reward noise
  of every step, the schedule's redraws, the eval noise) against the
  reference's ``_round_static``/``_round_scheduled``: θ and best θ within
  atol 2e-5 + rtol 2e-5 as in tests/test_torch_netes.py (Eq. 3 adds ≤ 2N
  float32 terms in another order, over 3 iterations of a landscape whose
  gradient does not amplify it), best reward and score within rtol 1e-5.
"""
import dataclasses
import importlib.util
import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as ref_envs
from _torch_ref import step_draws
from repro.comm import channel as ref_channel
from repro.core import netes as ref_netes
from repro.core import topology as ref_topology
from repro.core import topology_repr as ref_repr
from repro.core import topology_sched as ref_sched
from repro.search import candidates as ref_cand
from repro.search import tournament as ref_tour
from repro_torch import convert, envs
from repro_torch.comm.channel import ChannelSpec
from repro_torch.core import netes, topology_repr
from repro_torch.core.netes import Draws, NetESConfig
from repro_torch.core.topology import TopologySpec
from repro_torch.core.topology_sched import ScheduleSpec
from repro_torch.launch import train as launch_train
from repro_torch.search import (CandidateSpec, SearchConfig, make_grid,
                                prior_scores, run_search, seed_pool)
from repro_torch.search import tournament
from repro_torch.train.loop import (TrainConfig, search_topology,
                                    train_rl_netes)

CFG = dict(alpha=0.05, sigma=0.1, p_broadcast=0.8)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _labels(cands):
    return [c.label() for c in cands]


def _cand(family, n, p=0.5, seed=0, sched=None, chan=None):
    return CandidateSpec(
        topo=TopologySpec(family=family, n_agents=n, p=p, seed=seed),
        sched=None if sched is None else ScheduleSpec.parse(sched),
        chan=None if chan is None else ChannelSpec.parse(chan))


def _ref_cand(cand):
    t = cand.topo
    return ref_cand.CandidateSpec(
        topo=ref_topology.TopologySpec(family=t.family, n_agents=t.n_agents,
                                       p=t.p, seed=t.seed),
        sched=(None if cand.sched is None else
               ref_sched.ScheduleSpec(**dataclasses.asdict(cand.sched))),
        chan=None if cand.chan is None else _ref_channel(cand.chan))


def _ref_channel(spec):
    return ref_channel.ChannelSpec(stages=tuple(
        ref_channel.StageSpec(**dataclasses.asdict(s)) for s in spec.stages))


# ---------------------------------------------------------------------------
# candidates: the grid, the priors, the pool
# ---------------------------------------------------------------------------

GRIDS = {
    "er-fc": dict(n_agents=64, families=("erdos_renyi", "fully_connected"),
                  densities=(0.05, 0.1, 0.3, 0.5), seeds=(0,)),
    "families": dict(n_agents=32, families=("erdos_renyi", "small_world",
                                            "scale_free", "fully_connected",
                                            "ring", "star", "disconnected"),
                     densities=(0.1, 0.2, 0.33), seeds=(0, 1)),
    "schedules": dict(n_agents=16, families=("erdos_renyi", "ring",
                                             "circulant_erdos_renyi",
                                             "fully_connected"),
                      densities=(0.1, 0.3), seeds=(0, 1),
                      schedules=(None, "static", "resample_er(period=2)",
                                 "rotate_circulant(stride=1)",
                                 "anneal_density(p_end=0.1,horizon=4)")),
    "channels": dict(n_agents=1000, families=("erdos_renyi",
                                              "fully_connected"),
                     densities=(0.05, 0.1, 0.5), seeds=(0,),
                     schedules=(None, "resample_er(period=2)"),
                     channels=(None, "lossless", "quantize(bits=8)",
                               "quantize(bits=4)|dropout(p=0.1,seed=0)")),
}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_grid_priors_and_pool_equal_the_reference(grid):
    kw = GRIDS[grid]
    got = make_grid(**kw)
    want = ref_cand.make_grid(**kw)
    assert _labels(got) == _labels(want)
    for c, r in zip(got, want, strict=True):
        assert c.scheduled == r.scheduled and c.channeled == r.channeled
        assert c.effective_p() == r.effective_p()
    ps, rs = prior_scores(got), ref_cand.prior_scores(want)
    np.testing.assert_allclose(ps, rs, rtol=2 * 2.0 ** -23, atol=0)
    for size in (1, 3, 5, len(got) - 1, len(got)):
        for keep in (("fully_connected",), ("fully_connected", "ring"), ()):
            assert _labels(seed_pool(got, size, keep)) == _labels(
                ref_cand.seed_pool(want, size, keep)), (size, keep)


def test_grid_controls_and_schedule_compat():
    labels = _labels(make_grid(16, ("erdos_renyi", "fully_connected",
                                    "ring"), densities=(0.1, 0.3),
                               seeds=(0, 1),
                               schedules=(None,
                                          "rotate_circulant(stride=1)")))
    assert labels.count("fully_connected") == 1
    assert "ring+rotate_circulant" in labels
    assert not any("erdos_renyi" in lb and "rotate" in lb for lb in labels)
    assert prior_scores([]).shape == (0,)


def test_stream_seeds_are_distinct_and_bounded():
    seeds = {tournament._stream_seed(b, c, r)
             for b in (0, 999) for c in range(50) for r in range(4)}
    assert len(seeds) == 2 * 50 * 4
    assert tournament._stream_seed(0, 5) != tournament._stream_seed(0, 5, 0)
    with pytest.raises(ValueError):
        tournament._stream_seed(0, 1 << 20)


# ---------------------------------------------------------------------------
# the cohort round against S independent runs of the port, bit for bit
# ---------------------------------------------------------------------------

COHORTS = {
    "static dense": ("landscape:rastrigin@2.5", "dense", [
        _cand("erdos_renyi", 12, 0.3, 0), _cand("erdos_renyi", 12, 0.5, 1),
        _cand("fully_connected", 12)]),
    "static sparse": ("landscape:rastrigin@2.5", "sparse", [
        _cand("erdos_renyi", 16, 0.15, 0), _cand("erdos_renyi", 16, 0.3, 1),
        _cand("erdos_renyi", 16, 0.2, 2)]),
    "scheduled": ("landscape:sphere", "sparse", [
        _cand("erdos_renyi", 12, 0.25, s,
              sched="resample_er(period=2,seed=3)") for s in (0, 1)]),
    "channel": ("landscape:rastrigin@2.5", "sparse", [
        _cand("erdos_renyi", 16, p, s,
              chan="quantize(bits=8)|dropout(p=0.2,seed=1)")
        for p, s in ((0.15, 0), (0.3, 1))]),
    "scheduled channel": ("landscape:sphere", "dense", [
        _cand("erdos_renyi", 12, 0.4, s,
              sched="anneal_density(p_end=0.1,horizon=3,seed=2)",
              chan="event_triggered(threshold=0.01)|quantize(bits=4)")
        for s in (0, 1)]),
    "pendulum": ("pendulum", "dense", [
        _cand("erdos_renyi", 6, 0.5, 0), _cand("fully_connected", 6)]),
}


def _fresh(task, plans, seed=0):
    """Each candidate's initial states, as ``run_search`` makes them."""
    _, dim, init_fn, _, _ = envs.resolve_task(task)
    n = (plans[0].topo or plans[0].schedule.init(device="cpu").topo).n
    states = [netes.init_state(n, dim, seed=tournament._stream_seed(seed, c),
                               init_fn=init_fn, device="cpu")
              for c in range(len(plans))]
    sstates = [None if p.schedule is None else p.schedule.init(device="cpu")
               for p in plans]
    cstates = [None if p.channel is None else p.channel.init(s.thetas)
               for p, s in zip(plans, states, strict=True)]
    gens = [torch.Generator().manual_seed(tournament._stream_seed(
        999, c, 0)) for c in range(len(plans))]
    return states, sstates, cstates, gens


def _assert_states_equal(a, b, where):
    for f in ("thetas", "step", "best_reward", "best_theta"):
        assert torch.equal(getattr(a, f), getattr(b, f)), (where, f)
    assert torch.equal(a.generator.get_state(), b.generator.get_state()), \
        where


@pytest.mark.parametrize("cohort", sorted(COHORTS))
def test_cohort_round_equals_independent_runs_bit_for_bit(cohort):
    task, rep, pool = COHORTS[cohort]
    iters, episodes = (2, 2) if task == "pendulum" else (4, 3)
    reward_fn = envs.resolve_task(task)[0]
    cfg = NetESConfig(**CFG)
    plans = tournament._make_plans(pool, rep, "cpu")
    assert len({p.cohort for p in plans}) == 1
    plan = plans[0]
    topos = (None if plan.schedule is not None else topology_repr.unstack(
        topology_repr.stack([p.topo for p in plans])))

    states, sstates, cstates, gens = _fresh(task, plans)
    got, got_ss, got_cs, scores = tournament._round(
        states, topos, reward_fn, cfg, iters, episodes, gens,
        channel=plan.channel,
        cstates=None if plan.channel is None else cstates,
        schedule=plan.schedule,
        sstates=None if plan.schedule is None else sstates)
    assert scores.shape == (len(pool),)

    states, sstates, cstates, gens = _fresh(task, plans)
    for i, p in enumerate(plans):
        where = f"{cohort}, candidate {i}"
        if p.schedule is None:
            st, cs, _ = netes.run(states[i], topos[i], reward_fn, cfg, iters,
                                  channel=p.channel, chan_state=cstates[i])
        else:
            st, ss, cs, _ = netes.run_scheduled(
                states[i], sstates[i], reward_fn, cfg, p.schedule, iters,
                channel=p.channel, chan_state=cstates[i])
            assert ss.t == got_ss[i].t == iters
            assert torch.equal(ss.topo.to_dense(), got_ss[i].topo.to_dense())
            for f in ("neighbor_idx", "neighbor_mask", "adj", "deg", "u"):
                a = getattr(ss.topo if f != "u" else ss, f)
                b = getattr(got_ss[i].topo if f != "u" else got_ss[i], f)
                assert (a is None) == (b is None) and (
                    a is None or torch.equal(a, b)), (where, f)
        _assert_states_equal(got[i], st, where)
        if p.channel is not None:
            for f in ("seed", "draws", "msgs", "last_sent"):
                a, b = getattr(got_cs[i], f), getattr(cs, f)
                assert (a is None) == (b is None) and (
                    a is None or torch.equal(a, b)), (where, f)
        score = tournament._eval_scores([st], reward_fn, episodes, [gens[i]])
        assert torch.equal(scores[i:i + 1], score), where
        if rep == "sparse" and p.schedule is None:
            # the same candidate on its own, unwidened list
            fresh = _fresh(task, plans)
            st2, _, _ = netes.run(fresh[0][i], p.topo, reward_fn, cfg, iters,
                                  channel=p.channel, chan_state=fresh[2][i])
            np.testing.assert_allclose(st2.thetas.numpy(),
                                       st.thetas.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=where)


def test_cohort_step_takes_injected_draws():
    """``_cohort_step`` with each candidate's own draws given equals it
    drawing them from the candidates' generators."""
    task, rep, pool = COHORTS["static sparse"]
    reward_fn, dim = envs.resolve_task(task)[:2]
    cfg = NetESConfig(**CFG)
    plans = tournament._make_plans(pool, rep, "cpu")
    topos = topology_repr.unstack(topology_repr.stack(
        [p.topo for p in plans]))
    a = tournament._cohort_step(_fresh(task, plans)[0], topos, reward_fn,
                                cfg)[0]
    states = _fresh(task, plans)[0]
    draws = [netes.draw(st, reward_fn, 16, dim) for st in states]
    b = tournament._cohort_step(states, topos, reward_fn, cfg,
                                draws=draws)[0]
    for x, y in zip(a, b, strict=True):
        _assert_states_equal(x, y, "injected draws")


# ---------------------------------------------------------------------------
# a round with the reference's draws, against the reference's round
# ---------------------------------------------------------------------------

NOISE = 0.5
REF_ROUNDS = {
    "static dense": ("dense", [(0.3, 0), (0.5, 1)], None),
    "static sparse": ("sparse", [(0.15, 0), (0.3, 1), (0.2, 2)], None),
    "scheduled": ("sparse", [(0.25, 0), (0.25, 1)],
                  "resample_er(period=2,seed=3)"),
}


def _reference_draws(key, n, dim, iters, schedule=None):
    """The port's ``Draws`` for each iteration of the reference's
    ``netes.run``/``run_scheduled`` from NetES key ``key``: ε, β and the
    reward noise from the step's key chain (``split(key, 4)``), and a
    scheduled run's redraws from the schedule's (``split(key)``, from
    ``PRNGKey(spec.seed)``)."""
    out = []
    skey = None if schedule is None else jax.random.PRNGKey(
        schedule.spec.seed)
    for t in range(iters):
        eps, beta, _ = step_draws(key, n, dim)
        k_eval = jax.random.split(key, 4)[2]
        noise = np.array(jax.random.normal(k_eval, (n,)))
        u = None
        if schedule is not None:
            skey, sub = jax.random.split(skey)
            if schedule.redraws(t + 1):
                u = torch.as_tensor(np.array(
                    jax.random.uniform(sub, (n, n))))
        out.append(Draws(eps=torch.as_tensor(eps),
                         beta=torch.as_tensor(beta),
                         evals=torch.as_tensor(noise), schedule_u=u))
        key = jax.random.split(key, 4)[0]
    return out


def _reference_eval_noise(ekey, episodes):
    return torch.as_tensor(np.stack([
        np.asarray(jax.random.normal(k, (1,)))[0]
        for k in jax.random.split(ekey, episodes)]))


@pytest.mark.parametrize("case", sorted(REF_ROUNDS))
def test_round_with_reference_draws_matches_the_reference(case):
    rep, graphs, sched = REF_ROUNDS[case]
    n, dim, iters, episodes = (16 if sched is None else 12), 64, 3, 2
    pool = [_cand("erdos_renyi", n, p, s, sched=sched) for p, s in graphs]
    ref_fn = ref_envs.make_landscape_reward_fn("sphere", NOISE)
    reward_fn = envs.make_landscape_reward_fn("sphere", NOISE)
    ref_plans = ref_tour._make_plans([_ref_cand(c) for c in pool], rep)
    plans = tournament._make_plans(pool, rep, "cpu")
    assert len({p.cohort for p in plans}) == 1
    keys = jax.random.split(jax.random.PRNGKey(7), len(pool))
    ekeys = jax.random.split(jax.random.PRNGKey(99), len(pool))
    ref_states = [ref_netes.init_state(k, n, dim) for k in keys]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *ref_states)
    ref_cfg = ref_netes.NetESConfig(**CFG)
    if sched is None:
        ref_out, ref_scores = ref_tour._round_static(
            stacked, ref_repr.stack([p.topo for p in ref_plans]),
            jnp.stack(ekeys), reward_fn=ref_fn, cfg=ref_cfg,
            num_iters=iters, eval_episodes=episodes)
    else:
        ref_ss = jax.tree.map(lambda *xs: jnp.stack(xs),
                              *[p.schedule.init() for p in ref_plans])
        ref_out, ref_ss, ref_scores = ref_tour._round_scheduled(
            stacked, ref_ss, jnp.stack(ekeys), reward_fn=ref_fn,
            cfg=ref_cfg, schedule=ref_plans[0].schedule, num_iters=iters,
            eval_episodes=episodes)

    states = [convert.state_from_reference(
        np.asarray(s.thetas), np.asarray(s.best_theta),
        np.asarray(s.best_reward), np.asarray(s.step), device="cpu")
        for s in ref_states]
    draws = [_reference_draws(s.key, n, dim, iters, plans[0].schedule)
             for s in ref_states]
    evals = [_reference_eval_noise(k, episodes) for k in ekeys]
    topos = (None if sched is not None else topology_repr.unstack(
        topology_repr.stack([p.topo for p in plans])))
    got, got_ss, _, scores = tournament._round(
        states, topos, reward_fn, NetESConfig(**CFG), iters, episodes,
        schedule=plans[0].schedule,
        sstates=(None if sched is None else
                 [p.schedule.init(device="cpu") for p in plans]),
        draws=draws, eval_evals=evals)

    for i, st in enumerate(got):
        where = f"{case}, candidate {i}"
        want = jax.tree.map(lambda x: np.asarray(x[i]), ref_out)
        for f in ("thetas", "best_theta"):
            w = getattr(want, f)
            np.testing.assert_allclose(getattr(st, f).numpy(), w,
                                       rtol=2e-5, atol=2e-5,
                                       err_msg=f"{where}: {f}")
        np.testing.assert_allclose(float(st.best_reward),
                                   float(want.best_reward), rtol=1e-5,
                                   err_msg=where)
        assert int(st.step) == int(want.step) == iters
        np.testing.assert_allclose(float(scores[i]), float(ref_scores[i]),
                                   rtol=1e-5, err_msg=where)
        if sched is not None:
            np.testing.assert_array_equal(
                got_ss[i].topo.to_dense().numpy(),
                np.asarray(ref_repr.unstack(ref_ss.topo)[i].to_dense()))


# ---------------------------------------------------------------------------
# successive halving against the reference's, on fixed scores
# ---------------------------------------------------------------------------

def _fixed_scores(pool_labels):
    """A ``_run_round`` stand-in for both packages: round r scores each
    alive candidate from its label and r, with ties and a −inf."""
    rounds = []

    def fake(alive, plans, *args, **kwargs):
        rnd = len(rounds)
        rounds.append(list(alive))
        out = {}
        for c in alive:
            h = sum(map(ord, pool_labels[c])) * (rnd + 3) % 5
            out[c] = -np.inf if h == 4 else float(h // 2)
        return out

    return fake, rounds


POOLS = {
    1: dict(families=("erdos_renyi",), densities=(0.2,), pool_size=1),
    3: dict(pool_size=3),
    4: dict(pool_size=4),
    7: dict(pool_size=7),
}


@pytest.mark.parametrize("widen", [True, False])
@pytest.mark.parametrize("size", sorted(POOLS))
def test_halving_equals_the_reference_on_fixed_scores(size, widen,
                                                      monkeypatch):
    kw = dict(n_agents=16, families=("erdos_renyi", "fully_connected"),
              densities=(0.05, 0.1, 0.2, 0.3, 0.5, 0.7), seeds=(0,),
              round_iters=3, widen=widen)
    kw.update(POOLS[size])
    task = "landscape:sphere"
    ref_sc = ref_tour.SearchConfig(**kw)
    sc = SearchConfig(**kw)
    labels = _labels(ref_cand.seed_pool(
        ref_cand.make_grid(16, kw["families"], kw["densities"], (0,)),
        kw["pool_size"]))
    ref_fake, ref_rounds = _fixed_scores(labels)
    fake, rounds = _fixed_scores(labels)
    monkeypatch.setattr(ref_tour, "_run_round", ref_fake)
    monkeypatch.setattr(tournament, "_run_round", fake)
    want = ref_tour.run_search(task, ref_sc)
    got = run_search(task, sc, device="cpu")
    assert len(got.pool) == size
    assert _labels(got.pool) == _labels(want.pool) == labels
    assert rounds == ref_rounds
    assert got.history == want.history
    assert got.winner.label() == want.winner.label()
    assert got.score == want.score
    assert got.control_scores == want.control_scores
    assert len(got.history) == max(1, int(np.ceil(np.log2(size))))


# ---------------------------------------------------------------------------
# the tournament: determinism, resume, integration
# ---------------------------------------------------------------------------

_SC = SearchConfig(
    n_agents=12, families=("erdos_renyi", "fully_connected"),
    densities=(0.1, 0.4), seeds=(0,), pool_size=4, round_iters=3,
    eval_episodes=1, seed=0, netes=NetESConfig(**CFG))
_TASK = "landscape:rastrigin@2.5"


def test_successive_halving_is_deterministic_and_shrinks():
    r1 = run_search(_TASK, _SC, device="cpu")
    r2 = run_search(_TASK, _SC, device="cpu")
    assert r1.history == r2.history
    assert r1.winner == r2.winner and r1.score == r2.score
    sizes = [len(h["scores"]) for h in r1.history]
    assert sizes == sorted(sizes, reverse=True)
    assert len(r1.history[-1]["survivors"]) == 1
    iters = [h["iters"] for h in r1.history]
    assert all(b == 2 * a for a, b in zip(iters, iters[1:], strict=False))
    assert r1.winner in r1.pool
    assert "fully_connected" in r1.control_scores
    js = json.loads(json.dumps(r1.to_json()))
    assert js["winner"] == r1.winner.label() and js["n_agents"] == 12
    assert js["pool"] == _labels(r1.pool)


RESUME_CASES = {
    "static": {},
    "schedules and channels": dict(
        families=("erdos_renyi",), densities=(0.3,), seeds=(0, 1),
        schedules=(None, "resample_er(period=2)"),
        channels=("quantize(bits=8)|dropout(p=0.1,seed=0)",)),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_equals_the_uninterrupted_run(tmp_path, case):
    sc = dataclasses.replace(_SC, checkpoint_dir=str(tmp_path / "full"),
                             **RESUME_CASES[case])
    full = run_search(_TASK, sc, device="cpu")
    assert len(full.history) == 2
    resume_dir = tmp_path / "resume"
    shutil.copytree(tmp_path / "full", resume_dir)
    meta0 = json.loads((resume_dir / "step_00000000.json").read_text())
    (resume_dir / "latest.json").write_text(json.dumps(meta0))
    resumed = run_search(_TASK, dataclasses.replace(
        sc, checkpoint_dir=str(resume_dir)), device="cpu")
    assert resumed.history == full.history
    assert resumed.winner == full.winner and resumed.score == full.score
    assert resumed.control_scores == full.control_scores


def test_resume_rejects_another_search(tmp_path):
    sc = dataclasses.replace(_SC, checkpoint_dir=str(tmp_path))
    run_search(_TASK, sc, device="cpu")
    with pytest.raises(ValueError, match="different search"):
        run_search("landscape:sphere", sc, device="cpu")
    with pytest.raises(ValueError, match="different search"):
        run_search(_TASK, dataclasses.replace(sc, round_iters=8),
                   device="cpu")


def test_unbatchable_candidates_and_empty_pools_raise():
    with pytest.raises(ValueError, match="tournaments batch dense or sparse"):
        run_search(_TASK, dataclasses.replace(_SC,
                                              representation="circulant"),
                   device="cpu")
    with pytest.raises(ValueError, match="empty candidate pool"):
        run_search(_TASK, dataclasses.replace(_SC, families=()),
                   device="cpu")


def test_search_topology_and_from_search_result():
    spec = search_topology(_TASK, _SC, device="cpu")
    assert isinstance(spec, TopologySpec)
    result = run_search(_TASK, _SC, device="cpu")
    assert spec == result.topology
    tc = TrainConfig.from_search_result(result, iters=3, seed=1,
                                        eval_every=3)
    assert tc.topology == result.topology and tc.n_agents == 12
    assert tc.iters == 3 and tc.seed == 1
    assert tc.schedule is None and tc.channel is None
    hist = train_rl_netes(_TASK, tc, device="cpu")
    assert np.isfinite(hist["final_eval"])


def test_from_search_result_carries_a_schedule_and_a_channel():
    result = tournament.SearchResult(
        winner=_cand("erdos_renyi", 12, 0.3, 1, sched="resample_er(period=4)",
                     chan="quantize(bits=8)"),
        score=0.0, control_scores={}, pool=[], history=[], wall_s=0.0,
        n_agents=12)
    tc = TrainConfig.from_search_result(result, iters=5)
    assert tc.schedule == ScheduleSpec(kind="resample_er", period=4)
    assert tc.channel == ChannelSpec.parse("quantize(bits=8)")
    assert tc.topo_seed == 1 and tc.density == 0.3 and tc.iters == 5


def test_search_raises_on_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_search(_TASK, _SC)


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------

LAUNCH_ERRORS = {
    "circulant": (["--representation", "circulant"], "incompatible"),
    "schedule": (["--schedule", "resample_er(period=2)"], "--schedule"),
    "channel": (["--channel", "quantize(bits=8)"], "--channel"),
}


@pytest.mark.parametrize("case", sorted(LAUNCH_ERRORS))
def test_launcher_rejects_what_conflicts_with_search(case, capsys):
    extra, msg = LAUNCH_ERRORS[case]
    with pytest.raises(SystemExit) as exc:
        launch_train.main(["rl", "--device", "cpu", "--search", *extra])
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err


def test_launcher_searches_and_trains_on_cpu(tmp_path, capsys):
    out = tmp_path / "run.json"
    launch_train.main([
        "rl", "--task", "landscape:sphere", "--device", "cpu", "--agents",
        "12", "--iters", "2", "--search", "--search-densities", "0.1,0.4",
        "--search-seeds", "0", "--search-pool", "3", "--search-iters", "2",
        "--search-eval-episodes", "1", "--search-schedules",
        "static,resample_er(period=2)", "--search-channels",
        "lossless;quantize(bits=8)", "--search-checkpoint-dir",
        str(tmp_path / "ck"), "--out", str(out)])
    text = capsys.readouterr().out
    lines = text.splitlines()
    rounds = [json.loads(ln) for ln in lines if ln.startswith('{"round"')]
    assert [r["round"] for r in rounds] == [0, 1]
    winner = next(ln for ln in lines if ln.startswith("search winner: "))
    payload = json.loads(out.read_text())
    assert payload["search"]["winner"] in winner
    assert payload["search"]["history"] == rounds
    assert len(payload["search"]["pool"]) == 3
    assert "final eval:" in text
    assert (tmp_path / "ck" / "latest.json").exists()


def test_quickstart_runs_on_cpu(capsys):
    path = ROOT / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--agents", "12", "--dim", "8",
              "--iters", "3", "--search-iters", "2"])
    text = capsys.readouterr().out
    assert "search winner:" in text and "trained on the winner" in text
    assert text.count("repr=") == 4
