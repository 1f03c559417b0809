"""The port's telemetry (``repro_torch.obs``, DESIGN.md §15), mirroring
tests/test_obs.py, and held against the reference's ``repro.obs``.

* A probed run's trajectory equals the unprobed run's BIT FOR BIT over
  {dense, sparse, circulant} × {fixed, scheduled} × {no channel,
  q8|dropout}, and so do its metrics (the port runs eagerly: a probe adds
  no consumer that could change a fusion); probes consume no generator
  state.
* Ring mechanics: wraparound keeps the last ``capacity`` samples, a drain
  is one counted transfer, a checkpoint resume reproduces the series.
* The drained series against the reference's ``netes.run(...,
  probes=…)`` with the reference's draws injected, on landscape:sphere
  and pendulum (D = 4481): ``fitness`` within the returns tolerance of
  ``_torch_ref.assert_returns_close`` (rtol 1e-5 + six times the
  reference's one-ulp rounding spread), ``consensus`` within 1e-5
  relative (plus 1e-9 absolute: see the test), ``graph`` and ``wire``
  EXACT but ``reach_proxy`` within 2 float32 ulps.
* Trace schema and counters, ``Trace(None)`` a no-op, ``validate_trace``
  catching each kind of violation, the CLI in a subprocess, and traces
  that validate in both packages.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import repro.envs as ref_envs
from _torch_ref import (assert_returns_close, port_topology,
                        reference_edge_mask, rounding_spread, step_draws,
                        to_draws)
from repro.comm import channel as ref_cc
from repro.core import netes as ref_netes
from repro.core import topology as ref_topology
from repro.core import topology_repr as ref_repr
from repro.obs import probes as ref_probes
from repro.obs import trace as ref_trace
from repro.obs import xla_watch as ref_xla_watch
from repro_torch import checkpoint, convert, envs
from repro_torch.comm.channel import compile_channel
from repro_torch.core import netes, topology, topology_repr, topology_sched
from repro_torch.core.netes import NetESConfig
from repro_torch.core.topology import TopologySpec
from repro_torch.obs import (SCHEMA, MetricsState, ProbeSpec, Trace,
                             compile_probes, count_host_transfers,
                             count_kernel_builds, cuda_watch, summarize,
                             validate_trace)
from repro_torch.train import loop

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
# N odd: rotate_circulant needs every offset of the circulant-ER base
# within [1, (N-1)//2], which N = 13 guarantees
N, ITERS = 13, 6
CFG = NetESConfig(alpha=0.05, sigma=0.1, p_broadcast=0.5)
TASK = "landscape:sphere"
Q8_DROP = "quantize(bits=8)|dropout(p=0.1,seed=0)"


def _reward():
    reward_fn, dim, init_fn, _, _ = envs.resolve_task(TASK)
    return reward_fn, dim, init_fn


def _state(seed=0):
    _, dim, init_fn = _reward()
    return netes.init_state(N, dim, seed=seed, init_fn=init_fn,
                            device="cpu")


def _topo(rep):
    if rep == "circulant":
        return topology_repr.from_dense(
            topology.circulant_from_offsets(N, [1, 3]), "circulant",
            device="cpu")
    return topology_repr.from_dense(topology.erdos_renyi(N, p=0.4, seed=1),
                                    rep, device="cpu")


def _schedule(rep):
    if rep == "circulant":
        spec = topology_sched.ScheduleSpec(kind="rotate_circulant",
                                           stride=1)
        base = TopologySpec(family="circulant_erdos_renyi", n_agents=N,
                            p=0.4, seed=1)
    else:
        spec = topology_sched.ScheduleSpec(kind="resample_er", period=2)
        base = TopologySpec(family="erdos_renyi", n_agents=N, p=0.4, seed=1)
    return topology_sched.compile_schedule(spec, base, representation=rep)


def _assert_equal(a, b, where):
    """Every tensor, generator state and host value of two state trees
    equal."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, torch.Generator):
        assert torch.equal(a.get_state(), b.get_state()), where
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_equal(getattr(a, f.name), getattr(b, f.name),
                          f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}[{k}]")
    else:
        assert a == b, where


# ---------------------------------------------------------------------------
# spec / compile basics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", ["fitness|graph", "all", " consensus ",
                                  "fitness|bogus", "fitness|fitness", "",
                                  "wire|fitness|graph"])
def test_spec_parse_matches_reference(text):
    def outcome(parse):
        try:
            return parse(text).stages
        except ValueError as e:
            return type(e), str(e).split(" (")[0].split("(have")[0]
    assert outcome(ProbeSpec.parse) == outcome(ref_probes.ProbeSpec.parse)


def test_spec_errors():
    assert set(ProbeSpec.parse("all").stages) == {"fitness", "consensus",
                                                  "wire", "graph"}
    with pytest.raises(ValueError, match="unknown probe stage"):
        ProbeSpec.parse("fitness|bogus")
    with pytest.raises(ValueError, match="duplicate"):
        ProbeSpec(stages=("fitness", "fitness"))
    with pytest.raises(ValueError, match="at least one"):
        ProbeSpec(stages=())
    with pytest.raises(ValueError, match="capacity"):
        compile_probes("fitness", capacity=0)
    assert compile_probes(None) is None


def test_wire_stage_requires_channel():
    with pytest.raises(ValueError, match="needs a channel"):
        compile_probes("wire")
    chan = compile_channel("quantize(bits=8)", N)
    p = compile_probes("wire", channel=chan, dim=64)
    ref = ref_probes.compile_probes(
        "wire", channel=ref_cc.compile_channel("quantize(bits=8)", N),
        dim=64)
    assert p.msg_bytes == ref.msg_bytes == float(chan.payload_bytes(64))
    assert p.signals == ref.signals
    assert compile_probes("all", capacity=7, channel=chan,
                          dim=64).label() == ref_probes.compile_probes(
        "all", capacity=7, channel=ref_cc.compile_channel(
            "quantize(bits=8)", N), dim=64).label()


def test_probes_hashable():
    p1 = compile_probes("fitness", capacity=8)
    p2 = compile_probes("fitness", capacity=8)
    assert hash(p1) == hash(p2) and p1 == p2


def test_stage_without_its_input_raises_naming_it():
    p = compile_probes("fitness|graph", capacity=4)
    ms = p.init("cpu")
    metrics = {"reward_mean": torch.zeros(()), "reward_max": torch.zeros(()),
               "reward_std": torch.zeros(())}
    with pytest.raises(ValueError, match="'graph' needs the live topology"):
        p.record(ms, metrics)
    chan = compile_channel("quantize(bits=8)", N)
    pw = compile_probes("wire", capacity=4, channel=chan, dim=8)
    with pytest.raises(KeyError, match="'wire' needs metric 'msgs'"):
        pw.record(pw.init("cpu"), metrics)


def test_metrics_state_dtypes_and_device():
    ms = compile_probes("fitness|graph", capacity=4).init("cpu")
    assert isinstance(ms, MetricsState)
    assert ms.buf.dtype == torch.float32 and ms.buf.shape == (7, 4)
    assert ms.cursor.dtype == torch.int32 and ms.cursor.dim() == 0
    assert ms.buf.device.type == "cpu"


# ---------------------------------------------------------------------------
# THE invariant: probed ≡ unprobed, bit for bit
# ---------------------------------------------------------------------------

def _run(rep, scheduled, chan_text, probes=None):
    reward_fn, dim, _ = _reward()
    st = _state()
    chan = compile_channel(chan_text, N) if chan_text else None
    kw = {}
    if chan is not None:
        kw.update(channel=chan, chan_state=chan.init(st.thetas))
    if probes is not None:
        kw.update(probes=probes, metrics_state=probes.init("cpu"))
    if scheduled:
        sched = _schedule(rep)
        out = netes.run_scheduled(st, sched.init(device="cpu"), reward_fn,
                                  CFG, sched, ITERS, **kw)
    else:
        out = netes.run(st, _topo(rep), reward_fn, CFG, ITERS, **kw)
    out = list(out)
    m = out.pop()
    ms = out.pop() if probes is not None else None
    return out, m, ms


@pytest.mark.parametrize("rep", ["dense", "sparse", "circulant"])
@pytest.mark.parametrize("scheduled", [False, True])
@pytest.mark.parametrize("chan_text", [None, Q8_DROP])
def test_probed_run_equals_unprobed_bit_for_bit(rep, scheduled, chan_text):
    chan = compile_channel(chan_text, N) if chan_text else None
    stages = "fitness|consensus|graph" + ("|wire" if chan else "")
    probes = compile_probes(stages, capacity=ITERS, channel=chan,
                            dim=_reward()[1])
    plain, m_plain, _ = _run(rep, scheduled, chan_text)
    probed, m_probed, ms = _run(rep, scheduled, chan_text, probes)
    where = (rep, scheduled, chan_text)
    assert len(plain) == len(probed)
    for a, b in zip(plain, probed):
        _assert_equal(a, b, where)
    _assert_equal(m_plain, m_probed, where)
    # the recorded series IS the metrics series, not a recompute
    series = probes.drain(ms)
    assert series["cursor"] == ITERS and series["dropped"] == 0
    np.testing.assert_array_equal(series["fitness_mean"],
                                  m_probed["reward_mean"].numpy())
    np.testing.assert_array_equal(series["consensus_dist"],
                                  m_probed["theta_spread"].numpy())
    if chan is not None:
        np.testing.assert_array_equal(series["msgs"],
                                      m_probed["msgs"].numpy())
        np.testing.assert_array_equal(
            series["wire_bytes"],
            series["msgs"] * np.float32(probes.msg_bytes))
        np.testing.assert_array_equal(series["drop_frac"],
                                      m_probed["drop_frac"].numpy())


def test_graph_stage_reads_the_topology_in_force():
    """Under a resampling schedule the graph series changes where the
    graph does, and each sample is the pre-advance graph's."""
    reward_fn, _, _ = _reward()
    sched = _schedule("sparse")
    probes = compile_probes("graph", capacity=ITERS)
    ss = sched.init(device="cpu")
    want = []
    st, ms = _state(), probes.init("cpu")
    for _ in range(ITERS):
        want.append(float(topology_sched.graph_signals(ss.topo)["density"]))
        st, ss, _, ms, _ = netes.scheduled_step(
            st, ss, reward_fn, CFG, sched, probes=probes, metrics_state=ms)
    got = probes.drain(ms)["density"]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    assert got[0] == got[1] and got[1] != got[2]


def test_probes_consume_no_generator_state():
    reward_fn, _, _ = _reward()
    p = compile_probes("fitness|consensus|graph", capacity=ITERS)
    a, _, _ = netes.run(_state(), _topo("dense"), reward_fn, CFG, ITERS)
    b, _, _, _ = netes.run(_state(), _topo("dense"), reward_fn, CFG, ITERS,
                           probes=p, metrics_state=p.init("cpu"))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_probes_without_their_ring_raise():
    reward_fn, _, _ = _reward()
    with pytest.raises(ValueError, match="metrics_state"):
        netes.netes_step(_state(), _topo("dense"), reward_fn, CFG,
                         probes=compile_probes("fitness"))


# ---------------------------------------------------------------------------
# ring mechanics
# ---------------------------------------------------------------------------

def test_ring_wraparound_keeps_last_capacity_samples():
    cap, iters = 4, 10
    reward_fn, _, _ = _reward()
    p = compile_probes("fitness", capacity=cap)
    _, _, ms, m = netes.run(_state(), _topo("dense"), reward_fn, CFG, iters,
                            probes=p, metrics_state=p.init("cpu"))
    series = p.drain(ms)
    assert series["cursor"] == iters
    assert series["dropped"] == iters - cap
    np.testing.assert_array_equal(series["fitness_mean"],
                                  m["reward_mean"].numpy()[-cap:])
    np.testing.assert_array_equal(series["fitness_best"],
                                  m["reward_max"].numpy()[-cap:])


@pytest.mark.parametrize("scheduled", [False, True])
def test_probed_step_updates_its_ring_in_place(scheduled):
    """The ring the step returns is the one passed in, one column on; and
    ``step_parts`` gives the unprobed step's parts of a probed return."""
    reward_fn, _, _ = _reward()
    p = compile_probes("fitness|graph", capacity=4)
    ms = p.init("cpu")
    if scheduled:
        sched = _schedule("sparse")
        args = (_state(), sched.init(device="cpu"), reward_fn, CFG, sched)
        step = netes.scheduled_step
    else:
        args = (_state(), _topo("sparse"), reward_fn, CFG)
        step = netes.netes_step
    out = step(*args, probes=p, metrics_state=ms)
    plain = step(*(
        (_state(), sched.init(device="cpu")) + args[2:] if scheduled
        else (_state(),) + args[1:]))
    assert out[-2] is ms and int(ms.cursor) == 1
    parts = netes.step_parts(out, scheduled=scheduled)
    assert len(parts) == len(plain)
    for a, b in zip(parts, plain):
        if isinstance(a, netes.NetESState):
            assert torch.equal(a.thetas, b.thetas)
        elif isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in b)


def test_drain_is_one_host_transfer():
    reward_fn, _, _ = _reward()
    p = compile_probes("fitness|graph", capacity=8)
    _, _, ms, _ = netes.run(_state(), _topo("sparse"), reward_fn, CFG, 3,
                            probes=p, metrics_state=p.init("cpu"))
    with count_host_transfers() as transfers:
        p.drain(ms)
    assert len(transfers) == 1


def test_device_get_returns_the_bits_in_one_transfer():
    parts = (torch.arange(5, dtype=torch.float32) / 3,
             torch.tensor(7, dtype=torch.int32), torch.tensor([True, False]),
             torch.arange(6, dtype=torch.float64).reshape(2, 3)[:, ::2])
    with count_host_transfers() as outer, count_host_transfers() as inner:
        got = cuda_watch.device_get(parts)
        single = cuda_watch.device_get(parts[0])
    assert len(outer) == len(inner) == 2
    for a, b in zip(got, parts):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(single, parts[0])
    with count_kernel_builds() as builds:
        cuda_watch.report_build("nvcc x")
    assert builds == ["nvcc x"]


def test_checkpoint_resume_reproduces_probe_series(tmp_path):
    kw = dict(n_agents=8, iters=12, seed=5, probes="fitness|consensus|graph",
              eval_every=4, representation="sparse",
              schedule="resample_er(period=3)")
    full = loop.train_rl_netes(TASK, loop.TrainConfig(**kw), device="cpu")
    ck = str(tmp_path / "ck")
    loop.train_rl_netes(TASK, loop.TrainConfig(checkpoint_dir=ck,
                                               **{**kw, "iters": 8}),
                        device="cpu")
    res = loop.train_rl_netes(TASK, loop.TrainConfig(checkpoint_dir=ck, **kw),
                              device="cpu")
    assert res["probes"]["cursor"] == full["probes"]["cursor"] == 12
    assert len(res["reward_mean"]) == 4
    for k in ("fitness_mean", "fitness_best", "consensus_dist",
              "update_var", "density", "reach_proxy"):
        np.testing.assert_array_equal(full["probes"][k], res["probes"][k],
                                      err_msg=k)
    np.testing.assert_array_equal(
        full["probes"]["fitness_mean"],
        np.asarray(full["reward_mean"], np.float32))


# ---------------------------------------------------------------------------
# the drained series against the reference's
# ---------------------------------------------------------------------------

def _reference_series(task, stages, chan_text, n, iters):
    """The reference's ``netes.run(..., probes=…)`` drained series, and the
    draws it made (its key chains replayed: ``netes_step`` keeps the first
    of four splits, a dropout stage the first of two)."""
    ref_fn, dim, init_fn, env, _ = ref_envs.resolve_task(task)
    cfg = ref_netes.NetESConfig(alpha=0.05, sigma=0.1, p_broadcast=0.5)
    ref_topo = ref_repr.from_spec(ref_topology.TopologySpec(
        family="erdos_renyi", n_agents=n, p=0.3, seed=1), "sparse")
    state = ref_netes.init_state(jax.random.PRNGKey(0), n, dim,
                                 init_fn=init_fn)
    ch = ref_cc.compile_channel(chan_text, n) if chan_text else None
    rp = ref_probes.compile_probes(stages, capacity=iters, channel=ch,
                                   dim=dim)
    kw = {"probes": rp, "metrics_state": rp.init()}
    if ch is not None:
        kw.update(channel=ch, chan_state=ch.init(state.thetas))
    out = ref_netes.run(state, ref_topo, ref_fn, cfg, iters, **kw)
    series = rp.drain(out[-2])
    draws, key = [], state.key
    ckey = None if ch is None else ch.init(state.thetas).key
    for _ in range(iters):
        mask = (None if ch is None else reference_edge_mask(
            ch, types.SimpleNamespace(key=ckey), ref_topo))
        draws.append((key, to_draws(*step_draws(key, n, dim, env),
                                    edge_mask=mask)))
        key = jax.random.split(key, 4)[0]
        if ch is not None:
            ckey = jax.random.split(ckey)[0]
    return series, state, ref_topo, draws, ref_fn


@pytest.mark.parametrize("task,n,iters", [("landscape:sphere", 13, 5),
                                          ("pendulum", 16, 3)])
@pytest.mark.parametrize("chan_text", [None, "dropout(p=0.2,seed=0)"])
def test_series_match_reference(task, n, iters, chan_text):
    stages = "fitness|consensus|graph" + ("|wire" if chan_text else "")
    want, ref_state, ref_topo, draws, ref_fn = _reference_series(
        task, stages, chan_text, n, iters)
    reward_fn, dim, _, _, _ = envs.resolve_task(task)
    ch = compile_channel(chan_text, n) if chan_text else None
    probes = compile_probes(stages, capacity=iters, channel=ch, dim=dim)
    topo = port_topology(ref_topo)
    st = convert.state_from_reference(
        np.asarray(ref_state.thetas), np.asarray(ref_state.best_theta),
        np.asarray(ref_state.best_reward), np.asarray(ref_state.step),
        device="cpu")
    cs = None if ch is None else ch.init(st.thetas)
    ms = probes.init("cpu")
    spreads = []
    for key, d in draws:
        k_eval = jax.random.split(key, 4)[2]
        th = st.thetas.numpy()
        eps = d.eps.numpy()
        for sign in (1, -1):
            spreads.append(rounding_spread(
                ref_fn, (th + sign * CFG.sigma * eps).astype(np.float32),
                k_eval, samples=4).max())
        st, cs, ms, _ = netes.netes_step(st, topo, reward_fn, CFG, d,
                                         channel=ch, chan_state=cs,
                                         probes=probes, metrics_state=ms)
    got = probes.drain(ms)
    assert got.keys() == want.keys()
    assert got["cursor"] == want["cursor"] == iters
    spread = np.full(iters, max(spreads))
    for k in ("fitness_mean", "fitness_best", "fitness_std"):
        assert_returns_close(got[k], want[k], spread)
    # after a broadcast every row holds one θ: the port's variance is 0,
    # the reference's float32 mean-then-deviation leaves D·(u·|θ|)² of
    # rounding (≈ 1e-12 here), so an atol of 1e-9 sits beside the rtol
    for k in ("consensus_dist", "update_var"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-9,
                                   err_msg=k)
    for k in ("density", "deg_min", "deg_max") + (
            ("msgs", "wire_bytes", "trigger_frac", "drop_frac")
            if chan_text else ()):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    room = 2 * np.spacing(np.abs(np.asarray(want["reach_proxy"])))
    assert (np.abs(got["reach_proxy"] - want["reach_proxy"]) <= room).all()


# ---------------------------------------------------------------------------
# trace layer: schema, counters, no-op writer, CLI, cross-validation
# ---------------------------------------------------------------------------

def test_trace_schema_and_counters(tmp_path):
    path = tmp_path / "t.jsonl"
    with Trace(path, name="unit", device="cpu", extra_key=1) as tr:
        with tr.span("build"):
            cuda_watch.report_build("load x.so")
        with tr.span("outer"):
            with tr.span("drain"):
                cuda_watch.device_get(torch.ones(3))
        tr.event("eval", score=1.5)
    assert validate_trace(path) == []
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    meta = recs[0]
    assert meta["kind"] == "meta" and meta["schema"] == SCHEMA == \
        ref_trace.SCHEMA
    assert meta["backend"] == "cpu" and meta["devices"] == 1
    assert meta["torch"] == torch.__version__ and meta["extra_key"] == 1
    assert "jax" not in meta and "device_name" in meta and "cuda" in meta
    by_name = {r["name"]: r for r in recs[1:]}
    assert by_name["build"]["compiles"] == 1
    assert by_name["build"]["transfers"] == 0
    assert by_name["drain"]["transfers"] == 1
    assert by_name["drain"]["depth"] == 1 and by_name["outer"]["depth"] == 0
    assert by_name["outer"]["transfers"] == 1
    assert by_name["eval"]["attrs"]["score"] == 1.5
    out = summarize(path)
    assert "build" in out and "drain" in out and "1 event(s)" in out


def test_trace_none_is_noop(tmp_path):
    tr = Trace(None)
    assert not tr.active
    with tr.span("anything"):
        pass
    tr.event("x")
    tr.close()
    assert list(tmp_path.iterdir()) == []


META = {"kind": "meta", "schema": SCHEMA, "name": "x"}
SPAN = {"kind": "span", "name": "s", "t0": 0.0, "dur_s": 0.1, "depth": 0,
        "compiles": 0, "transfers": 0}
VIOLATIONS = [
    ("not JSON", None, "not JSON"),
    ("empty", [], "empty trace"),
    ("no meta first", [SPAN], "first record must be kind=meta"),
    ("wrong schema", [{**META, "schema": "repro.trace/v0"}], "schema"),
    ("meta without name", [{"kind": "meta", "schema": SCHEMA}],
     "meta missing key 'name'"),
    ("duplicate meta", [META, META], "duplicate meta"),
    ("unknown kind", [META, {"kind": "blob"}], "unknown kind"),
    ("span without key", [META, {k: v for k, v in SPAN.items()
                                 if k != "transfers"}],
     "span missing key 'transfers'"),
    ("event without t", [META, {"kind": "event", "name": "e"}],
     "event missing key 't'"),
    ("t0 not a number", [META, {**SPAN, "t0": "0"}], "t0 must be a number"),
    ("negative compiles", [META, {**SPAN, "compiles": -1}], "non-negative"),
    ("float depth", [META, {**SPAN, "depth": 0.5}], "non-negative"),
]


@pytest.mark.parametrize("label,records,message", VIOLATIONS,
                         ids=[v[0] for v in VIOLATIONS])
def test_validate_trace_catches_each_violation(tmp_path, label, records,
                                               message):
    bad = tmp_path / "bad.jsonl"
    bad.write_text("{not json\n" if records is None else
                   "".join(json.dumps(r) + "\n" for r in records))
    errs = validate_trace(bad)
    assert any(message in e for e in errs), errs
    assert errs == ref_trace.validate_trace(bad)


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC))


def test_train_trace_end_to_end_and_cli(tmp_path):
    path = tmp_path / "run.jsonl"
    hist = loop.train_rl_netes(
        TASK, loop.TrainConfig(n_agents=8, iters=6, seed=0, probes="all",
                               channel="quantize(bits=8)", eval_every=3,
                               trace=str(path)), device="cpu")
    assert validate_trace(path) == []
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    names = [r.get("name") for r in recs]
    assert {"chunk", "step", "drain", "eval"} <= set(names)
    drains = [r for r in recs if r.get("name") == "drain"]
    assert sum(r["transfers"] for r in recs if r["kind"] == "span"
               and r["depth"] == 0) == len(drains)
    assert all(r["transfers"] == 1 for r in drains)
    assert drains[-1]["attrs"]["what"] == "probes"
    assert sum(r["attrs"]["iters"] for r in recs
               if r.get("name") == "chunk") == 6
    assert hist["probes"]["cursor"] == 6
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "summarize", str(path)],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr
    assert "chunk" in res.stdout and "rl:landscape:sphere" in res.stdout
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "validate", str(path)],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps(SPAN) + "\n")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "validate", str(bad)],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert res.returncode == 1 and "VIOLATION" in res.stderr


def test_traces_validate_in_both_packages(tmp_path, monkeypatch):
    """A trace the port writes passes ``repro.obs.trace.validate_trace``,
    and one the reference writes passes the port's. The reference's
    compile counter cannot run on this jax (its listener API is gone), so
    its ``Watch`` is stubbed: the records keep their schema, with zero
    counts."""
    ours = tmp_path / "port.jsonl"
    loop.train_rl_netes(TASK, loop.TrainConfig(
        n_agents=8, iters=3, seed=0, probes="fitness|graph", eval_every=3,
        trace=str(ours)), device="cpu")
    assert ref_trace.validate_trace(ours) == []

    monkeypatch.setattr(ref_xla_watch.Watch, "start", lambda self: self)
    monkeypatch.setattr(ref_xla_watch.Watch, "stop", lambda self: None)
    theirs = tmp_path / "ref.jsonl"
    with ref_trace.Trace(theirs, name="ref") as tr:
        with tr.span("chunk", iters=2):
            with tr.span("step"):
                pass
        tr.event("eval", score=-1.0)
    assert validate_trace(theirs) == []
    assert "chunk" in summarize(theirs)


def test_checkpoint_keys_of_the_ring_are_the_references(tmp_path):
    p = compile_probes("fitness|graph", capacity=5)
    ms = p.init("cpu")
    ms.buf.copy_(torch.arange(35, dtype=torch.float32).reshape(7, 5))
    ms.cursor.fill_(9)
    checkpoint.save_pytree(tmp_path / "ours.npz", {"obs": ms})
    with np.load(tmp_path / "ours.npz") as data:
        assert sorted(data.files) == ["obs::.buf", "obs::.cursor"]
    back = checkpoint.load_pytree(tmp_path / "ours.npz",
                                  {"obs": p.init("cpu")})["obs"]
    assert torch.equal(back.buf, ms.buf) and torch.equal(back.cursor,
                                                         ms.cursor)
