"""The sharded NetES fleet (``repro_torch.distributed.fleet_shard``, DESIGN.md
§13) and ``--shards`` through the RL main path.

* Plan parity: the port's ``make_comm_plan`` equals the reference's operand
  for operand, and ``collective_bytes`` its ints.
* Solo parity: the port's solo engine against the reference's
  ``ShardedNetES(mesh=None)``, with the reference's own draws injected
  (its fold-in ε, reward keys, dropout masks and schedule uniforms); and
  against the port's own ``netes_step`` from the same generator.
* Shard invariance: every case of ``tests/_torch_shard_cases.py`` run by
  2 and 4 gloo ranks spawned on the CPU (``tests/_torch_shard_ranks.py``
  under torchrun, one spawn a world size) equals the solo engine bit for
  bit, on every rank; a checkpoint saved at 4 ranks resumes at 2 and at 1.
* The plain R × S contractions against the reference's ``_slot_contract``
  and ``_dense_contract``; the kernel wrappers' R × S forms on the CPU.
* The launcher under ``torchrun --nproc-per-node 2 ... --shards 2``.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_ref import port_topology, reference_edge_mask, reset_states

import _torch_shard_cases as cases
from repro.comm import channel as ref_cc
from repro.core import netes as ref_netes
from repro.core import topology as ref_topology
from repro.core import topology_repr as ref_tr
from repro.core import topology_sched as ref_ts
from repro.core.topology import TopologySpec as RefSpec
from repro.distributed import fleet_shard as ref_fs
from repro.envs import resolve_task as ref_resolve_task
from repro.obs import probes as ref_probes
from repro_torch import convert
from repro_torch.comm.channel import compile_channel
from repro_torch.core import netes, topology_repr
from repro_torch.core.netes import Draws, NetESConfig
from repro_torch.core.topology import TopologySpec
from repro_torch.core.topology_sched import ScheduleSpec, compile_schedule
from repro_torch.distributed import fleet_shard
from repro_torch.envs import resolve_task
from repro_torch.kernels import netes_fused_mixing as nfm
from repro_torch.kernels import netes_mixing as nm
from repro_torch.kernels import netes_sparse_mixing as nsm
from repro_torch.kernels import ref
from repro_torch.obs import compile_probes
from repro_torch.train.loop import TrainConfig, train_rl_netes

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
RANKS = pathlib.Path(__file__).resolve().parent / "_torch_shard_ranks.py"
SPAWN_TIMEOUT = 300

# ---------------------------------------------------------------------------
# plan parity
# ---------------------------------------------------------------------------

PLAN_KINDS = ("er_sparse", "circulant", "dense", "fully_connected",
              "dropout")
CHAN_A = "quantize(bits=8)|dropout(p=0.1,seed=0)"


def _plan_inputs(kind, n):
    """(reference topology, port topology, reference channel, port
    channel) of a plan case."""
    if kind == "fully_connected":
        return ref_fs.FullyConnected(n), fleet_shard.FullyConnected(n), \
            None, None
    if kind == "circulant":
        adj = ref_topology.circulant_from_offsets(n, [1, 2, 5])
        rt = ref_tr.from_dense(adj, "circulant")
    else:
        adj = ref_topology.erdos_renyi(n, p=0.05 if n > 64 else 0.3, seed=3)
        rt = ref_tr.from_dense(adj, "dense" if kind == "dense" else "sparse")
    if kind == "dropout":
        return (rt, port_topology(rt), ref_cc.compile_channel(CHAN_A, n),
                compile_channel(CHAN_A, n))
    return rt, port_topology(rt), None, None


def _assert_plans_equal(got, want):
    for f in ("mode", "n", "n_dev", "n_loc", "n_pad", "rounds",
              "payload_rows"):
        assert getattr(got, f) == getattr(want, f), f
    assert sorted(got.operands) == sorted(want.operands)
    for k, v in want.operands.items():
        g = got.operands[k]
        assert g.dtype == v.dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)


@pytest.mark.parametrize("n_dev", (1, 2, 3, 8))
@pytest.mark.parametrize("n", (19, 64, 256))
@pytest.mark.parametrize("kind", PLAN_KINDS)
def test_comm_plan_equals_reference(kind, n, n_dev):
    rt, pt, rc, pc = _plan_inputs(kind, n)
    want = ref_fs.make_comm_plan(rt, n_dev, channel=rc)
    got = fleet_shard.make_comm_plan(pt, n_dev, channel=pc)
    _assert_plans_equal(got, want)


def test_plan_mode_selection_and_byte_ordering():
    """Circulant halo < ER halo < FC gather at 8 shards; stateful stages
    and schedules force the replicated fallback; FC has none."""
    p_er = fleet_shard.make_comm_plan(_plan_inputs("er_sparse", 256)[1], 8)
    p_circ = fleet_shard.make_comm_plan(_plan_inputs("circulant", 256)[1], 8)
    p_fc = fleet_shard.make_comm_plan(fleet_shard.FullyConnected(256), 8)
    assert (p_er.mode, p_circ.mode, p_fc.mode) == ("halo", "halo", "full")
    assert 0 < p_circ.payload_rows < p_er.payload_rows < p_fc.payload_rows
    ev = compile_channel("event_triggered(threshold=0.01)", 256)
    assert fleet_shard.make_comm_plan(_plan_inputs("er_sparse", 256)[1], 8,
                                      channel=ev).mode == "replicated"
    with pytest.raises(ValueError, match="FullyConnected"):
        fleet_shard.make_comm_plan(fleet_shard.FullyConnected(8), 2,
                                   channel=ev)


def _ref_reward(params, key):
    return -(params * params).sum(axis=-1)


@pytest.mark.parametrize("q8", (False, True))
@pytest.mark.parametrize("n_dev", (2, 8))
@pytest.mark.parametrize("kind", PLAN_KINDS)
def test_collective_bytes_equal_reference(kind, n_dev, q8):
    n, d = 256, 37
    rt, pt, rc, pc = _plan_inputs(kind, n)
    if q8 and rc is None:
        rc, pc = (ref_cc.compile_channel("quantize(bits=8)", n),
                  compile_channel("quantize(bits=8)", n))
    want_eng = ref_fs.ShardedNetES(rt, _ref_reward, ref_netes.NetESConfig(),
                                   channel=rc)
    want_eng.plan = ref_fs.make_comm_plan(rt, n_dev, channel=rc)
    got_eng = fleet_shard.ShardedNetES(pt, None, NetESConfig(), channel=pc)
    got_eng.plan = fleet_shard.make_comm_plan(pt, n_dev, channel=pc)
    want, got = want_eng.collective_bytes(d), got_eng.collective_bytes(d)
    assert got == want
    assert all(type(v) is int for v in got.values())


# ---------------------------------------------------------------------------
# solo parity against the reference's ShardedNetES(mesh=None)
# ---------------------------------------------------------------------------

N, ITERS = 19, 3
REF_CFG = dict(alpha=0.05, sigma=0.1, p_broadcast=0.5)
# name: (task, representation, density, channel, schedule, probes)
SOLO_CASES = {
    "sparse": ("landscape:rastrigin", "sparse", 0.3, None, None,
               "fitness|consensus|graph"),
    "sparse_pendulum": ("pendulum", "sparse", 0.3, None, None, None),
    "dense": ("landscape:rastrigin", "dense", 0.5, None, None, None),
    "full": ("landscape:rastrigin", "fc", 1.0, None, None,
             "fitness|consensus"),
    "q8_halo": ("landscape:sphere", "sparse", 0.3, "quantize(bits=8)",
                None, "all"),
    "dropout": ("landscape:rastrigin", "sparse", 0.3, CHAN_A, None, None),
    "resample_er": ("landscape:rastrigin", None, 0.3, None,
                    "resample_er(period=2)", "fitness|graph"),
}
# θ and best θ after ITERS steps: |port − reference| ≤ 1e-5·|reference| +
# 1e-6 (the contraction's rounding, and the landscape's returns in another
# summation order); the reward metrics to 1e-5 relative; the spread
# metrics, which the reference takes as float32 E[x²] − E[x]² (a
# cancellation) and the port exactly in float64, to 1e-3 relative + 1e-6
# of the second moment.
TOL_THETA = dict(rtol=1e-5, atol=1e-6)
TOL_REWARD = dict(rtol=1e-5, atol=1e-5)
# A pendulum episode that passes near the unstable equilibrium amplifies
# an ulp: JAX's float32 return and the port's of the same candidate and
# reset state can differ by far more than rounding (one swing-up in 38 was
# measured at −749 against −670; tests/test_torch_envs.py holds the returns
# with their rounding spread). The pendulum case runs one step, from the
# same candidates' bits, and holds θ, best θ (the same argmax agent) and
# the draws' effects, not the return values.
TOL_PENDULUM = dict(rtol=2e-3, atol=1e-3)


def _redraw_u(port_schedule, ref_state):
    """The uniform the reference's advance from ``ref_state`` redraws
    from, or None (tests/test_torch_topology_sched.py)."""
    if not port_schedule.redraws(int(ref_state.t) + 1):
        return None
    sub = jax.random.split(ref_state.key)[1]
    return torch.as_tensor(np.array(jax.random.uniform(
        sub, (port_schedule.n, port_schedule.n))))


def _iters(name):
    return 1 if SOLO_CASES[name][0] == "pendulum" else ITERS


def _fold_in_eps(key, n, d):
    _, k_eps, k_eval, k_beta = jax.random.split(key, 4)
    eps = jax.vmap(lambda g: jax.random.normal(
        jax.random.fold_in(k_eps, g), (d,), dtype=jnp.float32))(
        jnp.arange(n, dtype=jnp.int32))
    return np.asarray(eps), k_eval, np.asarray(jax.random.uniform(k_beta))


def _solo_pair(name):
    """The reference's solo engine stepped one iteration at a time, with
    the draws each step makes; and the port's solo engine run on them."""
    task, rep, dens, chan, sched, probes = SOLO_CASES[name]
    ref_fn, dim, init_fn, env, _ = ref_resolve_task(task)
    port_fn = resolve_task(task)[0]
    spec = RefSpec(family="erdos_renyi", n_agents=N, p=dens, seed=2)
    rt = pt = rsch = psch = None
    if sched is not None:
        rsch = ref_ts.compile_schedule(ref_ts.ScheduleSpec.parse(sched),
                                       spec, "sparse")
        psch = compile_schedule(ScheduleSpec.parse(sched), TopologySpec(
            family="erdos_renyi", n_agents=N, p=dens, seed=2), "sparse")
    elif rep == "fc":
        rt, pt = ref_fs.FullyConnected(N), fleet_shard.FullyConnected(N)
    else:
        rt = ref_tr.from_dense(ref_topology.erdos_renyi(N, p=dens, seed=2),
                               rep)
        pt = port_topology(rt)
    rch = None if chan is None else ref_cc.compile_channel(chan, N)
    pch = None if chan is None else compile_channel(chan, N)
    rpr = None if probes is None else ref_probes.compile_probes(
        probes, channel=rch, dim=dim)
    ppr = None if probes is None else compile_probes(probes, channel=pch,
                                                     dim=dim)
    reng = ref_fs.ShardedNetES(rt, ref_fn, ref_netes.NetESConfig(**REF_CFG),
                               channel=rch, schedule=rsch, probes=rpr)
    st0 = ref_netes.init_state(jax.random.PRNGKey(0), N, dim,
                               init_fn=init_fn)
    st, cs = st0, None if rch is None else rch.init(st0.thetas)
    ss = None if rsch is None else rsch.init()
    ms = None if rpr is None else rpr.init()
    draws, history = [], []
    for _ in range(_iters(name)):
        eps, k_eval, beta = _fold_in_eps(st.key, N, dim)
        live = ss.topo if rsch is not None else rt
        draws.append(Draws(
            eps=torch.as_tensor(eps), beta=torch.as_tensor(beta),
            evals=(None if env is None else
                   torch.as_tensor(reset_states(env, k_eval, N))),
            edge_mask=(None if rch is None or rch.dropout_stage is None
                       else torch.as_tensor(np.asarray(
                           reference_edge_mask(rch, cs, live)))),
            schedule_u=None if rsch is None else _redraw_u(psch, ss)))
        out = list(reng.run(st, 1, chan_state=cs, sched_state=ss,
                            metrics_state=ms))
        history.append({k: np.asarray(v)[0] for k, v in out.pop().items()})
        st = out.pop(0)
        ss = out.pop(0) if rsch is not None else ss
        cs = out.pop(0) if rch is not None else cs
        ms = out.pop(0) if rpr is not None else ms
    peng = fleet_shard.ShardedNetES(pt, port_fn, NetESConfig(**REF_CFG),
                                    channel=pch, schedule=psch, probes=ppr)
    pst = convert.state_from_reference(
        np.asarray(st0.thetas), np.asarray(st0.best_theta),
        np.asarray(st0.best_reward), np.asarray(st0.step), device="cpu")
    pout = list(peng.run(pst, _iters(name),
                         chan_state=None if pch is None
                         else pch.init(pst.thetas),
                         sched_state=None if psch is None
                         else psch.init(device="cpu"),
                         metrics_state=None if ppr is None
                         else ppr.init("cpu"), draws=draws))
    return (st, cs, ms, history), pout, ppr


@pytest.mark.parametrize("name", sorted(SOLO_CASES))
def test_solo_engine_matches_reference_solo_engine(name):
    (rst, rcs, rms, rhist), pout, ppr = _solo_pair(name)
    pmetrics = pout.pop()
    pst = pout[0]
    returns = SOLO_CASES[name][0] != "pendulum"
    np.testing.assert_allclose(pst.thetas.numpy(), np.asarray(rst.thetas),
                               **TOL_THETA)
    np.testing.assert_allclose(pst.best_theta.numpy(),
                               np.asarray(rst.best_theta), **TOL_THETA)
    if returns:
        np.testing.assert_allclose(pst.best_reward.numpy(),
                                   np.asarray(rst.best_reward), **TOL_REWARD)
    assert int(pst.step) == int(rst.step) == _iters(name)
    second = float((pst.thetas.double() ** 2).mean(0).sum())
    for it, want in enumerate(rhist):
        for k, v in want.items():
            got = pmetrics[k][it].numpy()
            if k in ("update_var", "theta_spread"):
                np.testing.assert_allclose(got, v, rtol=1e-3,
                                           atol=1e-6 * second, err_msg=k)
            elif k.startswith("reward"):
                if returns:
                    np.testing.assert_allclose(got, v, **TOL_REWARD,
                                               err_msg=k)
            elif k.endswith("_frac"):   # 1 − msgs/potential: an ulp apart
                np.testing.assert_allclose(got, v, rtol=1e-6, err_msg=k)
            else:       # broadcast, msgs: exact
                np.testing.assert_array_equal(got, v, err_msg=k)
    if rcs is not None:
        # the realized-traffic counter is the sum of the per-step msgs
        # (the reference's replicated mode adds a step's mixing messages
        # twice to ChannelState.msgs, once in the channel's apply and once
        # after; its per-step metric counts them once)
        total = sum(float(h["msgs"]) for h in rhist)
        assert float(pout[-1 - (ppr is not None)].msgs) == total
    if ppr is not None:
        np.testing.assert_allclose(pout[-1].buf.numpy(),
                                   np.asarray(rms.buf), rtol=1e-3,
                                   atol=1e-6 * max(second, 1.0))
        assert int(pout[-1].cursor) == int(rms.cursor) == ITERS


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_solo_engine_matches_netes_step(name):
    """The solo engine against ``netes_step`` (``scheduled_step``) from
    the same generator: the same draws, the contraction rounded in
    another order. θ within 1e-5·|θ| + 1e-6, the best reward within
    ``TOL_PENDULUM`` (measured ≤ 9.4e-4 relative here: a pendulum episode
    amplifies an ulp of θ), the generator, the step and the channel's
    counter exactly."""
    eng, state, cs, ss, ms = cases.build(name)
    out = list(eng.run(state, cases.ITERS, chan_state=cs, sched_state=ss,
                       metrics_state=ms))
    got = out[0]
    want_state = cases.build(name)[1]
    topo = eng.topo
    if isinstance(topo, fleet_shard.FullyConnected):
        topo = topology_repr.from_dense(np.ones((cases.N, cases.N),
                                                np.float32), "dense",
                                        device="cpu")
    ch = eng.channel
    cst = None if ch is None else ch.init(want_state.thetas)
    sst = None if eng.schedule is None else eng.schedule.init(device="cpu")
    for _ in range(cases.ITERS):
        if eng.schedule is None:
            want_state, cst, _ = netes.netes_step(
                want_state, topo, eng.reward_fn, eng.cfg, channel=ch,
                chan_state=cst)
        else:
            want_state, sst, cst, _ = netes.scheduled_step(
                want_state, sst, eng.reward_fn, eng.cfg, eng.schedule,
                channel=ch, chan_state=cst)
    np.testing.assert_allclose(got.thetas.numpy(), want_state.thetas.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.best_reward.numpy(),
                               want_state.best_reward.numpy(),
                               **TOL_PENDULUM)
    assert torch.equal(got.step, want_state.step)
    assert torch.equal(got.generator.get_state(),
                       want_state.generator.get_state())
    if ch is not None:
        assert torch.equal(out[1 + (eng.schedule is not None)].msgs,
                           cst.msgs)


# ---------------------------------------------------------------------------
# shard invariance: gloo ranks spawned by torchrun
# ---------------------------------------------------------------------------

def _spawn(world, out, *extra):
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{RANKS.parent}",
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), str(RANKS), "--out", str(out),
         *map(str, extra)],
        env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT,
        cwd=ROOT)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-6000:])
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


def _resume_copy(src, dst):
    """A copy of a checkpoint dir whose ``latest.json`` points at step 1."""
    shutil.copytree(src, dst)
    (dst / "latest.json").write_text((dst / "step_00000001.json")
                                     .read_text())


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """World 4 (the cases, and a checkpointed run), then world 2 (the
    cases, and that run resumed from its step 1); and the solo runs."""
    root = tmp_path_factory.mktemp("shard_worlds")
    w4 = _spawn(4, root / "w4", "--train-ckpt", root / "ck4",
                "--train-out", root / "train4.json")
    _resume_copy(root / "ck4", root / "ck2")
    _resume_copy(root / "ck4", root / "ck1")
    w2 = _spawn(2, root / "w2", "--train-ckpt", root / "ck2",
                "--train-out", root / "train2.json")
    solo = {name: cases.run(name) for name in cases.CASES}
    return {"root": root, 4: w4, 2: w2, "solo": solo}


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_shard_invariance_bit_for_bit(worlds, name, world):
    """θ, best θ, best reward, the generator, every metric, the channel's
    counter and the probe ring: the same bits on every rank as solo."""
    want = worlds["solo"][name]
    for rank, res in enumerate(worlds[world]):
        assert res["world_size"] == world
        got = res["cases"][name]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (name, world, rank, k)


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data}


@pytest.mark.parametrize("world", (1, 2))
def test_checkpoint_saved_at_4_ranks_resumes(worlds, world):
    """A run saved at 4 ranks (iterations 0–1), resumed at ``world``,
    logs iterations 2–3 as the 4-rank run did and writes the same final
    checkpoint, bit for bit."""
    root = worlds["root"]
    full = json.loads((root / "train4.json").read_text())
    if world == 1:
        tc = TrainConfig(shards=1, checkpoint_dir=str(root / "ck1"),
                         **_TRAIN)
        hist = train_rl_netes("pendulum", tc, device="cpu")
    else:
        hist = json.loads((root / "train2.json").read_text())
    assert hist["reward_mean"] == full["reward_mean"][2:]
    assert hist["reward_max"] == full["reward_max"][2:]
    assert hist["eval"] == full["eval"][1:]
    want = _npz(root / "ck4" / "step_00000003.npz")
    got = _npz(root / f"ck{world}" / "step_00000003.npz")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _load_ranks_module():
    sys.path.insert(0, str(RANKS.parent))
    import _torch_shard_ranks
    return _torch_shard_ranks


_TRAIN = _load_ranks_module().TRAIN


def test_launcher_under_torchrun_equals_world_of_one(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train rl
    --shards 2 --device cpu`` exits 0 with the history of the same run at
    ``--shards 1`` (a world of one, no launcher)."""
    argv = ["rl", "--agents", "16", "--iters", "5", "--density", "0.3",
            "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *argv,
         "--shards", "2", "--out", str(tmp_path / "h2.json")],
        env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT,
        cwd=ROOT)
    assert res.returncode == 0, res.stderr[-6000:]
    assert res.stdout.count("final eval:") == 1       # rank 0 alone prints
    from repro_torch.launch import train as launch_train
    launch_train.main(argv + ["--shards", "1", "--out",
                              str(tmp_path / "h1.json")])
    h2 = json.loads((tmp_path / "h2.json").read_text())["history"]
    h1 = json.loads((tmp_path / "h1.json").read_text())["history"]
    for k in ("reward_mean", "reward_max", "eval", "eval_iter",
              "final_eval"):
        assert h2[k] == h1[k], k


def test_shards_without_torchrun_raise_with_the_command(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        fleet_shard.build_mesh(2, device="cpu")


def test_train_config_takes_shards_and_lm_refuses_them():
    tc = TrainConfig(shards=2)
    assert tc.shards == 2
    from repro_torch.configs import get_config
    from repro_torch.train.loop import train_lm_netes
    with pytest.raises(ValueError, match="RL runs only"):
        train_lm_netes(get_config("gemma3-4b-smoke"), tc, device="cpu")


# ---------------------------------------------------------------------------
# the plain R × S contractions and the wrappers' R × S forms
# ---------------------------------------------------------------------------

def _rs_operands(seed, r=7, s=23, k=5, d=33):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, s, size=(r, k)).astype(np.int32)
    mask = (rng.random((r, k)) < 0.8).astype(np.float32)
    w = rng.normal(size=s).astype(np.float32)
    adj = (rng.random((r, s)) < 0.5).astype(np.float32)
    x = rng.normal(size=(s, d)).astype(np.float32)
    th = rng.normal(size=(r, d)).astype(np.float32)
    return idx, mask, w, adj, x, th


# The plain contractions against the reference's: the same sums in the
# same order, but XLA's CPU code (jax 0.9) contracts some of the reference's
# products into FMAs despite its barriers, so a sum may end an ulp or two
# apart: |port − reference| ≤ 2^-21·S, S the sum over absolute values.
TOL_CONTRACT = 2.0 ** -21


def _assert_contract_close(got, want, a, x):
    mixed, ws = (np.asarray(v, np.float64) for v in want)
    a = np.abs(np.asarray(a, np.float64))
    np.testing.assert_array_less(np.abs(got[0].numpy() - mixed),
                                 TOL_CONTRACT * (a @ np.abs(x)) + 1e-30)
    np.testing.assert_array_less(np.abs(got[1].numpy() - ws),
                                 TOL_CONTRACT * a.sum(1) + 1e-30)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_plain_slot_contract_equals_reference(seed):
    idx, mask, w, _, x, _ = _rs_operands(seed)
    wk = mask * w[idx]
    want = jax.jit(ref_fs._slot_contract)(jnp.asarray(idx), jnp.asarray(wk),
                                          jnp.asarray(x))
    got = fleet_shard._slot_contract(torch.as_tensor(idx),
                                     torch.as_tensor(wk), torch.as_tensor(x))
    _assert_contract_close(got, want, _dense_of(idx, wk, x.shape[0]), x)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_plain_dense_contract_equals_reference(seed):
    _, _, w, adj, x, _ = _rs_operands(seed)
    want = jax.jit(ref_fs._dense_contract)(jnp.asarray(adj), jnp.asarray(w),
                                           jnp.asarray(x))
    got = fleet_shard._dense_contract(torch.as_tensor(adj),
                                      torch.as_tensor(w), torch.as_tensor(x))
    _assert_contract_close(got, want, adj * w[None, :], x)


def _f64_rows(a, x, th):
    """Σ_s a_js·x_s − (Σ_s a_js)·θ_j in float64, and its S-scale."""
    a, x, th = (np.asarray(v, np.float64) for v in (a, x, th))
    ws = a.sum(1, keepdims=True)
    return a @ x - ws * th, np.abs(a) @ np.abs(x) + np.abs(ws * th)


def _dense_of(idx, wk, s):
    a = np.zeros((idx.shape[0], s))
    np.add.at(a, (np.arange(idx.shape[0])[:, None], idx), wk)
    return a


@pytest.mark.parametrize("form", ("sparse", "fused", "dense"))
@pytest.mark.parametrize("seed", (0, 1))
def test_rs_wrappers_on_cpu_are_the_plain_versions(form, seed):
    """Each wrapper's R × S form on CPU tensors is its plain version (the
    same bits), the reference's contraction with Eq. 3's correction within
    ``TOL_CONTRACT`` of the sum's scale, and float64's within 1e-6."""
    idx, mask, w, adj, x, th = _rs_operands(seed)
    t = {k: torch.as_tensor(v) for k, v in dict(
        idx=idx, mask=mask, w=w, adj=adj, x=x, th=th).items()}
    if form == "dense":
        got = nm.netes_mixing_rs(t["adj"], t["w"], t["x"], t["th"])
        plain = ref.netes_mixing_rs_ref(t["adj"], t["w"], t["x"], t["th"])
        mixed, ws = jax.jit(ref_fs._dense_contract)(adj, w, x)
        a, xs = adj * w[None, :], x
    elif form == "sparse":
        got = nsm.netes_sparse_mixing_rs(t["idx"], t["mask"], t["w"],
                                         t["x"], t["th"])
        plain = ref.sparse_mixing_rs_ref(t["idx"], t["mask"], t["w"],
                                         t["x"], t["th"])
        mixed, ws = jax.jit(ref_fs._slot_contract)(idx, mask * w[idx], x)
        a, xs = _dense_of(idx, mask * w[idx], x.shape[0]), x
    else:
        codes = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
        scale = np.abs(x).max(1, keepdims=True).astype(np.float32) / 127
        got = nfm.fused_neighbor_sum_rs(
            t["idx"], t["mask"], t["w"], torch.as_tensor(codes),
            torch.as_tensor(scale), t["th"])
        plain = ref.fused_neighbor_sum_rs_ref(
            t["idx"], t["mask"], t["w"], torch.as_tensor(codes),
            torch.as_tensor(scale), t["th"])
        xs = codes.astype(np.float32) * scale
        mixed, ws = jax.jit(ref_fs._slot_contract)(idx, mask * w[idx], xs)
        a = _dense_of(idx, mask * w[idx], x.shape[0])
    assert torch.equal(got, plain)
    want = jax.jit(lambda m, s, h: m - jax.lax.optimization_barrier(
        s[:, None] * h))(mixed, ws, th)
    exact, scale_s = _f64_rows(a, xs, th)
    assert (np.abs(got.numpy() - np.asarray(want))
            <= TOL_CONTRACT * scale_s).all()
    assert (np.abs(got.numpy() - exact) <= 1e-6 * scale_s).all()


def test_rs_wrappers_check_their_operands():
    idx, mask, w, adj, x, th = (torch.as_tensor(v)
                                for v in _rs_operands(0))
    with pytest.raises(ValueError, match="several devices"):
        nm.netes_mixing_rs(adj, w, x, th.to("meta"))
    with pytest.raises(ValueError, match="columns"):
        nsm.netes_sparse_mixing_rs(
            idx, mask, w, torch.empty((23, 65535 * 1024 + 1),
                                      device="meta"), th)


def test_plain_rs_rows_do_not_depend_on_the_rows_beside_them():
    """A row's result from a block of rows equals its result alone (the
    property that makes shard counts agree bit for bit)."""
    idx, mask, w, adj, x, th = (torch.as_tensor(v)
                                for v in _rs_operands(5, r=9))
    whole = ref.sparse_mixing_rs_ref(idx, mask, w, x, th)
    dense = ref.netes_mixing_rs_ref(adj, w, x, th)
    for j in range(9):
        rows = slice(j, j + 1)
        assert torch.equal(ref.sparse_mixing_rs_ref(
            idx[rows], mask[rows], w, x, th[rows]), whole[rows])
        assert torch.equal(ref.netes_mixing_rs_ref(
            adj[rows], w, x, th[rows]), dense[rows])


def test_core_run_with_a_mesh_dispatches_to_the_sharded_engine():
    """``netes.run(mesh=)`` returns ``netes.run``'s shapes, and equals the
    engine's run (through the engine cache)."""
    mesh = fleet_shard.build_mesh(1, device="cpu")
    try:
        eng, state, cs, _, _ = cases.build("topk_degree", mesh=mesh)
        out = netes.run(state, eng.topo, eng.reward_fn, eng.cfg, 2,
                        channel=eng.channel, chan_state=cs, mesh=mesh)
        assert len(out) == 3 and set(out[2]) >= {"reward_mean", "msgs"}
        eng2, state2, cs2, _, _ = cases.build("topk_degree", mesh=mesh)
        want = eng2.run(state2, 2, chan_state=cs2)
        assert torch.equal(out[0].thetas, want[0].thetas)
        assert torch.equal(out[1].msgs, want[1].msgs)
    finally:
        mesh.close()
        fleet_shard.clear_engine_cache()


def test_engine_keeps_netes_step_metric_keys():
    eng, state, cs, ss, ms = cases.build("channel_a")
    metrics = eng.run(state, 1, chan_state=cs, metrics_state=ms)[-1]
    assert set(metrics) == {"reward_mean", "reward_max", "reward_min",
                            "reward_std", "update_var", "broadcast",
                            "theta_spread", "best_idx", "msgs",
                            "trigger_frac", "drop_frac"}
    assert all(v.shape == (1,) for v in metrics.values())
