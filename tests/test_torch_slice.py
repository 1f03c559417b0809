"""The port's slices as a whole: ``train_rl_netes`` against the JAX
reference's training loop, without and with a lossy channel and under a
topology schedule, its checkpoint resume, plus the port's package-level
contracts.

``repro.train.loop`` does not import on this jax (ROADMAP queue 3, item a),
so the reference run is composed here from ``repro.core.netes.netes_step``
and ``repro.envs.rollout.evaluate_best`` exactly as ``train/loop.py:231-367``
composes them. The port runs pendulum at N = 16 on a sparse Erdős–Rényi
graph (p = 0.3), 6 iterations with an eval every 3, starting from the
reference's θ⁽⁰⁾ with the reference's draws injected for every step and
every eval (under a schedule, its redraws too).

Tolerances: ``eval_iter`` EQUAL; ``reward_mean``, ``reward_max`` and
``eval`` within rtol 1e-5 plus six times the reference's one-ulp rounding
spread of the returns (see tests/_torch_ref.py), measured at each eval
point for ``eval`` and set from the largest per-step spread for the
training rewards. With a channel, the per-step message counts and
``realized_msgs`` EQUAL as well.
"""
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.envs as ref_envs
from _torch_ref import (assert_returns_close, eval_reset_states,
                        reference_edge_mask, rounding_spread, step_draws,
                        to_draws)
from repro.comm import channel as ref_cc
from repro.core import netes as ref_netes
from repro.core import topology as ref_topology
from repro.core import topology_repr as ref_repr
from repro.core import topology_sched as ref_sched
from repro.envs.rollout import evaluate_best as ref_evaluate_best
from repro_torch import convert
from repro_torch.core.netes import NetESConfig
from repro_torch.core.topology import TopologySpec
from repro_torch.launch import train as launch_train
from repro_torch.train import loop

N, ITERS, EVAL_EVERY, EPISODES, SEED = 16, 6, 3, 4, 0
SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


def _reference_run(spec_kw, cfg_kw, channel=None, schedule=None):
    """``train_rl_netes`` of the reference, composed from its parts; also
    returns the draws it made, for the port's seam (with a channel, the
    dropout masks go in the history's ``edge_masks``; under a schedule,
    its redraws in ``schedule_u``, None where a step draws none)."""
    ref_fn, dim, init_fn, env, policy = ref_envs.resolve_task("pendulum")
    cfg = ref_netes.NetESConfig(**cfg_kw)
    spec = ref_topology.TopologySpec(**spec_kw)
    sch = sstate = None
    if schedule is None:
        topo = ref_repr.from_spec(spec, "sparse")
    else:
        sch = ref_sched.compile_schedule(
            ref_sched.ScheduleSpec.parse(schedule), spec, "sparse")
        sstate = sch.init()
    state = ref_netes.init_state(jax.random.PRNGKey(SEED), N, dim,
                                 init_fn=init_fn)
    init = state
    eval_key = jax.random.PRNGKey(SEED + 999)
    eval_iters = list(range(EVAL_EVERY - 1, ITERS, EVAL_EVERY))
    hist = {"reward_mean": [], "reward_max": [], "eval": [], "eval_iter": [],
            "msgs": [], "edge_masks": [], "schedule_u": []}
    draws, eval_resets, spreads, eval_spreads = {}, {}, [], []
    ch = (None if channel is None
          else ref_cc.compile_channel(channel, N, fused=True))
    cstate = None if ch is None else ch.init(state.thetas)

    def one_eval(th, k):
        return ref_evaluate_best(env, policy, th[0], k, EPISODES)[None]

    for it in range(ITERS):
        draws[it] = step_draws(state.key, N, dim, env)
        if sch is not None:
            topo = sstate.topo
            redraw = ((it + 1) % sch.spec.period == 0
                      and sch.spec.kind == "resample_er")
            hist["schedule_u"].append(np.array(jax.random.uniform(
                jax.random.split(sstate.key)[1], (N, N))) if redraw else None)
        if ch is not None:
            hist["edge_masks"].append(reference_edge_mask(ch, cstate, topo))
        th = np.asarray(state.thetas)
        eps = draws[it][0]
        k_eval = jax.random.split(state.key, 4)[2]
        for sign in (1, -1):
            spreads.append(rounding_spread(
                ref_fn, (th + sign * cfg.sigma * eps).astype(np.float32),
                k_eval, samples=4).max())
        if ch is None:
            state, m = ref_netes.netes_step(state, topo, ref_fn, cfg)
        else:
            state, cstate, m = ref_netes.netes_step(state, topo, ref_fn, cfg,
                                                    ch, cstate)
            hist["msgs"].append(float(m["msgs"]))
        if sch is not None:
            sstate = sch.advance(sstate)
        hist["reward_mean"].append(float(m["reward_mean"]))
        hist["reward_max"].append(float(m["reward_max"]))
        if it in eval_iters:
            eval_key, k_eval = jax.random.split(eval_key)
            eval_resets[it] = eval_reset_states(env, k_eval, EPISODES)
            hist["eval"].append(float(ref_evaluate_best(
                env, policy, state.best_theta, k_eval, EPISODES)))
            hist["eval_iter"].append(it)
            eval_spreads.append(rounding_spread(
                one_eval, np.asarray(state.best_theta)[None], k_eval)[0])
    return hist, init, draws, eval_resets, max(spreads), eval_spreads


def test_train_rl_netes_matches_reference():
    spec_kw = dict(family="erdos_renyi", n_agents=N, p=0.3, seed=0)
    cfg_kw = dict(alpha=0.05, sigma=0.1, p_broadcast=0.8)
    want, init, draws, eval_resets, spread, eval_spreads = _reference_run(
        spec_kw, cfg_kw)

    tc = loop.TrainConfig(iters=ITERS, eval_every=EVAL_EVERY,
                          eval_episodes=EPISODES, seed=SEED,
                          representation="sparse",
                          topology=TopologySpec(**spec_kw),
                          netes=NetESConfig(**cfg_kw))
    assert loop.build_topology(tc, device="cpu").kind == "sparse"
    state = convert.state_from_reference(
        np.asarray(init.thetas), np.asarray(init.best_theta),
        np.asarray(init.best_reward), np.asarray(init.step), device="cpu")
    got = loop.train_rl_netes(
        "pendulum", tc, device="cpu", state=state,
        step_draws=lambda it: to_draws(*draws[it]),
        eval_draws=lambda it: torch.as_tensor(eval_resets[it]))

    assert got["eval_iter"] == want["eval_iter"] == [2, 5]
    for k in ("reward_mean", "reward_max"):
        assert len(got[k]) == ITERS
        assert_returns_close(np.array(got[k]), np.array(want[k]),
                             np.full(ITERS, spread))
    assert_returns_close(np.array(got["eval"]), np.array(want["eval"]),
                         np.array(eval_spreads))
    assert got["final_eval"] == got["eval"][-1]
    assert got["max_eval"] == max(got["eval"])


def test_train_rl_netes_with_channel_matches_reference():
    """The lossy-channel slice end to end: sign quantization (q1) and link
    dropout on the sparse graph, so ``auto`` keeps the neighbor list and
    every step mixes from the wire form (the fused neighbor sum and the
    fused broadcast select), with the reference's dropout masks injected.
    q1 is the quantizer whose codes no ulp-level difference of the
    payload can change (its one boundary is 0); the q8 and q4 paths are
    held step by step in tests/test_torch_netes.py."""
    text = "quantize(bits=1)|dropout(p=0.2,seed=0)"
    spec_kw = dict(family="erdos_renyi", n_agents=N, p=0.3, seed=0)
    cfg_kw = dict(alpha=0.05, sigma=0.1, p_broadcast=0.8)
    want, init, draws, eval_resets, spread, eval_spreads = _reference_run(
        spec_kw, cfg_kw, channel=text)

    tc = loop.TrainConfig(iters=ITERS, eval_every=EVAL_EVERY,
                          eval_episodes=EPISODES, seed=SEED, channel=text,
                          topology=TopologySpec(**spec_kw),
                          netes=NetESConfig(**cfg_kw))
    topo = loop.build_topology(tc, device="cpu")
    assert topo.kind == "sparse" and loop.build_channel(tc).wire_fused(topo)
    state = convert.state_from_reference(
        np.asarray(init.thetas), np.asarray(init.best_theta),
        np.asarray(init.best_reward), np.asarray(init.step), device="cpu")
    got = loop.train_rl_netes(
        "pendulum", tc, device="cpu", state=state,
        step_draws=lambda it: to_draws(*draws[it],
                                       edge_mask=want["edge_masks"][it]),
        eval_draws=lambda it: torch.as_tensor(eval_resets[it]))

    assert got["eval_iter"] == want["eval_iter"]
    assert got["msgs"] == want["msgs"]
    assert got["realized_msgs"] == sum(want["msgs"])
    assert got["realized_wire_bytes"] == int(round(
        sum(want["msgs"]) * ref_cc.compile_channel(text, N).payload_bytes(
            4481)))
    assert len(got["drop_frac"]) == ITERS
    assert all(0.0 < f < 1.0 for f in got["drop_frac"])
    for k in ("reward_mean", "reward_max"):
        assert_returns_close(np.array(got[k]), np.array(want[k]),
                             np.full(ITERS, spread))
    assert_returns_close(np.array(got["eval"]), np.array(want["eval"]),
                         np.array(eval_spreads))


def test_train_rl_netes_with_schedule_matches_reference():
    """A resampled sparse graph (``resample_er(period=2)``, K_max padded
    by ``pad_k_max``) end to end: the reference composed from
    ``netes_step`` and ``TopologySchedule.advance`` as its
    ``scheduled_step`` composes them, the port with every draw injected,
    the schedule's redraws included."""
    text = "resample_er(period=2,seed=3)"
    spec_kw = dict(family="erdos_renyi", n_agents=N, p=0.3, seed=0)
    cfg_kw = dict(alpha=0.05, sigma=0.1, p_broadcast=0.8)
    want, init, draws, eval_resets, spread, eval_spreads = _reference_run(
        spec_kw, cfg_kw, schedule=text)
    assert sum(u is not None for u in want["schedule_u"]) == ITERS // 2

    tc = loop.TrainConfig(iters=ITERS, eval_every=EVAL_EVERY,
                          eval_episodes=EPISODES, seed=SEED,
                          representation="sparse", schedule=text,
                          topology=TopologySpec(**spec_kw),
                          netes=NetESConfig(**cfg_kw))
    schedule = loop.build_schedule(tc)
    assert schedule.representation == "sparse"
    state = convert.state_from_reference(
        np.asarray(init.thetas), np.asarray(init.best_theta),
        np.asarray(init.best_reward), np.asarray(init.step), device="cpu")

    def port_draws(it):
        u = want["schedule_u"][it]
        return dataclasses.replace(
            to_draws(*draws[it]),
            schedule_u=None if u is None else torch.as_tensor(u))

    got = loop.train_rl_netes(
        "pendulum", tc, device="cpu", state=state, step_draws=port_draws,
        eval_draws=lambda it: torch.as_tensor(eval_resets[it]))

    assert got["eval_iter"] == want["eval_iter"] == [2, 5]
    for k in ("reward_mean", "reward_max"):
        assert_returns_close(np.array(got[k]), np.array(want[k]),
                             np.full(ITERS, spread))
    assert_returns_close(np.array(got["eval"]), np.array(want["eval"]),
                         np.array(eval_spreads))


def test_resume_equals_the_uninterrupted_run_bit_for_bit(tmp_path):
    """A resampled sparse graph through q8 and dropout, its own draws: a
    run of 2 iterations that checkpoints, then the same config with 4
    iterations, which resumes at iteration 2, gives the evals,
    ``reward_mean`` and ``msgs`` of the uninterrupted 4-iteration run
    EQUAL."""
    tc = loop.TrainConfig(
        iters=4, eval_every=2, eval_episodes=2, seed=1,
        representation="sparse", schedule="resample_er(period=2,seed=7)",
        channel="quantize(bits=8)|dropout(p=0.1,seed=0)",
        topology=TopologySpec(family="erdos_renyi", n_agents=N, p=0.3,
                              seed=2),
        netes=NetESConfig(alpha=0.05, sigma=0.1, p_broadcast=0.5))
    full = loop.train_rl_netes("pendulum", tc, device="cpu")
    ckpt = str(tmp_path / "ck")
    half = loop.train_rl_netes("pendulum", dataclasses.replace(
        tc, iters=2, checkpoint_dir=ckpt), device="cpu")
    assert (tmp_path / "ck" / "step_00000001.npz").exists()
    resumed = loop.train_rl_netes("pendulum", dataclasses.replace(
        tc, checkpoint_dir=ckpt), device="cpu")
    assert half["eval"] == full["eval"][:1]
    assert half["msgs"] == full["msgs"][:2]
    assert resumed["eval_iter"] == full["eval_iter"][1:] == [3]
    for k in ("eval", "reward_mean", "reward_max", "msgs", "drop_frac"):
        n = len(resumed[k])
        assert resumed[k] == full[k][-n:], k
    assert len(resumed["reward_mean"]) == 2
    assert json.loads((tmp_path / "ck" / "latest.json").read_text())[
        "step"] == 3


def test_paper_eval_protocol_iterations():
    """eval_every = 0: each iteration with probability 0.08 from
    np.random.default_rng(seed + 999), plus the last (train/loop.py:231-237)."""
    for seed, iters in ((0, 50), (3, 120)):
        tc = loop.TrainConfig(iters=iters, seed=seed)
        draw = np.random.default_rng(seed + 999)
        want = [it for it in range(iters) if draw.random() < 0.08]
        if iters - 1 not in want:
            want.append(iters - 1)
        assert loop.eval_iterations(tc) == want
    assert loop.eval_iterations(loop.TrainConfig(iters=0)) == []


def test_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for GPU-less hosts")
    tc = loop.TrainConfig(n_agents=8, iters=1)
    with pytest.raises(RuntimeError, match="cuda"):
        loop.train_rl_netes("pendulum", tc)
    with pytest.raises(RuntimeError, match="cuda"):
        loop.build_topology(tc)


def test_launcher_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "hist.json"
    launch_train.main(["rl", "--task", "landscape:sphere", "--agents", "8",
                       "--iters", "3", "--density", "0.3", "--device", "cpu",
                       "--out", str(out)])
    printed = capsys.readouterr().out
    assert "final eval:" in printed and out.exists()


def test_launcher_runs_a_channel_on_cpu(tmp_path, capsys):
    out = tmp_path / "hist.json"
    launch_train.main(["rl", "--task", "landscape:sphere", "--agents", "8",
                       "--iters", "3", "--density", "0.3", "--device", "cpu",
                       "--channel", "quantize(bits=8)|dropout(p=0.1,seed=0)",
                       "--out", str(out)])
    printed = capsys.readouterr().out
    assert "realized messages:" in printed
    hist = json.loads(out.read_text())["history"]
    assert len(hist["msgs"]) == 3
    assert hist["realized_msgs"] == sum(hist["msgs"])


def test_launcher_runs_a_schedule_and_resumes_on_cpu(tmp_path, capsys):
    ck = tmp_path / "ck"
    args = ["rl", "--task", "landscape:sphere", "--agents", "12",
            "--density", "0.3", "--device", "cpu", "--representation",
            "sparse", "--schedule", "resample_er(period=2)",
            "--checkpoint-dir", str(ck)]
    launch_train.main(args + ["--iters", "3", "--out",
                              str(tmp_path / "a.json")])
    assert json.loads((ck / "latest.json").read_text())["step"] == 2
    launch_train.main(args + ["--iters", "6", "--out",
                              str(tmp_path / "b.json")])
    hist = json.loads((tmp_path / "b.json").read_text())["history"]
    assert len(hist["reward_mean"]) == 3          # iterations 3–5 only
    assert hist["eval_iter"][-1] == 5
    assert "final eval:" in capsys.readouterr().out


def test_train_rl_netes_with_probes_and_trace_equals_the_plain_run(
        tmp_path):
    """Pendulum at N = 16 on the sparse ER graph with an eval every 2
    iterations: with probes and a trace the history equals the plain
    run's EXACTLY, the fitness series is ``reward_mean`` in float32, the
    graph series is the fixed graph's, and the trace validates with one
    transfer per drain."""
    from repro_torch.obs import validate_trace
    tc = loop.TrainConfig(
        iters=5, eval_every=2, eval_episodes=2, seed=3,
        representation="sparse",
        topology=TopologySpec(family="erdos_renyi", n_agents=N, p=0.3,
                              seed=0),
        netes=NetESConfig(alpha=0.05, sigma=0.1, p_broadcast=0.8))
    plain = loop.train_rl_netes("pendulum", tc, device="cpu")
    trace = tmp_path / "run.jsonl"
    probed = loop.train_rl_netes("pendulum", dataclasses.replace(
        tc, probes="fitness|consensus|graph", trace=str(trace)),
        device="cpu")
    series = probed.pop("probes")
    for k in ("reward_mean", "reward_max", "eval", "eval_iter"):
        assert probed[k] == plain[k], k
    assert series["cursor"] == 5 and series["dropped"] == 0
    np.testing.assert_array_equal(series["fitness_mean"],
                                  np.asarray(plain["reward_mean"],
                                             np.float32))
    adj = TopologySpec(family="erdos_renyi", n_agents=N, p=0.3,
                       seed=0).build()
    density = np.float32((adj.sum() - N) / (N * (N - 1)))
    np.testing.assert_array_equal(series["density"], np.full(5, density))
    assert validate_trace(trace) == []
    recs = [json.loads(x) for x in trace.read_text().splitlines()]
    assert recs[0]["probes"] == "fitness|consensus|graph"
    # no log: the 5 iterations' metrics and the 3 scores leave in one drain
    drains = [r for r in recs if r.get("name") == "drain"]
    assert [r["attrs"] for r in drains] == [
        {"what": "eval", "iters": 5, "points": 3}, {"what": "probes"}]
    assert all(r["transfers"] == 1 for r in drains)
    assert [r["attrs"]["iter"] for r in recs if r.get("name") == "eval"] \
        == [1, 3, 4]


def test_launcher_probes_and_traces_a_channel_on_cpu(tmp_path, capsys):
    from repro_torch.obs import validate_trace
    out, trace = tmp_path / "hist.json", tmp_path / "run.jsonl"
    launch_train.main(["rl", "--task", "landscape:sphere", "--agents", "8",
                       "--iters", "4", "--density", "0.3", "--device", "cpu",
                       "--channel", "quantize(bits=8)|dropout(p=0.1,seed=0)",
                       "--probes", "all", "--probe-capacity", "3",
                       "--trace", str(trace), "--out", str(out)])
    assert "realized messages:" in capsys.readouterr().out
    hist = json.loads(out.read_text())["history"]
    probes = hist["probes"]
    assert probes["cursor"] == 4 and probes["dropped"] == 1
    assert probes["msgs"] == hist["msgs"][-3:]
    assert len(probes["wire_bytes"]) == 3 and len(probes["density"]) == 3
    assert validate_trace(trace) == []


def test_launcher_probes_a_schedule_and_resumes_on_cpu(tmp_path):
    """``--probes fitness|graph`` under ``--schedule``: the resumed run's
    ring holds the whole series, equal to an uninterrupted run's."""
    ck = tmp_path / "ck"
    args = ["rl", "--task", "landscape:sphere", "--agents", "12",
            "--density", "0.3", "--device", "cpu", "--representation",
            "sparse", "--schedule", "resample_er(period=2)", "--probes",
            "fitness|graph"]
    launch_train.main(args + ["--iters", "6", "--out",
                              str(tmp_path / "full.json")])
    launch_train.main(args + ["--iters", "3", "--checkpoint-dir", str(ck),
                              "--out", str(tmp_path / "a.json")])
    launch_train.main(args + ["--iters", "6", "--checkpoint-dir", str(ck),
                              "--out", str(tmp_path / "b.json")])
    full = json.loads((tmp_path / "full.json").read_text())["history"]
    resumed = json.loads((tmp_path / "b.json").read_text())["history"]
    assert len(resumed["reward_mean"]) == 3
    assert resumed["probes"] == full["probes"]
    assert resumed["probes"]["cursor"] == 6
    assert resumed["probes"]["density"][0] != resumed["probes"][
        "density"][2]


def test_port_imports_no_jax_and_no_reference():
    """Import every module of the port in a fresh interpreter: neither jax
    nor the reference package may be loaded. The sources (and
    chip_smoke.py) hold no such import statement either."""
    pkg = SRC / "repro_torch"
    mods = []
    for p in sorted(pkg.rglob("*.py")):
        parts = p.relative_to(SRC).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'repro'))\nassert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 20
    assert {"repro_torch.configs.base", "repro_torch.models.transformer",
            "repro_torch.kernels.flash_attention", "repro_torch.serve.engine",
            "repro_torch.launch.serve", "repro_torch.models.moe",
            "repro_torch.kernels.moe_router", "repro_torch.models.rwkv6",
            "repro_torch.kernels.rwkv6_wkv",
            "repro_torch.configs.rwkv6_7b", "repro_torch.models.mamba",
            "repro_torch.kernels.mamba_scan",
            "repro_torch.configs.jamba_v01_52b",
            "repro_torch.core.topology_sched", "repro_torch.checkpoint.io",
            "repro_torch.checkpoint", "repro_torch.core.theory",
            "repro_torch.obs", "repro_torch.obs.probes",
            "repro_torch.obs.trace", "repro_torch.obs.cuda_watch",
            "repro_torch.obs.__main__", "repro_torch.search",
            "repro_torch.search.candidates",
            "repro_torch.search.tournament", "repro_torch.data",
            "repro_torch.data.synthetic", "repro_torch.distributed",
            "repro_torch.distributed.netes_dist",
            "repro_torch.distributed.fleet_shard",
            "repro_torch.distributed.permute_mixing",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.context",
            "repro_torch.launch.mesh", "repro_torch.launch.specs",
            "repro_torch.models.frontends", "repro_torch.optim",
            "repro_torch.optim.adam", "repro_torch.optim.sgd",
            "repro_torch.configs.whisper_tiny",
            "repro_torch.configs.llava_next_mistral_7b",
            "repro_torch.launch.op_costs", "repro_torch.launch.analysis",
            "repro_torch.launch.dryrun", "repro_torch.analysis",
            "repro_torch.analysis.__main__", "repro_torch.analysis.cli",
            "repro_torch.analysis.ast_rules",
            "repro_torch.analysis.contracts",
            "repro_torch.analysis.findings",
            "repro_torch.analysis.registry"} <= set(mods)

    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                         r"(\.|\s+import\b))", re.MULTILINE)
    for path in [*pkg.rglob("*.py"), SRC.parent / "chip_smoke.py",
                 *(SRC.parent / "examples").glob("*_torch.py")]:
        assert not pattern.search(path.read_text()), path
