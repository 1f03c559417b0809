"""``netes_step`` of the port against ``repro.core.netes.netes_step``, step by
step, with the reference's own draws injected through the port's seam
(``Draws``): pendulum at the paper's policy width (D = 4481), N = 16, on a
dense, a sparse and a circulant topology.

Both packages start from the reference's θ⁽⁰⁾ (carried across by
``repro_torch.convert``); after that each carries its own state.

Tolerances:
* rewards: rtol 1e-5 plus six times the reference's one-ulp rounding spread
  (tests/_torch_ref.py; episodes near the upright equilibrium amplify
  rounding);
* the argmax agent and the broadcast flag: EQUAL. If the two best returns
  of the reference sit within the reward tolerance of each other, the
  failure says so;
* θ: atol 2e-5 + rtol 2e-5. θ' = θ + α/(Nσ²)·Eq. 3 − wd·θ with α/(Nσ²) =
  0.3125 here; Eq. 3 adds ≤ 2N = 32 f32 terms of magnitude ≲ 1 in another
  order (≈ 1e-6), and three steps compound it;
* ``update_var`` and ``theta_spread`` (sums of 4481 variances): rtol 1e-4.

The steps through a lossy channel (the second half of the file) state
their own tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as ref_envs
from _torch_ref import (assert_returns_close, one_level_slack,
                        port_topology, reference_edge_mask, rounding_spread,
                        step_draws, to_draws)
from repro.comm import channel as ref_cc
from repro.core import netes as ref_netes
from repro.core import topology as ref_topology
from repro.core import topology_repr as ref_repr
from repro_torch import convert, envs
from repro_torch.comm import channel as port_cc
from repro_torch.core import netes
from repro_torch.core.netes import NetESConfig
from repro_torch.core.topology import TopologySpec
from repro_torch.core.topology_repr import from_spec

N, STEPS = 16, 3
CASES = [("erdos_renyi", 0.5, "dense"), ("erdos_renyi", 0.3, "sparse"),
         ("circulant_erdos_renyi", 0.3, "circulant")]


@pytest.mark.parametrize("family,density,rep", CASES)
@pytest.mark.parametrize("p_broadcast", [0.8, 0.0])
def test_netes_step_matches_reference(family, density, rep, p_broadcast):
    ref_fn, dim, init_fn, ref_env, _ = ref_envs.resolve_task("pendulum")
    reward_fn = envs.resolve_task("pendulum")[0]
    cfg_kw = dict(alpha=0.05, sigma=0.1, p_broadcast=p_broadcast)
    ref_cfg, cfg = ref_netes.NetESConfig(**cfg_kw), NetESConfig(**cfg_kw)
    ref_topo = ref_repr.from_spec(ref_topology.TopologySpec(
        family=family, n_agents=N, p=density, seed=1), rep)
    topo = port_topology(ref_topo)
    assert topo.kind == rep

    ref_state = ref_netes.init_state(jax.random.PRNGKey(0), N, dim,
                                     init_fn=init_fn)
    state = convert.state_from_reference(
        np.asarray(ref_state.thetas), np.asarray(ref_state.best_theta),
        np.asarray(ref_state.best_reward), np.asarray(ref_state.step),
        device="cpu")
    rtol_theta = atol_theta = 2e-5
    for step in range(STEPS):
        eps, beta, resets = step_draws(ref_state.key, N, dim, ref_env)
        # the reference's raw returns of both halves, from the same k_eval
        k_eval = jax.random.split(ref_state.key, 4)[2]
        th = np.asarray(ref_state.thetas)
        cands = np.concatenate([th + cfg.sigma * eps, th - cfg.sigma * eps])
        cands = cands.astype(np.float32)
        ref_rewards = np.concatenate(
            [np.asarray(jax.jit(ref_fn)(jnp.asarray(cands[:N]), k_eval)),
             np.asarray(jax.jit(ref_fn)(jnp.asarray(cands[N:]), k_eval))])
        spread = np.concatenate([rounding_spread(ref_fn, cands[:N], k_eval, 4),
                                 rounding_spread(ref_fn, cands[N:], k_eval, 4)])

        ref_state, ref_m = ref_netes.netes_step(ref_state, ref_topo, ref_fn,
                                                ref_cfg)
        state, cs, m = netes.netes_step(state, topo, reward_fn, cfg,
                                        draws=to_draws(eps, beta, resets))
        assert cs is None
        where = f"{rep}, step {step}"

        top2 = np.sort(ref_rewards)[-2:]
        tol_top = 1e-5 * np.abs(top2[1]) + 6 * spread.max()
        near_tie = top2[1] - top2[0] <= tol_top
        assert int(m["best_idx"]) == int(np.argmax(ref_rewards)), (
            f"{where}: best agent {int(m['best_idx'])} vs reference "
            f"{int(np.argmax(ref_rewards))}"
            + (" — the two best reference returns are within the reward "
               "tolerance of each other (a near tie)" if near_tie else ""))
        assert float(m["broadcast"]) == float(ref_m["broadcast"]), where
        for k in ("reward_mean", "reward_max", "reward_min", "reward_std"):
            assert_returns_close(np.array([float(m[k])]),
                                 np.array([float(ref_m[k])]),
                                 np.array([spread.max()]))
        for k in ("update_var", "theta_spread"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{where}: {k}")
        np.testing.assert_allclose(state.thetas.numpy(),
                                   np.asarray(ref_state.thetas),
                                   rtol=rtol_theta, atol=atol_theta,
                                   err_msg=f"{where}: thetas")
        np.testing.assert_allclose(state.best_theta.numpy(),
                                   np.asarray(ref_state.best_theta),
                                   rtol=rtol_theta, atol=atol_theta,
                                   err_msg=f"{where}: best_theta")
        assert int(state.step) == int(ref_state.step)


def test_step_draws_from_generator_and_run_loop():
    """Without injected draws the step draws from the state's generator:
    the same seed gives the same trajectory, and ``run`` is that step
    loop with its metrics stacked."""
    reward_fn, dim, init_fn, _, _ = envs.resolve_task("landscape:sphere")
    from repro_torch.core.topology import TopologySpec
    from repro_torch.core.topology_repr import from_spec
    topo = from_spec(TopologySpec(family="erdos_renyi", n_agents=8, p=0.3),
                     device="cpu")
    cfg = NetESConfig()
    a = netes.init_state(8, dim, seed=5, init_fn=init_fn, device="cpu")
    b = netes.init_state(8, dim, seed=5, init_fn=init_fn, device="cpu")
    a, ca, ms = netes.run(a, topo, reward_fn, cfg, 3)
    assert ca is None
    for _ in range(3):
        b, _, m = netes.netes_step(b, topo, reward_fn, cfg)
    assert torch.equal(a.thetas, b.thetas)
    assert ms["reward_mean"].shape == (3,)
    assert float(ms["reward_mean"][-1]) == float(m["reward_mean"])
    assert int(a.step) == 3


@pytest.mark.parametrize("rep", ["dense", "sparse", "circulant"])
@pytest.mark.parametrize("variant", [
    dict(normalization="degree"),
    dict(antithetic=False),
    dict(fitness_shaping="normalize"),
    # raw returns (≈ 1e3) as weights need a step size ≈ 1e3× smaller
    dict(fitness_shaping="none", p_broadcast=0.0, alpha=5e-5),
])
def test_netes_step_config_variants(rep, variant):
    """The other NetESConfig branches, on a shifted rastrigin landscape
    (D = 64; the landscape is a smooth f32 function of θ). Metrics: rtol =
    atol = 2e-5, as the pendulum test's θ. θ: rtol 2e-5 and atol 2e-5 ·
    max(1, max|θ|) — with unshaped returns (≈ 1e3) as Eq. 3 weights the
    update's summands, and so its rounding, scale with them."""
    task = "landscape:rastrigin@1.5"
    ref_fn, dim, init_fn, _, _ = ref_envs.resolve_task(task)
    reward_fn = envs.resolve_task(task)[0]
    cfg_kw = {"alpha": 0.05, "sigma": 0.1, **variant}
    ref_cfg, cfg = ref_netes.NetESConfig(**cfg_kw), NetESConfig(**cfg_kw)
    family = "circulant_erdos_renyi" if rep == "circulant" else "erdos_renyi"
    ref_topo = ref_repr.from_spec(ref_topology.TopologySpec(
        family=family, n_agents=N, p=0.3, seed=2), rep)
    topo = port_topology(ref_topo)
    ref_state = ref_netes.init_state(jax.random.PRNGKey(3), N, dim,
                                     init_fn=init_fn)
    state = convert.state_from_reference(
        np.asarray(ref_state.thetas), np.asarray(ref_state.best_theta),
        np.asarray(ref_state.best_reward), np.asarray(ref_state.step),
        device="cpu")
    for step in range(2):
        draws = to_draws(*step_draws(ref_state.key, N, dim))
        ref_state, ref_m = ref_netes.netes_step(ref_state, ref_topo, ref_fn,
                                                ref_cfg)
        state, _, m = netes.netes_step(state, topo, reward_fn, cfg,
                                       draws=draws)
        where = f"{rep} {variant}, step {step}"
        for k, v in ref_m.items():
            np.testing.assert_allclose(float(m[k]), float(v), rtol=2e-5,
                                       atol=2e-5, err_msg=f"{where}: {k}")
        want = np.asarray(ref_state.thetas)
        np.testing.assert_allclose(
            state.thetas.numpy(), want, rtol=2e-5,
            atol=2e-5 * max(1.0, float(np.abs(want).max())), err_msg=where)


# ---------------------------------------------------------------------------
# with a lossy channel
# ---------------------------------------------------------------------------

CHANNEL_CASES = [
    # (family, density, representation, channel, fused)
    ("erdos_renyi", 0.3, "sparse", "quantize(bits=8)|dropout(p=0.1,seed=0)",
     True),                                     # the wire path
    ("erdos_renyi", 0.3, "sparse", "quantize(bits=8)|dropout(p=0.1,seed=0)",
     False),                                    # decode-then-contract
    ("erdos_renyi", 0.3, "sparse", "topk(frac=0.5)|dropout(p=0.2,seed=1)",
     True),
    ("erdos_renyi", 0.5, "dense", "quantize(bits=4)", True),
    ("erdos_renyi", 0.5, "dense",
     "event_triggered(threshold=0.01)|quantize(bits=4)|dropout(p=0.1,seed=0)",
     True),
    ("circulant_erdos_renyi", 0.3, "circulant",
     "event_triggered(threshold=0.01)|quantize(bits=8)", True),
]


@pytest.mark.parametrize("family,density,rep,text,fused", CHANNEL_CASES)
def test_netes_step_with_channel_matches_reference(family, density, rep,
                                                   text, fused):
    """Three steps of the reference's ``netes_step(..., channel,
    chan_state)``; before each, the port takes the reference's state,
    channel state, draws and dropout mask, and makes the same step.

    Each step starts from the reference's state: quantization is
    discontinuous, and a payload a few ulps away from the reference's
    changes a code by one level where it lies at a rounding boundary.
    Even from the same state the payloads differ by ulps: the reference's
    compiled step forms θ + σε with a fused multiply-add, and computes ε
    once per fusion that reads it, not always to the same bits (its
    last-sent payloads differ from its own ε draw by up to 2 ulps).

    Tolerances: θ as in the channel-free test (2e-5; a non-wire payload
    adds one rounding of x − θ per term, ≲ 1e-7 here), plus, in a column
    where a quantized payload element lies within levels·2⁻²⁰ of a
    rounding boundary (8 ulps of its message's absmax, in units of the
    quantization step), one step's worth of that element's level: α/(Nσ²)
    (|R̃| ≤ 1) times the step on each receiver, or the step itself in the
    broadcast; best θ as in the channel-free test; ``msgs``,
    ``trigger_frac``, ``drop_frac`` and the channel state's message count
    EQUAL; last-sent payloads within 4 ulps (rtol 5e-7, atol 1e-7); rewards
    as above.
    """
    ref_fn, dim, init_fn, ref_env, _ = ref_envs.resolve_task("pendulum")
    reward_fn = envs.resolve_task("pendulum")[0]
    cfg_kw = dict(alpha=0.05, sigma=0.1, p_broadcast=0.8)
    ref_cfg, cfg = ref_netes.NetESConfig(**cfg_kw), NetESConfig(**cfg_kw)
    ref_topo = ref_repr.from_spec(ref_topology.TopologySpec(
        family=family, n_agents=N, p=density, seed=1), rep)
    topo = port_topology(ref_topo)
    ref_ch = ref_cc.compile_channel(text, N, fused=fused)
    ch = port_cc.compile_channel(text, N, fused=fused)
    assert ch.wire_fused(topo) == ref_ch.wire_fused(ref_topo)

    ref_state = ref_netes.init_state(jax.random.PRNGKey(0), N, dim,
                                     init_fn=init_fn)
    ref_cstate = ref_ch.init(ref_state.thetas)
    for step in range(STEPS):
        state = convert.state_from_reference(
            np.asarray(ref_state.thetas), np.asarray(ref_state.best_theta),
            np.asarray(ref_state.best_reward), np.asarray(ref_state.step),
            device="cpu")
        cstate = convert.channel_state_from_reference(
            None if isinstance(ref_cstate.last_sent, tuple) else
            np.asarray(ref_cstate.last_sent), np.asarray(ref_cstate.msgs),
            device="cpu")
        eps, beta, resets = step_draws(ref_state.key, N, dim, ref_env)
        em = reference_edge_mask(ref_ch, ref_cstate, ref_topo)
        k_eval = jax.random.split(ref_state.key, 4)[2]
        th = np.asarray(ref_state.thetas)
        cands = np.concatenate([th + cfg.sigma * eps, th - cfg.sigma * eps])
        ref_rewards = np.concatenate([np.asarray(jax.jit(ref_fn)(
            jnp.asarray(c), k_eval)) for c in (cands[:N], cands[N:])])
        spread = np.concatenate([rounding_spread(ref_fn, c, k_eval, 4)
                                 for c in (cands[:N], cands[N:])])

        ref_state, ref_cstate, ref_m = ref_netes.netes_step(
            ref_state, ref_topo, ref_fn, ref_cfg, ref_ch, ref_cstate)
        last_sent = cstate.last_sent
        new, cstate, m = netes.netes_step(
            state, topo, reward_fn, cfg,
            draws=to_draws(eps, beta, resets, edge_mask=em), channel=ch,
            chan_state=cstate)
        payload = torch.as_tensor(cands[:N])
        if ch.event_stage is not None:
            payload = port_cc._event_select(payload, last_sent,
                                            ch.event_stage.threshold)[0]
        slack = one_level_slack(
            ch, topo.to_dense().numpy(), payload.numpy(),
            cands[int(m["best_idx"])], float(m["broadcast"]) > 0,
            cfg.alpha / (N * cfg.sigma ** 2))
        where = f"{rep} {text} fused={fused}, step {step}"
        top2 = np.sort(ref_rewards)[-2:]
        near_tie = top2[1] - top2[0] <= 1e-5 * np.abs(top2[1]) + 6 * spread.max()
        assert int(m["best_idx"]) == int(np.argmax(ref_rewards)), (
            f"{where}: best agent" + (" (a near tie of the two best reference"
                                      " returns)" if near_tie else ""))
        assert float(m["broadcast"]) == float(ref_m["broadcast"]), where
        for k in ("msgs", "trigger_frac", "drop_frac"):
            assert float(m[k]) == float(ref_m[k]), f"{where}: {k}"
        assert float(cstate.msgs) == float(ref_cstate.msgs), where
        if ch.event_stage is not None:
            np.testing.assert_allclose(cstate.last_sent.numpy(),
                                       np.asarray(ref_cstate.last_sent),
                                       rtol=5e-7, atol=1e-7, err_msg=where)
        for k in ("reward_mean", "reward_max", "reward_min", "reward_std"):
            assert_returns_close(np.array([float(m[k])]),
                                 np.array([float(ref_m[k])]),
                                 np.array([spread.max()]))
        for k in ("update_var", "theta_spread"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{where}: {k}")
        want = np.asarray(ref_state.thetas, np.float64)
        err = np.abs(new.thetas.numpy() - want)
        bad = err > 2e-5 + 2e-5 * np.abs(want) + slack
        assert not bad.any(), (
            f"{where}: thetas differ at {np.argwhere(bad)[:5].tolist()} by "
            f"{err[bad][:5]}")
        np.testing.assert_allclose(new.best_theta.numpy(),
                                   np.asarray(ref_state.best_theta),
                                   rtol=2e-5, atol=2e-5,
                                   err_msg=f"{where}: best_theta")


@pytest.mark.parametrize("rep", ["dense", "sparse", "circulant"])
@pytest.mark.parametrize("text", ["lossless", "dropout(p=0.0,seed=3)"])
def test_lossless_channel_is_the_channel_free_step_bit_for_bit(rep, text):
    """A lossless channel, and dropout with p = 0, leave the step's state
    and metrics EQUAL to the channel-free step's (reference
    tests/test_channel.py:134, 151)."""
    reward_fn, dim, init_fn, _, _ = envs.resolve_task("landscape:rastrigin@1.5")
    family = "circulant_erdos_renyi" if rep == "circulant" else "erdos_renyi"
    topo = from_spec(TopologySpec(family=family, n_agents=N, p=0.3, seed=2),
                     rep, device="cpu")
    cfg = NetESConfig(alpha=0.05, sigma=0.1)
    ch = port_cc.compile_channel(text, N)
    plain = netes.init_state(N, dim, seed=7, init_fn=init_fn, device="cpu")
    lossy = netes.init_state(N, dim, seed=7, init_fn=init_fn, device="cpu")
    cstate = ch.init(lossy.thetas)
    for _ in range(3):
        plain, _, m_plain = netes.netes_step(plain, topo, reward_fn, cfg)
        lossy, cstate, m = netes.netes_step(lossy, topo, reward_fn, cfg,
                                            channel=ch, chan_state=cstate)
        assert torch.equal(plain.thetas, lossy.thetas)
        assert torch.equal(plain.best_theta, lossy.best_theta)
        for k, v in m_plain.items():
            assert torch.equal(v, m[k]), k
        assert float(m["drop_frac"]) == 0.0
        assert float(m["trigger_frac"]) == 1.0


def test_run_with_channel_draws_its_own_masks():
    """``run`` with a channel: the channel state comes back advanced, the
    metrics gain ``msgs``/``drop_frac``/``trigger_frac`` per iteration, the
    dropout PRF makes the same masks from the same seed, and the message
    count equals the sum over the steps."""
    reward_fn, dim, init_fn, _, _ = envs.resolve_task("landscape:sphere")
    ch = port_cc.compile_channel("quantize(bits=8)|dropout(p=0.3,seed=4)", N)
    topo = from_spec(TopologySpec(family="erdos_renyi", n_agents=N, p=0.3),
                     device="cpu", channel=ch)
    assert ch.wire_fused(topo)
    cfg = NetESConfig()
    runs = []
    for _ in range(2):
        s = netes.init_state(N, dim, seed=5, init_fn=init_fn, device="cpu")
        runs.append(netes.run(s, topo, reward_fn, cfg, 4, channel=ch,
                              chan_state=ch.init(s.thetas)))
    (a, ca, ma), (b, cb, mb) = runs
    assert torch.equal(a.thetas, b.thetas)
    assert ma["msgs"].shape == (4,) and torch.equal(ma["msgs"], mb["msgs"])
    assert int(ca.draws) == 4
    assert float(ca.msgs) == float(ma["msgs"].sum())
    assert (ma["drop_frac"] > 0).all() and (ma["drop_frac"] < 1).all()
