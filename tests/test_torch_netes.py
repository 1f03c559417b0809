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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as ref_envs
from _torch_ref import (assert_returns_close, rounding_spread, step_draws,
                        to_draws)
from repro.core import netes as ref_netes
from repro.core import topology as ref_topology
from repro.core import topology_repr as ref_repr
from repro_torch import convert, envs
from repro_torch.core import netes
from repro_torch.core.netes import NetESConfig

N, STEPS = 16, 3
CASES = [("erdos_renyi", 0.5, "dense"), ("erdos_renyi", 0.3, "sparse"),
         ("circulant_erdos_renyi", 0.3, "circulant")]


def _port_topology(ref_topo):
    return convert.topology_from_reference(
        ref_topo.kind, ref_topo.n, np.asarray(ref_topo.deg),
        adj=None if ref_topo.adj is None else np.asarray(ref_topo.adj),
        neighbor_idx=(None if ref_topo.neighbor_idx is None
                      else np.asarray(ref_topo.neighbor_idx)),
        neighbor_mask=(None if ref_topo.neighbor_mask is None
                       else np.asarray(ref_topo.neighbor_mask)),
        offsets=ref_topo.offsets, device="cpu")


@pytest.mark.parametrize("family,density,rep", CASES)
@pytest.mark.parametrize("p_broadcast", [0.8, 0.0])
def test_netes_step_matches_reference(family, density, rep, p_broadcast):
    ref_fn, dim, init_fn, ref_env, _ = ref_envs.resolve_task("pendulum")
    reward_fn = envs.resolve_task("pendulum")[0]
    cfg_kw = dict(alpha=0.05, sigma=0.1, p_broadcast=p_broadcast)
    ref_cfg, cfg = ref_netes.NetESConfig(**cfg_kw), NetESConfig(**cfg_kw)
    ref_topo = ref_repr.from_spec(ref_topology.TopologySpec(
        family=family, n_agents=N, p=density, seed=1), rep)
    topo = _port_topology(ref_topo)
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
        state, m = netes.netes_step(state, topo, reward_fn, cfg,
                                    draws=to_draws(eps, beta, resets))
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
    a, ms = netes.run(a, topo, reward_fn, cfg, 3)
    for _ in range(3):
        b, m = netes.netes_step(b, topo, reward_fn, cfg)
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
    topo = _port_topology(ref_topo)
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
        state, m = netes.netes_step(state, topo, reward_fn, cfg, draws=draws)
        where = f"{rep} {variant}, step {step}"
        for k, v in ref_m.items():
            np.testing.assert_allclose(float(m[k]), float(v), rtol=2e-5,
                                       atol=2e-5, err_msg=f"{where}: {k}")
        want = np.asarray(ref_state.thetas)
        np.testing.assert_allclose(
            state.thetas.numpy(), want, rtol=2e-5,
            atol=2e-5 * max(1.0, float(np.abs(want).max())), err_msg=where)
