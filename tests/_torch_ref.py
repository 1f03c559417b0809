"""Helpers for the port's parity tests: the JAX reference's own random
draws, made exactly as the reference makes them, handed to the port as
numpy arrays through its draw seam (``repro_torch.core.netes.Draws`` and the
reward functions' ``evals``)."""
import functools

import jax
import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.netes import Draws

# The parity tests step tiny tensors through thousands of small ops, where
# PyTorch's intra-op thread pool only adds contention: pytest-xdist runs
# several workers on the same cores, each with a pool the size of the box.
torch.set_num_threads(1)


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def _reset_states(env, k_eval, m, episodes_per_eval):
    keys = jax.random.split(k_eval, m)

    def one(key):
        eps_keys = jax.random.split(key, episodes_per_eval)
        return jax.vmap(lambda k: env.reset(jax.random.split(k)[0]))(eps_keys)

    return jax.vmap(one)(keys)


def reset_states(env, k_eval, m, episodes_per_eval=1):
    """The reset states ``make_env_reward_fn(env, policy)(params, k_eval)``
    starts its M episodes from (envs/rollout.py:21-22, 45, 51): split the
    key M ways, then ``episodes_per_eval`` ways, then ``split(·)[0]`` is the
    reset key. Returns (M, episodes_per_eval, S)."""
    return np.array(_reset_states(env, k_eval, m, episodes_per_eval))


def eval_reset_states(env, k_eval, episodes):
    """The reset states of ``evaluate_best(env, policy, θ, k_eval,
    episodes)``: (episodes, S)."""
    return np.array(_eval_reset_states(env, k_eval, episodes))


@functools.partial(jax.jit, static_argnums=(0, 2))
def _eval_reset_states(env, k_eval, episodes):
    keys = jax.random.split(k_eval, episodes)
    return jax.vmap(lambda k: env.reset(jax.random.split(k)[0]))(keys)


def step_draws(state_key, n, dim, env=None):
    """The draws ``repro.core.netes.netes_step`` makes from ``state.key``
    (core/netes.py:156, 158, 205), as numpy: ε (N, D), β, and for an RL
    task the N reset states of ``k_eval``."""
    _, k_eps, k_eval, k_beta = jax.random.split(state_key, 4)
    eps, beta = _normal_uniform(k_eps, k_beta, n, dim)
    resets = None if env is None else reset_states(env, k_eval, n)
    return np.array(eps), np.array(beta), resets


@functools.partial(jax.jit, static_argnums=(2, 3))
def _normal_uniform(k_eps, k_beta, n, dim):
    return jax.random.normal(k_eps, (n, dim)), jax.random.uniform(k_beta)


@functools.lru_cache(maxsize=None)
def _jitted(fn):
    return jax.jit(fn)


def to_draws(eps, beta, resets, device="cpu", edge_mask=None):
    return Draws(eps=torch.as_tensor(eps, device=device),
                 beta=torch.as_tensor(beta, device=device),
                 evals=None if resets is None
                 else torch.as_tensor(resets, device=device),
                 edge_mask=None if edge_mask is None
                 else torch.tensor(np.asarray(edge_mask), device=device))


def port_topology(ref_topo, device="cpu"):
    """The reference ``Topology`` carried across to the port."""
    def arr(a):
        return None if a is None else np.asarray(a)

    return convert.topology_from_reference(
        ref_topo.kind, ref_topo.n, np.asarray(ref_topo.deg),
        adj=arr(ref_topo.adj), neighbor_idx=arr(ref_topo.neighbor_idx),
        neighbor_mask=arr(ref_topo.neighbor_mask), offsets=ref_topo.offsets,
        shifts=arr(ref_topo.shifts), device=device)


def reference_edge_mask(ref_channel, chan_state, ref_topo):
    """The dropout mask the reference's ``Channel.apply`` draws from
    ``chan_state.key`` this step (comm/channel.py: ``key, sub =
    split(key)``, then ``dropout_mask(sub, topo, p)``), or None without a
    dropout stage."""
    from repro.comm import channel as ref_cc
    stage = ref_channel.dropout_stage
    if stage is None:
        return None
    sub = jax.random.split(chan_state.key)[1]
    return np.asarray(ref_cc.dropout_mask(sub, ref_topo, stage.p))


def rounding_spread(ref_fn, params, key, samples=8, seed=0):
    """How far the reference's own f32 returns move when every parameter
    moves by one ulp: the standard deviation of ``ref_fn`` over ``samples``
    random ±1-ulp perturbations of ``params`` (M, D), per return.

    Episodes that pass near an unstable equilibrium amplify rounding: on
    such an episode the JAX f32 return and a float64 run of the same
    dynamics were measured to differ by up to 2e-3 relative, while most
    episodes agree to 1e-6. Any two f32 implementations differ there by
    about this spread, so the parity tolerance is scaled by it."""
    rng = np.random.default_rng(seed)
    params = np.asarray(params, np.float32)
    fn = _jitted(ref_fn)
    outs = []
    for _ in range(samples):
        toward = np.where(rng.random(params.shape) < 0.5, np.inf, -np.inf)
        bumped = np.nextafter(params, toward.astype(np.float32))
        outs.append(np.asarray(fn(bumped, key)))
    return np.std(np.stack(outs), axis=0)


def assert_returns_close(got, want, spread, rtol=1e-5):
    """|port − reference| ≤ rtol·|reference| + 6·(one-ulp rounding spread)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = rtol * np.abs(want) + 6.0 * np.asarray(spread, np.float64)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (
        f"returns differ beyond rtol {rtol} + 6·spread at {np.nonzero(bad)[0]}:"
        f" port {got[bad]}, reference {want[bad]}, spread {spread[bad]}")


def one_level_slack(ch, adj, payload, best, broadcast, scale):
    """The θ′ tolerance a quantization code that may differ by one level
    adds (tests/test_torch_netes.py, the channel test's docstring): (N, D),
    0 without a quantize stage. ``adj`` is the dense adjacency of the
    step's graph, ``payload`` the messages θ + σε (N, D), ``best`` the
    broadcast candidate, ``scale`` α/(Nσ²)."""
    q = ch.quantize_stage
    if q is None:
        return 0.0
    levels = 2.0 ** (q.bits - 1) - 1

    def near(v):
        """(at a boundary, one level) per element of the messages v."""
        v = np.asarray(v, np.float64)
        if q.bits == 1:      # sign(x): the boundary is 0, a level is mean|x|
            step = np.abs(v).mean(axis=-1, keepdims=True)
            return np.abs(v) <= 2.0 ** -20 * np.abs(v).max(
                axis=-1, keepdims=True), step
        step = np.abs(v).max(axis=-1, keepdims=True) / levels
        t = np.abs(v) / np.where(step > 0, step, 1.0)
        return np.abs(t - np.floor(t) - 0.5) <= levels * 2.0 ** -20, step

    if broadcast:
        at, step = near(best)
        return np.broadcast_to(at * step, payload.shape)
    at, step = near(payload)
    return scale * (np.abs(adj) @ (at * step))
