"""The port's environments, policy and rollouts against ``repro.envs``,
from the reference's own reset states.

Tolerance of episode returns: rtol 1e-5 plus six times the reference's own
one-ulp rounding spread (``_torch_ref.rounding_spread``). Both sides step
the same f32 dynamics and differ only in how sin/cos/tanh round and in
summation order inside the policy's 64-wide dot products. Most pendulum
episodes (200 steps) agree with a float64 run of the same dynamics to
about 1e-6 relative; an episode that passes near the upright equilibrium
amplifies rounding, and there the JAX f32 return itself was measured 2e-3
away from float64. The spread term covers exactly those episodes.

The rollouts run on the CPU and, in the cases marked ``card`` (skipped
without a CUDA card), on the card, where the pendulum's episodes run in
the rollout kernel (``envs.rollout.uses_kernel``); the reference runs on
the CPU either way (``JAX_PLATFORMS=cpu``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as ref_envs
from _torch_ref import (assert_returns_close, eval_reset_states,
                        reset_states, rounding_spread)
from repro.envs import rollout as ref_rollout
from repro_torch import envs
from repro_torch.envs import rollout

TASKS = ["pendulum", "cartpole_swingup", "acrobot"]
M = 8
# each task's rollout on the CPU (the loop) and, where a CUDA card is
# visible, on the card (for the pendulum the kernel,
# ``envs.rollout.uses_kernel``); the CPU cases keep their ids
TASK_DEVICES = ([pytest.param(t, "cpu", id=t) for t in TASKS]
                + [pytest.param(t, "cuda", id=f"{t}-cuda", marks=pytest.mark.card)
                   for t in TASKS])


def _on(device):
    """The torch device ``device`` names; skips the card's case where no
    CUDA card is visible (decided when the test runs)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(device)


def _params(ref_policy, seed):
    """M reference-initialized parameter vectors, spread like a NetES
    population (θ⁽⁰⁾ + σ ε with σ = 0.1)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), M)
    thetas = np.asarray(jax.vmap(ref_policy.init)(keys))
    noise = np.random.default_rng(seed).normal(size=thetas.shape)
    return np.ascontiguousarray((thetas + 0.1 * noise).astype(np.float32))


@pytest.mark.parametrize("task,device", TASK_DEVICES)
def test_episode_returns_match(task, device):
    device = _on(device)
    ref_fn, dim, _, ref_env, ref_policy = ref_envs.resolve_task(task)
    reward_fn, port_dim, _, env, _ = envs.resolve_task(task)
    assert port_dim == dim
    params = _params(ref_policy, seed=len(task))
    k_eval = jax.random.PRNGKey(11)
    want = np.asarray(jax.jit(ref_fn)(jnp.asarray(params), k_eval))
    resets = reset_states(ref_env, k_eval, M)
    got = reward_fn(torch.as_tensor(params, device=device),
                    torch.as_tensor(resets, device=device))
    assert got.shape == (M,) and got.dtype == torch.float32
    assert got.device.type == device.type
    assert_returns_close(got.cpu().numpy(), want,
                         rounding_spread(ref_fn, params, k_eval))


def test_episodes_per_eval_mean():
    _episodes_per_eval_mean(torch.device("cpu"))


@pytest.mark.card
def test_episodes_per_eval_mean_on_card():
    _episodes_per_eval_mean(_on("cuda"))


def _episodes_per_eval_mean(device):
    _, _, _, ref_env, ref_policy = ref_envs.resolve_task("pendulum")
    params = _params(ref_policy, seed=3)[:4]
    k_eval = jax.random.PRNGKey(5)
    ref_fn = ref_rollout.make_env_reward_fn(ref_env, ref_policy,
                                            episodes_per_eval=3)
    want = np.asarray(jax.jit(ref_fn)(jnp.asarray(params), k_eval))
    env = envs.Pendulum()
    policy = envs.MLPPolicy(obs_dim=env.obs_dim, act_dim=env.act_dim)
    fn = rollout.make_env_reward_fn(env, policy, episodes_per_eval=3)
    resets = reset_states(ref_env, k_eval, 4, episodes_per_eval=3)
    got = fn(torch.as_tensor(params, device=device),
             torch.as_tensor(resets, device=device))
    assert_returns_close(got.cpu().numpy(), want,
                         rounding_spread(ref_fn, params, k_eval))


def test_evaluate_best_matches():
    _evaluate_best_matches(torch.device("cpu"))


@pytest.mark.card
def test_evaluate_best_matches_on_card():
    _evaluate_best_matches(_on("cuda"))


def _evaluate_best_matches(device):
    _, _, _, ref_env, ref_policy = ref_envs.resolve_task("pendulum")
    _, _, _, env, policy = envs.resolve_task("pendulum")
    theta = _params(ref_policy, seed=9)[0]
    key = jax.random.PRNGKey(21)
    def ref_eval(th, k):
        return ref_rollout.evaluate_best(ref_env, ref_policy, th[0], k,
                                         6)[None]

    want = np.asarray(ref_eval(jnp.asarray(theta[None]), key))
    got = rollout.evaluate_best(env, policy,
                                torch.as_tensor(theta, device=device),
                                torch.as_tensor(eval_reset_states(
                                    ref_env, key, 6), device=device))
    assert got.dim() == 0
    assert_returns_close(got.reshape(1).cpu().numpy(), want,
                         rounding_spread(ref_eval, theta[None], key))


@pytest.mark.parametrize("task", TASKS)
def test_policy_apply_matches_per_vector(task):
    """Batched apply (bmm over M) equals the reference's apply of each
    vector alone. rtol 1e-5 / atol 1e-6: 64-term f32 dot products summed
    in another order, through tanh."""
    _, _, _, ref_env, ref_policy = ref_envs.resolve_task(task)
    _, _, _, _, policy = envs.resolve_task(task)
    assert policy.layer_shapes == ref_policy.layer_shapes
    params = _params(ref_policy, seed=1)
    obs = np.random.default_rng(2).normal(
        size=(M, ref_env.obs_dim)).astype(np.float32)
    got = policy.apply(torch.as_tensor(params), torch.as_tensor(obs))
    for m in range(M):
        want = ref_policy.apply(jnp.asarray(params[m]), jnp.asarray(obs[m]))
        np.testing.assert_allclose(got[m].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    # the flat layout: W row-major (din, dout), then b, layer by layer
    for got_p, want_p in zip(policy.unflatten(torch.as_tensor(params[:1])),
                             ref_policy.unflatten(jnp.asarray(params[0])),
                             strict=True):
        np.testing.assert_array_equal(got_p[0].numpy(), np.asarray(want_p))


@pytest.mark.parametrize("name", sorted(ref_envs.LANDSCAPES))
def test_landscapes_match(name):
    """Five landscapes, unshifted and shifted; the reward noise comes in as
    the reference's own N(0, 1) draw. rtol 1e-5 over 64-term f32 sums."""
    x = np.random.default_rng(4).normal(size=(6, 64)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    noise = np.array(jax.random.normal(key, (6,)))
    for spec, std in ((name, 0.0), (f"{name}@1.5", 0.3)):
        want = ref_envs.make_landscape_reward_fn(spec, std)(jnp.asarray(x),
                                                            key)
        fn = envs.make_landscape_reward_fn(spec, std)
        got = fn(torch.as_tensor(x), torch.as_tensor(noise) if std else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_port_draws_have_reference_shapes():
    gen = torch.Generator().manual_seed(0)
    for task in TASKS:
        reward_fn, dim, init_fn, env, _ = envs.resolve_task(task)
        assert reward_fn.draw(gen, 5).shape == (5, 1, env.state_dim)
        assert init_fn(gen, 3).shape == (3, dim)
    fn, dim, init_fn, _, _ = envs.resolve_task("landscape:sphere")
    assert fn.draw(gen, 5) is None and init_fn(gen, 2).shape == (2, dim)
