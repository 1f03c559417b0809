"""The pendulum rollout kernel (``kernels/pendulum_rollout``,
``csrc/pendulum_rollout.cu``) and the choice ``envs.rollout.episode_return``
makes between it and its plain version, the Python loop
``envs.rollout.loop_return``.

The choice, the wrapper's refusals and its shape-only path run here. The
kernel runs only on a CUDA card: the tests marked ``card`` skip without
one. This file imports no JAX, so on a machine with the card it runs
without this directory's conftest (which imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_pendulum_rollout.py

Tolerance of the kernel against the loop on the same card: rtol 1e-5 plus
six times the loop's own one-ulp rounding spread, as in
``test_torch_envs.py``. The two differ only in the order in which the
policy's dot products are summed; an episode that passes near the upright
equilibrium amplifies that rounding, and the spread term covers those
episodes. Where the dot products are exact (every weight 0, biases not),
the two must agree bit for bit: that holds the environment's arithmetic,
its floor-mod and the return's summation order to the loop's. The kernel
against the JAX reference: the card cases of ``test_torch_envs.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import envs
from repro_torch.envs import rollout
from repro_torch.kernels import pendulum_rollout as pr
from repro_torch.obs import cuda_watch

M = 4096
POLICY = envs.MLPPolicy(obs_dim=3, act_dim=1)
# every field moved off its default: each must enter the kernel
OTHER_PENDULUM = envs.Pendulum(max_speed=6.0, max_torque=1.5, dt=0.04,
                               g=9.81, m=1.2, length=0.9, episode_len=150)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible; decided when the
    test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# --------------------------------------------------------------------------
# the choice, on the CPU
# --------------------------------------------------------------------------

CHOICES = [
    ("pendulum", {}, torch.float32, "cuda", True),
    ("pendulum", {}, torch.float32, "cpu", False),
    ("pendulum", {}, torch.float64, "cuda", False),
    ("cartpole_swingup", {}, torch.float32, "cuda", False),
    ("acrobot", {}, torch.float32, "cuda", False),
    ("pendulum", {"hidden": (32, 32)}, torch.float32, "cuda", False),
    ("pendulum", {"discrete": True}, torch.float32, "cuda", False),
]


@pytest.mark.parametrize("task,policy_kw,dtype,device,kernel", CHOICES,
                         ids=["pendulum-cuda", "pendulum-cpu",
                              "pendulum-f64", "cartpole", "acrobot",
                              "hidden32", "discrete"])
def test_kernel_choice(task, policy_kw, dtype, device, kernel):
    env = envs.ENVS[task]()
    policy = envs.MLPPolicy(obs_dim=env.obs_dim, act_dim=env.act_dim,
                            **policy_kw)
    assert rollout.uses_kernel(env, policy, dtype,
                               torch.device(device)) is kernel


def test_pendulum_subclass_keeps_the_loop():
    """Another class's dynamics are not the kernel's, whatever it
    inherits."""
    class Heavier(envs.Pendulum):
        pass

    assert not rollout.uses_kernel(Heavier(), POLICY, torch.float32,
                                   torch.device("cuda"))


@pytest.mark.parametrize("per_theta", [1, 3])
def test_cpu_runs_the_loop(monkeypatch, per_theta):
    """On CPU tensors ``episode_return`` never reaches the wrapper, and
    row i runs parameters ``i // per_theta``."""
    def refuse(*a, **kw):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(rollout, "pendulum_rollout", refuse)
    env = envs.Pendulum(episode_len=20)
    g = torch.Generator().manual_seed(per_theta)
    thetas = POLICY.init(g, 4) + 0.1 * torch.randn(4, POLICY.num_params,
                                                   generator=g)
    states = env.reset(g, 4 * per_theta)
    got = rollout.episode_return(env, POLICY, thetas, states, per_theta)
    want = rollout.loop_return(
        env, POLICY, thetas.repeat_interleave(per_theta, dim=0), states)
    assert torch.equal(got, want)


def _operands(m, device="cpu", dtype=torch.float32):
    return (torch.zeros(m, pr.DIM, dtype=dtype, device=device),
            torch.zeros(m, pr.STATE_DIM, dtype=dtype, device=device))


@pytest.mark.parametrize("case", ["float64", "thetas-strided",
                                  "states-strided", "states-rows", "cpu"])
def test_wrapper_refuses_on_the_cpu(case):
    """What the wrapper does not take raises before any launch, on the
    CPU too: it never falls back to the loop."""
    thetas, states = _operands(8)
    if case == "float64":
        thetas, states = _operands(8, dtype=torch.float64)
    elif case == "thetas-strided":
        thetas = torch.zeros(pr.DIM, 8).t()
    elif case == "states-strided":
        states = torch.zeros(pr.STATE_DIM, 8).t()
    elif case == "states-rows":
        states = torch.zeros(9, pr.STATE_DIM)
    before = pr.KERNEL.launches
    with pytest.raises((TypeError, ValueError)):
        pr.pendulum_rollout(envs.Pendulum(), thetas, states)
    assert pr.KERNEL.launches == before


def test_shape_only_reports_costs():
    """On meta tensors the wrapper returns the kernel's shape and reports
    its flops (8704 an episode step) and bytes (θ rows and states read
    once, returns written once), launching nothing."""
    thetas, states = _operands(5, device="meta")
    states = torch.zeros(15, pr.STATE_DIM, device="meta")
    seen = []
    with cuda_watch.on_kernel_report(lambda *r: seen.append(r)):
        out = pr.pendulum_rollout(envs.Pendulum(), thetas, states, 3)
    assert out.shape == (15,) and out.device.type == "meta"
    assert seen == [("pendulum_rollout", 15 * 200 * 8704.0,
                     4.0 * (5 * 4481 + 15 * 2 + 15))]
    assert pr.FLOPS_PER_STEP == 8704


# --------------------------------------------------------------------------
# the kernel, on the card
# --------------------------------------------------------------------------

def _netes_thetas(m, device, seed):
    """θ⁽⁰⁾ + 0.1 ε, as a NetES population's candidates."""
    g = torch.Generator(device=device).manual_seed(seed)
    return (POLICY.init(g, m)
            + 0.1 * torch.randn(m, POLICY.num_params, generator=g,
                                device=device))


def _resets(env, m, device, seed):
    return env.reset(torch.Generator(device=device).manual_seed(seed), m)


def _rounding_spread(env, thetas, states, samples=8, seed=0):
    """The standard deviation of the loop's returns over ``samples``
    random ±1-ulp moves of every parameter."""
    g = torch.Generator(device=thetas.device).manual_seed(seed)
    outs = []
    for _ in range(samples):
        up = torch.rand(thetas.shape, generator=g, device=thetas.device)
        toward = torch.where(up < 0.5, torch.inf, -torch.inf)
        outs.append(rollout.loop_return(
            env, POLICY, torch.nextafter(thetas, toward), states))
    return torch.stack(outs).std(dim=0, correction=0)


def _assert_close(got, want, spread, rtol=1e-5):
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    tol = rtol * np.abs(want) + 6.0 * spread.double().cpu().numpy()
    bad = np.abs(got - want) > tol
    assert not bad.any(), (
        f"{bad.sum()} returns beyond rtol {rtol} + 6·spread at "
        f"{np.nonzero(bad)[0][:8]}: kernel {got[bad][:8]}, loop "
        f"{want[bad][:8]}")


def _q90(got, want) -> float:
    return float(torch.quantile(
        ((got.double() - want) / want.abs()).abs(), 0.9))


@pytest.mark.card
def test_kernel_matches_loop(card):
    """(a) M = 4096 NetES-like candidates: the kernel against the loop on
    the same card, and both against the loop in float64."""
    env = envs.Pendulum()
    thetas = _netes_thetas(M, card, seed=1)
    states = _resets(env, M, card, seed=2)
    got = rollout.episode_return(env, POLICY, thetas, states)
    assert got.shape == (M,) and got.dtype == torch.float32
    want = rollout.loop_return(env, POLICY, thetas, states)
    spread = _rounding_spread(env, thetas, states)
    _assert_close(got, want, spread)
    exact = rollout.loop_return(env, POLICY, thetas.double(),
                                states.double())
    # the benchmark's limit on the same number, and no worse than the
    # loop's own distance from float64 by more than a factor of 2
    assert _q90(got, exact) <= min(2e-5, 2 * _q90(want, exact) + 1e-7)


@pytest.mark.card
@pytest.mark.parametrize("env", [envs.Pendulum(), OTHER_PENDULUM],
                         ids=["default", "other-fields"])
def test_exact_products_match_bit_for_bit(card, env):
    """(b) W1 = W2 = W3 = 0 and biases not: every dot product is exact,
    so the kernel's returns equal the loop's bit for bit."""
    thetas = _netes_thetas(M, card, seed=3)
    for (a, b), shape in zip(_leaves(), POLICY.layer_shapes, strict=True):
        if len(shape) == 2:
            thetas[:, a:b] = 0.0
    assert (thetas[:, -1] != 0).all()
    states = _resets(env, M, card, seed=4)
    got = rollout.episode_return(env, POLICY, thetas, states)
    want = rollout.loop_return(env, POLICY, thetas, states)
    assert torch.equal(got, want), (
        f"{int((got != want).sum())} of {M} returns differ, largest "
        f"{float((got - want).abs().max())}")


def _leaves():
    out, at = [], 0
    for shape in POLICY.layer_shapes:
        size = int(np.prod(shape))
        out.append((at, at + size))
        at += size
    return out


@pytest.mark.card
def test_episodes_per_eval_and_evaluate_best(card):
    """(c) Three episodes an evaluation index row m // 3 in the kernel:
    equal bit for bit to the kernel on the repeated rows, and to the
    loop's answers within the tolerance; ``evaluate_best`` the same."""
    env = envs.Pendulum()
    m = 512
    thetas = _netes_thetas(m, card, seed=5)
    fn = rollout.make_env_reward_fn(env, POLICY, episodes_per_eval=3)
    evals = fn.draw(torch.Generator(device=card).manual_seed(6), m)
    got = fn(thetas, evals)
    repeated = thetas.repeat_interleave(3, dim=0)
    states = evals.reshape(3 * m, -1)
    per_episode = rollout.episode_return(env, POLICY, repeated, states)
    assert torch.equal(got, per_episode.reshape(m, 3).mean(dim=1))
    loop = rollout.loop_return(env, POLICY, repeated, states)
    spread = _rounding_spread(env, repeated, states)
    _assert_close(per_episode, loop, spread)
    _assert_close(got, loop.reshape(m, 3).mean(dim=1),
                  spread.reshape(m, 3).mean(dim=1))

    theta, resets = thetas[7], _resets(env, 32, card, seed=7)
    best = rollout.evaluate_best(env, POLICY, theta, resets)
    expanded = theta[None, :].expand(32, -1).contiguous()
    assert best.dim() == 0
    assert torch.equal(best, rollout.episode_return(
        env, POLICY, expanded, resets).mean())
    loop_best = rollout.loop_return(env, POLICY, expanded, resets)
    spread = _rounding_spread(env, expanded, resets)
    _assert_close(best.reshape(1), loop_best.mean().reshape(1),
                  spread.mean().reshape(1))


@pytest.mark.card
def test_one_launch_a_call(card):
    """(d) One reward call of 2N episodes is one launch."""
    env = envs.Pendulum()
    fn = rollout.make_env_reward_fn(env, POLICY)
    thetas = _netes_thetas(64, card, seed=8)
    evals = fn.draw(torch.Generator(device=card).manual_seed(9), 64)
    fn(thetas, evals)
    before = pr.KERNEL.launches
    out = fn(thetas, evals)
    torch.cuda.synchronize(card)
    assert pr.KERNEL.launches == before + 1
    assert out.shape == (64,) and torch.isfinite(out).all()


@pytest.mark.card
@pytest.mark.parametrize("case", ["float64", "thetas-strided",
                                  "states-strided", "states-on-cpu"])
def test_wrapper_refuses_on_the_card(card, case):
    """(e) A float64, a non-contiguous or a misplaced operand raises, and
    nothing is launched: the wrapper does not fall back."""
    thetas, states = _operands(8, device=card)
    if case == "float64":
        thetas, states = _operands(8, device=card, dtype=torch.float64)
    elif case == "thetas-strided":
        thetas = torch.zeros(pr.DIM, 8, device=card).t()
    elif case == "states-strided":
        states = torch.zeros(pr.STATE_DIM, 8, device=card).t()
    else:
        states = states.cpu()
    before = pr.KERNEL.launches
    with pytest.raises((TypeError, ValueError)):
        pr.pendulum_rollout(envs.Pendulum(), thetas, states)
    assert pr.KERNEL.launches == before

